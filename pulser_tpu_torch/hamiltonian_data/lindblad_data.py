"""Definition of a set of Lindblad collapse operators.

Parity with reference
``pulser-core/pulser/_hamiltonian_data/lindblad_data.py``.
"""

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class LindbladData:
    """Some data about the Lindblad operators used by the simulation."""

    op_matrix_names: list[str]
    local_collapse_ops: list[
        tuple[int | float | complex, str | np.ndarray]
    ]
    depolarizing_pauli_2ds: dict[str, list[tuple[int | complex, str]]]
