"""Definition of the basis used by the Sequence.

Parity with reference ``pulser-core/pulser/_hamiltonian_data/basis_data.py``.
"""

from dataclasses import dataclass
from typing import Literal

from pulser_tpu_torch.channels.base_channel import States


@dataclass(frozen=True)
class BasisData:
    """Some data about the basis used by the simulation."""

    dim: int
    basis_name: str
    interaction_type: Literal["XY", "ising"]
    eigenbasis: list[States]
