"""Aggregation of trajectory states into a density matrix.

Port of ``pulser_tpu/emulator/aggregators.py`` (behavioral parity with
reference ``pulser-simulation/pulser_simulation/aggregators.py:19``):
the ``ψψ†`` of every trajectory are summed on the device of the first
state, in complex128.
"""

from __future__ import annotations

from typing import Sequence

import torch

from pulser_tpu_torch.emulator.torch_state import WORK_DTYPE, TorchState


def density_matrix_aggregator(
    states: Sequence[TorchState],
) -> TorchState:
    """Averages pure trajectory states into a mixed density matrix."""
    if not states:
        raise ValueError("Cannot aggregate an empty list of states.")
    eigenstates = states[0].eigenstates
    device = states[0].torch_device
    total: torch.Tensor | None = None
    for st in states:
        if st.eigenstates != eigenstates:
            raise ValueError(
                "All states must share the same eigenstates to be"
                " aggregated."
            )
        x = st._work(device)
        dm = torch.outer(x, x.conj()) if st.isket else x
        total = dm if total is None else total + dm
    assert total is not None
    return TorchState(total / len(states), eigenstates=eigenstates)
