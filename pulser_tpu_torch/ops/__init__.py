"""Structured Hamiltonian application and solvers, in PyTorch.

Exports the names of ``pulser_tpu.ops`` except the real-pair helpers
(``c2r``, ``r2c``, ``apply_axis_r``): the port computes in native complex.
Importing this package loads no CUDA library; the kernels are built and
loaded on their first launch (:mod:`.kernels`).
"""

from pulser_tpu_torch.ops.apply import (
    apply_axis_c,
    apply_col_c,
    apply_flip_flop_r,
    apply_row_c,
    build_drive_matrices,
    hamiltonian_matvec,
    neg_i,
)
from pulser_tpu_torch.ops.solver import (
    EvolutionPlan,
    build_plan,
    mesolve_rk4,
    sesolve_rk4,
)

__all__ = [
    "apply_axis_c",
    "apply_col_c",
    "apply_flip_flop_r",
    "apply_row_c",
    "build_drive_matrices",
    "hamiltonian_matvec",
    "neg_i",
    "EvolutionPlan",
    "build_plan",
    "mesolve_rk4",
    "sesolve_rk4",
]
