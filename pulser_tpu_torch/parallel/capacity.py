"""Device-memory capacity model for the statevector/density-matrix solvers.

Port of ``pulser_tpu/parallel/capacity.py`` for one CUDA device. The
sharded regimes of the JAX package (state and ρ rows split over a mesh)
are not ported, so the ceiling is one device's memory.

:func:`check_capacity` turns the model into an upfront contract: the
emulator consults it before each master-equation solve, so an
over-capacity request raises :class:`CapacityError` with the modeled
footprint instead of running out of memory mid-solve.

Memory model: the torch RK4 loops keep the state as native complex
tensors and hold :data:`LIVE_STATE_BUFFERS` state-sized buffers at peak,
plus one ``(n_eval, dim)`` output block and the ``(dim,)`` interaction
diagonal. A density matrix over ``n`` qudits counts as a
``d^(2n)``-amplitude state.
"""

from __future__ import annotations

import math

from pulser_tpu_torch.exceptions.base import PulserError


class CapacityError(PulserError, MemoryError):
    """A requested solve exceeds the modeled device memory."""


#: Live state-sized complex buffers the master-equation loop
#: (``ops.solver._mesolve_scan``) holds at peak: ρ, the stage input, the
#: derivative, the accumulator, two phase factors for each of three
#: stage points, the rotated state, the group products and headroom.
LIVE_STATE_BUFFERS = 16

#: Fraction of the device memory a solve may plan for (the rest covers
#: the staged coefficients, the allocator's slack and the runtime).
MEMORY_BUDGET_FRACTION = 0.9

#: The device memory of one H100 SXM (80 GB HBM3), the port's reference
#: card, assumed by :func:`capacity_report` where none is measured.
H100_MEMORY_BYTES = 80 * 1024**3


def solve_bytes(d: int, n: int, n_eval: int = 1, itemsize: int = 4) -> int:
    """Peak device footprint of an ``n``-qudit, dim-``d`` solve.

    Args:
        d: Qudit dimension (2 = qubits, 3 = qutrits, 4 = leakage).
        n: Qudit count.
        n_eval: Evaluation-time states kept on the device.
        itemsize: Real dtype size (4 = float32 ≙ complex64).
    """
    dim = d**n
    state = 2 * dim * itemsize
    return (
        LIVE_STATE_BUFFERS * state
        + n_eval * state
        + dim * itemsize  # interaction diagonal
    )


def single_chip_ceiling(
    d: int,
    memory_bytes: int = H100_MEMORY_BYTES,
    n_eval: int = 1,
    itemsize: int = 4,
) -> int:
    """Largest ``n`` whose statevector solve fits one device's memory."""
    budget = memory_bytes * MEMORY_BUDGET_FRACTION
    per_amp = (LIVE_STATE_BUFFERS + n_eval) * 2 * itemsize + itemsize
    n = int(math.floor(math.log(budget / per_amp, d)))
    while solve_bytes(d, n + 1, n_eval, itemsize) <= budget:
        n += 1
    while n > 0 and solve_bytes(d, n, n_eval, itemsize) > budget:
        n -= 1
    return n


def measured_memory_bytes(device: "object | None" = None) -> "int | None":
    """The total memory of the CUDA device (``torch.cuda.mem_get_info``),
    or None without one (the CPU)."""
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    _, total = torch.cuda.mem_get_info(device)
    return int(total)


def capacity_report(device: "object | None" = None) -> dict:
    """Ceilings per basis dimension for the device (or an H100's
    nominal 80 GB where none is measured)."""
    mem = measured_memory_bytes(device) or H100_MEMORY_BYTES
    return {
        "memory_bytes": int(mem),
        "ceilings": {d: single_chip_ceiling(d, mem) for d in (2, 3, 4)},
    }


def check_capacity(
    d: int,
    n: int,
    *,
    n_eval: int = 1,
    itemsize: int = 4,
    density_matrix: bool = False,
    what: str = "solve",
    device: "object | None" = None,
) -> None:
    """Raise :class:`CapacityError` if a solve exceeds the memory budget.

    Skips silently where no device memory is measured (the CPU): there
    the model's constants do not apply.
    """
    mem = measured_memory_bytes(device)
    if mem is None:
        return
    eff_n = 2 * n if density_matrix else n
    need = solve_bytes(d, eff_n, n_eval=n_eval, itemsize=itemsize)
    budget = mem * MEMORY_BUDGET_FRACTION
    if need <= budget:
        return
    kind = "density-matrix" if density_matrix else "statevector"
    ceiling = single_chip_ceiling(d, mem, n_eval, itemsize)
    if density_matrix:
        ceiling //= 2
    raise CapacityError(
        f"The requested {what} needs ~{_human_bytes(need)} of device memory"
        f" for an n={n}, d={d} {kind} ({n_eval} evaluation state(s) kept on"
        f" the device), but the modeled budget is {_human_bytes(budget)}"
        f" ({MEMORY_BUDGET_FRACTION:.0%} of {_human_bytes(mem)}). The"
        f" modeled ceiling at this configuration is n={ceiling}. Reduce the"
        " atom count or the number of evaluation times (sharding the state"
        " over several devices is not ported yet)."
    )


def _human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB"):
        if n < 1024:
            return f"{n:.0f} {unit}"
        n /= 1024
    return f"{n:.1f} GiB"
