"""Device-memory capacity model for the statevector/density-matrix solvers.

Port of ``pulser_tpu/parallel/capacity.py``. Every basis has a sharded
path (:mod:`.state_sharding`: ``d=2`` states split on the qubit bits,
``d=3``/``d=4`` on the flat ``4^n`` index, density matrices on rows), so
the model has two regimes against the same memory accounting:

- **below the sharding threshold** (``state_shard_min_qubits()`` /
  ``rho_shard_min_qubits()``) the solve runs on one device and the
  ceiling is one card's memory;
- **at or above it** the state divides evenly across the mesh, so the
  ceiling is (per-card memory) × (mesh ranks).

:func:`check_capacity` turns the model into an upfront contract: the
emulator consults it before each master-equation solve, so an
over-capacity request raises :class:`CapacityError` with the modeled
footprint instead of running out of memory mid-solve.

Memory model: the torch RK4 loops keep the state as native complex
tensors and hold :data:`STATEVECTOR_LIVE_BUFFERS` (a statevector) or
:data:`LIVE_STATE_BUFFERS` (a density matrix) state-sized buffers at
peak, plus one ``(n_eval, dim)`` output block, the ``(dim,)``
interaction diagonal and the inputs they stage for a chunk of steps
(:data:`STAGE_CHUNK_BYTES`, twice over while the chunk is built). A
density matrix over ``n`` qudits counts as a ``d^(2n)``-amplitude state.
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

#: Live state-sized complex buffers the statevector loop
#: (``ops.solver.sesolve_rk4``'s torch loop, the route past 17 qubits)
#: holds at peak beside its evaluation states and the diagonal. Measured
#: on an H100 80GB HBM3 at 700 W (``tools/scale_ladder_torch.py``, two
#: evaluation states in complex64): 116.0 bytes per amplitude at 25, 26
#: and 29 qubits, 12 buffers; a rank of the state-sharded loop
#: (``parallel.state_sharding``, its exchange buffers included) held
#: 128.4 bytes per amplitude of its share, 13.5 buffers. Fourteen covers
#: both.
STATEVECTOR_LIVE_BUFFERS = 14

#: Budget of the drive matrices, rotors and diagonal factors the torch
#: loops stage for a chunk of steps at once (the steps of a segment go in
#: chunks, at least one step each: past about 22 qubits a step's rotors
#: alone exceed it, and :data:`STATEVECTOR_LIVE_BUFFERS` counts them).
#: Building a chunk holds its phases, their cosines and sines beside the
#: rotors, up to twice the budget: 478 782 976 B at 20 qubits on an H100
#: 80GB HBM3 at 700 W, where the state is 8 MiB.
STAGE_CHUNK_BYTES = 1 << 28

#: Fraction of the device memory a solve may plan for (the rest covers
#: the staged coefficients, the allocator's slack and the runtime).
MEMORY_BUDGET_FRACTION = 0.9

#: The device memory of one H100 SXM (80 GB HBM3), the port's reference
#: card, assumed by :func:`capacity_report` where none is measured.
H100_MEMORY_BYTES = 80 * 1024**3


def solve_bytes(
    d: int,
    n: int,
    n_eval: int = 1,
    itemsize: int = 4,
    density_matrix: bool = False,
) -> int:
    """Peak device footprint of an ``n``-qudit, dim-``d`` solve.

    Args:
        d: Qudit dimension (2 = qubits, 3 = qutrits, 4 = leakage).
        n: Qudit count (of the state: a density matrix over ``m`` qudits
            passes ``n = 2m``).
        n_eval: Evaluation-time states kept on the device.
        itemsize: Real dtype size (4 = float32 ≙ complex64).
        density_matrix: Whether the master-equation loop holds the
            state (:data:`LIVE_STATE_BUFFERS`) rather than the
            statevector loop (:data:`STATEVECTOR_LIVE_BUFFERS`).
    """
    dim = d**n
    state = 2 * dim * itemsize
    live = LIVE_STATE_BUFFERS if density_matrix else STATEVECTOR_LIVE_BUFFERS
    return (
        live * state
        + n_eval * state
        + dim * itemsize  # interaction diagonal
        + 2 * STAGE_CHUNK_BYTES
    )


def single_chip_ceiling(
    d: int,
    memory_bytes: int = H100_MEMORY_BYTES,
    n_eval: int = 1,
    itemsize: int = 4,
) -> int:
    """Largest ``n`` whose statevector solve fits one device's memory."""
    budget = memory_bytes * MEMORY_BUDGET_FRACTION
    per_amp = (STATEVECTOR_LIVE_BUFFERS + n_eval) * 2 * itemsize + itemsize
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
    n_devices: int = 1,
    density_matrix: bool = False,
    what: str = "solve",
    device: "object | None" = None,
) -> None:
    """Raise :class:`CapacityError` if a solve exceeds the memory budget.

    A density matrix over ``n`` dim-``d`` qudits counts as a
    ``d^(2n)``-amplitude state. When the solve shards (``n_devices >
    1``, the ranks of its mesh) the state divides evenly, so the budget
    scales with the mesh. Skips silently where no device memory is
    measured (the CPU): there the model's constants do not apply.
    """
    mem = measured_memory_bytes(device)
    if mem is None:
        return
    eff_n = 2 * n if density_matrix else n
    need = solve_bytes(
        d, eff_n, n_eval=n_eval, itemsize=itemsize,
        density_matrix=density_matrix,
    )
    ranks = max(1, int(n_devices))
    budget = mem * MEMORY_BUDGET_FRACTION * ranks
    if need <= budget:
        return
    kind = "density-matrix" if density_matrix else "statevector"
    ceiling = single_chip_ceiling(d, mem * ranks, n_eval, itemsize)
    if density_matrix:
        ceiling //= 2
        while ceiling > 0 and solve_bytes(
            d, 2 * ceiling, n_eval, itemsize, density_matrix=True
        ) > budget:
            ceiling -= 1
    raise CapacityError(
        f"The requested {what} needs ~{_human_bytes(need)} of device memory"
        f" for an n={n}, d={d} {kind} ({n_eval} evaluation state(s) kept on"
        f" the device), but the modeled budget is {_human_bytes(budget)}"
        f" ({MEMORY_BUDGET_FRACTION:.0%} of {ranks} × {_human_bytes(mem)})."
        f" The modeled ceiling at this configuration is n={ceiling}. Reduce"
        " the atom count or the number of evaluation times, or run on more"
        " ranks (the state shards across cards; see"
        " pulser_tpu_torch.parallel)."
    )


def _human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB"):
        if n < 1024:
            return f"{n:.0f} {unit}"
        n /= 1024
    return f"{n:.1f} GiB"
