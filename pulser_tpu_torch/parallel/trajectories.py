"""Monte-Carlo trajectory parallelism over the ranks of a mesh.

Port of ``pulser_tpu/parallel/trajectories.py`` on ``torch.distributed``.
Trajectories are the data-parallel axis: the per-trajectory stage arrays
split their leading axis over the mesh's ``"traj"`` axis, each rank runs
the batched torch solve on its block, and the blocks come back gathered
into every rank's host memory (:func:`trajectory_sharded`); the evolution itself needs no
collective. :func:`run_trajectories_sharded` sums the per-rank
probability histograms with one ``all_reduce`` (the ``Results.aggregate``
semantics).
"""

from __future__ import annotations

import os
from typing import Any, Callable

import numpy as np
import torch

from pulser_tpu_torch.parallel import comm


def default_mesh(axis_name: str = "traj", min_devices: int = 2) -> Any:
    """A 1-D mesh over every rank of the world, or None.

    The emulator's default data-parallel layout: noise trajectories shard
    over every rank. None without a process group, with fewer than
    ``min_devices`` ranks, and when ``PULSER_TPU_DISABLE_SHARDING`` is set
    (the tests compare sharded and serial runs that way).
    """
    if os.environ.get("PULSER_TPU_DISABLE_SHARDING") or not comm.world_ready():
        return None
    import torch.distributed as dist

    world = dist.get_world_size()
    if world < min_devices:
        return None
    return comm.make_mesh((world,), (axis_name,))


def pad_to_multiple(
    arrays: tuple[Any, ...], multiple: int
) -> tuple[tuple[Any, ...], int]:
    """Pads each array's leading (trajectory) axis up to a multiple.

    Padding repeats the last entry; callers slice the outputs back to the
    true trajectory count. Takes numpy arrays or torch tensors. Returns
    the padded arrays and the pad amount.
    """
    n_traj = arrays[0].shape[0]
    pad = (-n_traj) % multiple
    if pad == 0:
        return arrays, 0

    def grow(a: Any) -> Any:
        if isinstance(a, torch.Tensor):
            return torch.cat([a, a[-1:].expand(pad, *a.shape[1:])])
        return np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])

    return tuple(grow(a) for a in arrays), pad


def trajectory_sharded(
    mesh: Any,
    local_fn: Callable[..., torch.Tensor],
    per_traj: tuple[torch.Tensor, ...],
    axis_name: str = "traj",
    shared: tuple[Any, ...] = (),
) -> torch.Tensor:
    """Runs a batched solve with its trajectory axis split over a mesh.

    Each tensor of ``per_traj`` splits its leading (trajectory) axis over
    the mesh's ``axis_name`` axis; ``local_fn`` (which may close over
    shared inputs: the initial state, the grid, the collapse algebra)
    runs on this rank's block, and the blocks are gathered in rank order
    into host memory (:func:`~.comm.gather_to_host`), so every rank
    returns the whole batch while its card holds only its block.

    Args:
        mesh: A mesh with an ``axis_name`` axis (or a 1-D mesh).
        local_fn: Takes ``len(per_traj)`` local blocks, returns a
            leading-axis-batched tensor (on the card or the host).
        per_traj: Per-trajectory tensors; their leading axes must divide
            evenly over the axis.
        shared: The inputs ``local_fn`` closes over, which every rank
            must share too (:func:`~.comm.check_same_inputs`).

    Returns:
        The batched result of every trajectory, on the host.
    """
    n_traj = per_traj[0].shape[0]
    n_dev = comm.axis_size(mesh, axis_name)
    assert n_traj % n_dev == 0, (
        f"trajectory count ({n_traj}) must divide evenly over the"
        f" '{axis_name}' mesh axis ({n_dev})"
    )
    comm.check_same_inputs(mesh, "trajectory solve", *per_traj, *shared)
    block = n_traj // n_dev
    rank = comm.axis_rank(mesh, axis_name)
    local = local_fn(*(x[rank * block : (rank + 1) * block] for x in per_traj))
    parts = comm.gather_to_host(local, comm.axis_group(mesh, axis_name))
    return parts.reshape(n_traj, *local.shape[1:])


def sesolve_ip_states_sharded(
    mesh: Any,
    psi0: torch.Tensor,
    amp: torch.Tensor,
    det_cum_mod: torch.Tensor,
    t_stage: torch.Tensor,
    dts: np.ndarray,
    eval_t: torch.Tensor,
    eval_cum_mod: torch.Tensor,
    diags: torch.Tensor,
    *,
    pairs: tuple[tuple[int, int, int], ...],
    d: int,
    n: int,
    axis_name: str = "traj",
) -> torch.Tensor:
    """Trajectory-sharded batched interaction-picture sesolve.

    The per-trajectory stage arrays (leading axis) split over the mesh's
    ``axis_name`` axis; each rank runs the batched torch IP scan
    (``ops.solver._sesolve_scan_ip``) on its block, with no collective in
    the loop; the states are gathered once at the end.

    Args:
        mesh: A 1-D mesh over ``axis_name``.
        psi0, t_stage, dts, eval_t: Shared inputs.
        amp, det_cum_mod, eval_cum_mod, diags: Per-trajectory inputs,
            leading axis divisible by the axis size.
        pairs, d, n: Static Hamiltonian structure.

    Returns:
        ``(n_traj, n_seg, dim)`` lab-frame states after each segment, on
        the host.
    """
    from pulser_tpu_torch.ops.solver import _sesolve_scan_ip

    def local_fn(a, cm, ec, dg):
        return _sesolve_scan_ip(
            psi0, a, cm, t_stage, dts, eval_t, ec, dg, pairs=pairs, d=d, n=n
        )

    return trajectory_sharded(
        mesh, local_fn, (amp, det_cum_mod, eval_cum_mod, diags), axis_name,
        shared=(psi0, t_stage, dts, eval_t, pairs),
    )


def _sesolve_scan_batched(
    psi0: torch.Tensor,
    amp_stages: torch.Tensor,
    det_stages: torch.Tensor,
    dts: np.ndarray,
    static_diag: torch.Tensor,
    pairs: tuple[tuple[int, int, int], ...],
    d: int,
    n: int,
) -> torch.Tensor:
    """Lab-frame RK4 of a trajectory batch on one shared step list,
    returning the final states.

    Args:
        psi0: ``(dim,)`` complex initial state.
        amp_stages: ``(B, n_steps, 3, n_bases, n)`` complex stage coeffs.
        det_stages: ``(B, n_steps, 3, n_bases, n)`` real stage coeffs.
        dts: ``(n_steps,)`` host step sizes (µs).
        static_diag: ``(dim,)`` interaction diagonal.
        pairs, d, n: Static structure.

    Returns:
        ``(B, dim)`` final states.
    """
    from pulser_tpu_torch.ops.apply import _hpsi

    def deriv(p: torch.Tensor, a: torch.Tensor, de: torch.Tensor):
        # _hpsi takes the batch axis on the state and the coefficients
        return -1j * _hpsi(p, static_diag, a, de, pairs, d, n)

    psi = psi0.expand(amp_stages.shape[0], -1)
    for s, h in enumerate(np.asarray(dts, dtype=float)):
        a, de = amp_stages[:, s], det_stages[:, s]
        k1 = deriv(psi, a[:, 0], de[:, 0])
        k2 = deriv(psi + 0.5 * h * k1, a[:, 1], de[:, 1])
        k3 = deriv(psi + 0.5 * h * k2, a[:, 1], de[:, 1])
        k4 = deriv(psi + h * k3, a[:, 2], de[:, 2])
        psi = psi + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    return psi


def run_trajectories_sharded(
    mesh: Any,
    psi0: np.ndarray,
    amp_stages: np.ndarray,
    det_stages: np.ndarray,
    dts: np.ndarray,
    static_diag: np.ndarray,
    pairs: tuple[tuple[int, int, int], ...],
    d: int,
    n: int,
    axis_name: str = "traj",
    device: Any = None,
) -> torch.Tensor:
    """Evolves a batch of noise trajectories sharded across a mesh.

    The trajectory batch (leading axis of the stage arrays) splits over
    the mesh's ``axis_name`` axis; each rank integrates its block and the
    final probability histograms are summed over the ranks with one
    ``all_reduce``.

    Args:
        mesh: A 1-D mesh over ``axis_name``.
        psi0: ``(dim,)`` shared complex initial state (host numpy).
        amp_stages: ``(n_traj, n_steps, 3, n_bases, n)`` complex.
        det_stages: ``(n_traj, n_steps, 3, n_bases, n)`` real.
        dts: ``(n_steps,)`` shared step sizes.
        static_diag: ``(dim,)`` shared interaction diagonal.
        pairs, d, n: Static Hamiltonian structure.
        device: The torch device of this rank (default: its card).

    Returns:
        ``(dim,)`` summed probability histogram over all trajectories, on
        every rank.
    """
    from pulser_tpu_torch.ops import solver as S

    n_traj = amp_stages.shape[0]
    n_dev = comm.axis_size(mesh, axis_name)
    assert n_traj % n_dev == 0, (
        f"trajectory count ({n_traj}) must divide evenly over the"
        f" '{axis_name}' mesh axis ({n_dev})"
    )
    comm.check_same_inputs(
        mesh, "trajectory histogram", psi0, amp_stages, det_stages, dts,
        static_diag, pairs,
    )
    dev = S._resolve_device(device)
    rdtype = np.asarray(det_stages).dtype
    cdtype = np.result_type(rdtype, np.complex64)
    block = n_traj // n_dev
    rank = comm.axis_rank(mesh, axis_name)
    take = slice(rank * block, (rank + 1) * block)

    def to_dev(host: Any, dt: Any) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(host, dtype=dt)).to(dev)

    finals = _sesolve_scan_batched(
        to_dev(psi0, cdtype),
        to_dev(np.asarray(amp_stages)[take], cdtype),
        to_dev(np.asarray(det_stages)[take], rdtype),
        np.asarray(dts),
        to_dev(np.asarray(static_diag).real, rdtype),
        tuple(tuple(p) for p in pairs),
        d,
        n,
    )
    local_hist = (finals.real.square() + finals.imag.square()).sum(0)
    return comm.all_reduce_sum(local_hist, comm.axis_group(mesh, axis_name))
