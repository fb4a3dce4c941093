"""2-D (trajectory × state) mesh: both parallel axes at once.

Port of ``pulser_tpu/parallel/mesh2d.py`` on ``torch.distributed``. Large
noisy runs need both parallel axes: noise trajectories are the
data-parallel axis (:mod:`.trajectories`), the ``2^N`` state the
model-parallel one (:mod:`.state_sharding`). The mesh gets two axes:

- ``traj``: each trajectory group holds whole copies of its
  trajectories' states; no communication;
- ``state``: within a group the ``2^N`` axis splits over the hypercube;
  drives on sharded qubits exchange XOR-partner blocks over the
  ``"state"`` sub-group only. The per-rank body is the 1-D state
  sharding's (:func:`state_sharding._make_ip_local_work`), run batched
  over the rank's trajectory block.

The ``traj`` axis has no collective in the loop; the states are gathered
over both axes once at the end, into host memory, and counts aggregate on
the host.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from pulser_tpu_torch.parallel import comm
from pulser_tpu_torch.parallel.state_sharding import (
    _check_qubit_pairs,
    _gather_blocks,
    _make_ip_local_work,
)

__all__ = ["default_2d_mesh", "sesolve_ip_2d_sharded"]


def default_2d_mesh(
    n: int,
    n_traj: int,
    traj_axis: str = "traj",
    state_axis: str = "state",
) -> Any:
    """A (traj, state) mesh over the world's ranks, or None.

    Policy: engage only when the state is big enough to need sharding
    (``state_shard_min_qubits``), there are at least two trajectories and
    at least 4 ranks (2×2). The state axis takes the power-of-two split
    that brings the local block back under the single-device threshold;
    the remaining ranks (largest power of two) go to trajectories.
    ``PULSER_TPU_TRAJ_STATE_MESH=TxS`` forces a ``T × S`` mesh.
    """
    from pulser_tpu_torch.parallel.state_sharding import state_shard_min_qubits

    if os.environ.get("PULSER_TPU_DISABLE_SHARDING") or not comm.world_ready():
        return None
    import torch.distributed as dist

    world = dist.get_world_size()
    forced = os.environ.get("PULSER_TPU_TRAJ_STATE_MESH")
    if forced:
        t_dev, s_dev = (int(x) for x in forced.lower().split("x"))
        if t_dev * s_dev > world:
            return None
        return comm.make_mesh((t_dev, s_dev), (traj_axis, state_axis))
    thresh = state_shard_min_qubits()
    if n < thresh or n_traj < 2 or world < 4:
        return None
    # Shard the state until the local block is below threshold, but never
    # past half the ranks (trajectories need an axis too)
    k_total = world.bit_length() - 1
    k_state = min(n - thresh + 1, k_total - 1)
    if k_state < 1:
        return None
    s_dev = 2**k_state
    t_dev = 2 ** (k_total - k_state)
    return comm.make_mesh((t_dev, s_dev), (traj_axis, state_axis))


def sesolve_ip_2d_sharded(
    psi0: np.ndarray,
    plans: Any,
    static_diags: np.ndarray,
    pairs: tuple[tuple[int, int, int], ...],
    n: int,
    mesh: Any,
    dtype: Any = None,
    traj_axis: str = "traj",
    state_axis: str = "state",
    device: Any = None,
) -> np.ndarray:
    """Batched IP sesolve on a (trajectory × state) mesh.

    Numerically the batched torch IP scan of
    :func:`pulser_tpu_torch.ops.solver.sesolve_rk4_batched` (same RK4
    stages, same segmented plan); only the data placement differs:
    trajectories split over ``traj_axis``, each trajectory's ``2^n``
    state over ``state_axis``.

    Args:
        psi0: ``(2**n,)`` shared complex initial state.
        plans: A :class:`~pulser_tpu_torch.ops.solver.BatchedPlan`.
        static_diags: ``(B, 2**n)`` per-trajectory interaction diagonals.
        pairs, n: Static structure (qubits only, ``d = 2``).
        mesh: 2-D mesh with ``traj_axis`` and ``state_axis``; the state
            axis must be a power of two below ``2**n`` and the trajectory
            count must divide over the traj axis (callers pad, see
            :func:`.trajectories.pad_to_multiple`).
        dtype: Complex dtype of the evolution.
        device: The torch device of this rank (default: its card).

    Returns:
        ``(B, n_eval, 2**n)`` complex states, on every rank.
    """
    from pulser_tpu_torch.ops import solver as S

    s_dev = comm.axis_size(mesh, state_axis)
    k = s_dev.bit_length() - 1
    if 2**k != s_dev:
        raise ValueError(f"state axis must be a power of two, got {s_dev}")
    if k >= n:
        raise ValueError(f"cannot shard {n} qubits over {s_dev} devices")
    _check_qubit_pairs(pairs)
    cdtype = S._complex_dtype(dtype or np.asarray(psi0).dtype)
    rdtype = np.zeros((), dtype=cdtype).real.dtype
    dev = S._resolve_device(device)
    two_pi = 2 * np.pi
    base = plans.plan
    amp_np = plans.seg_stage_b("amp")  # (B, n_seg, L, 3, nb, n)
    n_traj = amp_np.shape[0]
    t_dev = comm.axis_size(mesh, traj_axis)
    if n_traj % t_dev:
        raise ValueError(
            f"trajectory count ({n_traj}) must divide over the"
            f" '{traj_axis}' axis ({t_dev})"
        )
    n_seg = base.seg_dts.shape[0]
    det_cum = plans.seg_stage_b("det_cum")
    out = None
    if comm.in_mesh(mesh):
        comm.check_same_inputs(
            mesh, "trajectory × state solve", psi0, static_diags, pairs,
            amp_np, det_cum, plans.eval_det_cum_b, base.seg_dts,
            base.eval_times,
        )
        t_rank = comm.axis_rank(mesh, traj_axis)
        s_rank = comm.axis_rank(mesh, state_axis)
        tb = n_traj // t_dev
        tk = slice(t_rank * tb, (t_rank + 1) * tb)
        block = 2 ** (n - k)
        sl = slice(s_rank * block, (s_rank + 1) * block)
        body = _make_ip_local_work(
            tuple(map(tuple, pairs)), n, k, s_rank,
            comm.axis_group(mesh, state_axis),
        )
        stage = S._stage_host
        loc = body(
            stage(np.asarray(psi0, cdtype)[sl], dev, cdtype),
            stage(amp_np[tk], dev, cdtype),
            stage((-det_cum[tk]) % two_pi, dev, rdtype),
            stage(base.seg_stage("t_stage"), dev, rdtype),
            np.asarray(base.seg_dts, dtype=rdtype),
            stage(base.eval_times - base.grid[0], dev, rdtype),
            stage((-plans.eval_det_cum_b[tk]) % two_pi, dev, rdtype),
            stage(np.asarray(static_diags).real[tk, sl], dev, rdtype),
        )  # (tb, n_seg, block)
        # Assembled on the host: the card holds only the rank's block
        full = _gather_blocks(loc, comm.axis_group(mesh, state_axis))
        out = comm.gather_to_host(full, comm.axis_group(mesh, traj_axis))
        out = out.reshape(n_traj, n_seg, 2**n)
    out = comm.broadcast_from(
        out, mesh, (n_traj, n_seg, 2**n), S._torch_dtype(cdtype)
    )
    S.last_solve_info.clear()
    S.last_solve_info.update(
        kind="sesolve_2d_sharded_torch",
        dim=2**n,
        n=n,
        n_traj=n_traj,
        n_steps=int(np.count_nonzero(base.seg_dts)),
        ranks=comm.mesh_size(mesh),
        mesh=(t_dev, s_dev),
    )
    return out.numpy()[:, base.eval_map].astype(cdtype)
