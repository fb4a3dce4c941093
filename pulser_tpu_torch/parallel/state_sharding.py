"""Distributed statevector evolution: sharding the ``2^N`` axis over ranks.

Port of ``pulser_tpu/parallel/state_sharding.py`` on ``torch.distributed``.
Each rank of a mesh axis holds a contiguous block of amplitudes:

- the **leading k qubits** (``2^k`` ranks) are the rank: rank ``s`` holds
  the amplitudes whose first ``k`` bits spell ``s``;
- the interaction diagonal and the detuning phases (the solve runs in the
  interaction picture, the whole diagonal rotated away exactly) are
  elementwise: local, the sharded qubits' occupancies constant per rank;
- drives on **local qubits** use the single-device solver's grouped
  matrices (:mod:`pulser_tpu_torch.ops.apply`) on the block;
- a drive on a **sharded qubit** ``q`` couples each amplitude to the one
  whose ``q``-th bit is flipped, on exactly one other rank: one
  XOR-partner exchange of the block (:func:`~.comm.exchange`) per sharded
  qubit and RK4 stage, times a complex scalar (the interaction picture
  keeps the drive purely off-diagonal).

XY mode (the flip-flop term's lowering and raising of a sharded qubit is
an exchange plus a digit mask) and qudits (two bits per digit of the flat
``4^n`` index, qutrits embedded into ``d = 4``) shard the same way. The
solves return the whole ``(n_eval, dim)`` states on every rank (one
gather at the end, assembled on the host: the card holds only the
rank's block).

:class:`RhoColumns` carries the row sharding of a density matrix for
``ops.solver.mesolve_rk4``.
"""

from __future__ import annotations

import os
from typing import Any, Callable

import numpy as np
import torch

from pulser_tpu_torch.ops.apply import (
    _group_matrix,
    apply_block_c,
    build_drive_matrices,
    group_sizes,
)
from pulser_tpu_torch.parallel import comm

#: Minimum qubit count for the emulator to prefer state sharding over a
#: single-device solve (the environment overrides it).
STATE_SHARD_MIN_QUBITS = 22


def state_shard_min_qubits() -> int:
    """The active state-sharding threshold
    (``PULSER_TPU_STATE_SHARD_MIN_QUBITS``)."""
    return int(
        os.environ.get(
            "PULSER_TPU_STATE_SHARD_MIN_QUBITS", STATE_SHARD_MIN_QUBITS
        )
    )


#: Density matrices cost 4^N, so their single-device ceiling is about
#: half the statevector's qubit count.
RHO_SHARD_MIN_QUBITS = 13


def rho_shard_min_qubits() -> int:
    """The density-matrix row-sharding threshold
    (``PULSER_TPU_RHO_SHARD_MIN_QUBITS``)."""
    return int(
        os.environ.get("PULSER_TPU_RHO_SHARD_MIN_QUBITS", RHO_SHARD_MIN_QUBITS)
    )


def default_state_mesh(n: int, axis_name: str = "state") -> Any:
    """A power-of-two 1-D mesh for sharding an ``n``-qubit state.

    Takes the largest power-of-two set of the world's ranks (the
    XOR-partner exchange needs a hypercube). None without a process
    group, with one rank, when ``PULSER_TPU_DISABLE_SHARDING`` is set or
    when ``n`` is too small to split.
    """
    if os.environ.get("PULSER_TPU_DISABLE_SHARDING") or not comm.world_ready():
        return None
    import torch.distributed as dist

    k = dist.get_world_size().bit_length() - 1
    if k < 1 or k >= n:
        return None
    return comm.make_mesh((2**k,), (axis_name,))


def _xor_perm(n_dev: int, bit: int) -> list[tuple[int, int]]:
    """The XOR-partner permutation for one sharded-qubit bit."""
    return [(s, s ^ (1 << bit)) for s in range(n_dev)]


def _shard_k(mesh: Any, n: int, what: str = "qubits") -> int:
    """``k`` with ``2^k`` the mesh's size, refusing a malformed mesh."""
    n_dev = comm.mesh_size(mesh)
    k = n_dev.bit_length() - 1
    if 2**k != n_dev:
        raise ValueError(f"mesh size must be a power of two, got {n_dev}")
    if k >= n:
        raise ValueError(f"cannot shard {n} {what} over {n_dev} devices")
    return k


def _check_qubit_pairs(pairs: tuple) -> None:
    for i, j, _ in pairs:
        if {i, j} != {0, 1}:
            raise ValueError("state sharding requires qubit (d=2) drive pairs")


def _gather_blocks(ys: torch.Tensor, group: Any) -> torch.Tensor:
    """``(B..., n_seg, dim)`` on the host from every rank's ``(B...,
    n_seg, block)``, blocks in rank order (the card holds only its own:
    :func:`~.comm.gather_to_host`)."""
    parts = comm.gather_to_host(ys, group)  # (S, B..., n_seg, block)
    return torch.movedim(parts, 0, -2).reshape(*ys.shape[:-1], -1)


def sharded_route(
    d: int, use_ip: bool, xy_static: Any, has_int_w: bool
) -> str | None:
    """Which state-sharded solve a Schrödinger configuration takes:
    ``"ip"`` (qubits in the interaction picture), ``"qudit"`` (d ∈ {3, 4}
    in the interaction picture), ``"xy"`` (qubits in XY mode with one
    static coupling matrix), or None when it solves unsharded."""
    if use_ip and d == 2:
        return "ip"
    if use_ip and d in (3, 4):
        return "qudit"
    if (
        d == 2
        and xy_static is not None
        and np.asarray(xy_static).shape[0] == 1
        and not has_int_w
    ):
        return "xy"
    return None


def solve_state_mesh(
    d: int, n: int, use_ip: bool, xy_static: Any, has_int_w: bool
) -> Any:
    """The default state mesh of a Schrödinger solve, or None.

    Beyond the single-device threshold (:func:`state_shard_min_qubits`)
    the ``2^N`` axis shards over the ranks for the configurations of
    :func:`sharded_route`: qubits over ``n`` bits, qudits (two bits a
    digit, d=3 embedded into d=4) over the effective ``2n - 1``.
    """
    route = sharded_route(d, use_ip, xy_static, has_int_w)
    if route is None:
        return None
    bits = n if route != "qudit" else 2 * n
    if bits < state_shard_min_qubits():
        return None
    return default_state_mesh(bits if route != "qudit" else bits - 1)


def sesolve_ip_statevector_sharded(
    psi0: np.ndarray,
    plan: Any,
    static_diag: np.ndarray,
    pairs: tuple[tuple[int, int, int], ...],
    n: int,
    mesh: Any,
    dtype: Any = None,
    axis_name: str = "state",
    device: Any = None,
) -> np.ndarray:
    """Interaction-picture sesolve with the statevector sharded.

    Matches :func:`pulser_tpu_torch.ops.solver.sesolve_rk4`'s IP path
    numerically (same RK4 stages, same segmented plan); only the data
    placement differs.

    Args:
        psi0: ``(2**n,)`` complex initial state (host numpy).
        plan: The :func:`~pulser_tpu_torch.ops.solver.build_plan` result.
        static_diag: ``(2**n,)`` interaction diagonal.
        pairs: Per-basis ``(i, j, k)`` drive triples; qubits only
            (``{i, j} == {0, 1}``).
        n: The qubit count.
        mesh: A ``DeviceMesh`` whose size is a power of two below
            ``2**n``; its ``axis_name`` axis (or its only axis) carries
            the exchanges.
        dtype: Complex dtype of the evolution (defaults to psi0's).
        device: The torch device of this rank (default: its card).

    Returns:
        ``(n_eval, 2**n)`` complex states at the evaluation times, on
        every rank.
    """
    from pulser_tpu_torch.ops import solver as S

    k = _shard_k(mesh, n)
    _check_qubit_pairs(pairs)
    cdtype = S._complex_dtype(dtype or np.asarray(psi0).dtype)
    rdtype = np.zeros((), dtype=cdtype).real.dtype
    dev = S._resolve_device(device)
    psi0_np = np.asarray(psi0, dtype=cdtype)
    n_seg = plan.seg_dts.shape[0]
    ys = None
    if comm.in_mesh(mesh):
        comm.check_same_inputs(
            mesh, "state solve", psi0_np, static_diag, pairs,
            *comm.plan_arrays(plan),
        )
        group = comm.axis_group(mesh, axis_name)
        rank = comm.axis_rank(mesh, axis_name)
        block = 2 ** (n - k)
        sl = slice(rank * block, (rank + 1) * block)
        amp, cum, t_stage, dts, eval_t, eval_cum = S._ip_stage_arrays(
            plan, rdtype, cdtype, dev
        )
        body = _make_ip_local_work(tuple(map(tuple, pairs)), n, k, rank, group)
        loc = body(
            torch.from_numpy(psi0_np[sl].copy()).to(dev),
            amp,
            cum,
            t_stage,
            dts,
            eval_t,
            eval_cum,
            torch.from_numpy(
                np.ascontiguousarray(np.asarray(static_diag).real[sl], rdtype)
            ).to(dev),
        )
        ys = _gather_blocks(loc, group)
    out = comm.broadcast_from(ys, mesh, (n_seg, 2**n), S._torch_dtype(cdtype))
    S.last_solve_info.clear()
    S.last_solve_info.update(
        kind="sesolve_state_sharded_torch",
        dim=2**n,
        n=n,
        n_steps=int(np.count_nonzero(plan.seg_dts)),
        ranks=comm.mesh_size(mesh),
        ip=True,
    )
    return out.numpy()[plan.eval_map].astype(cdtype)


def _make_ip_local_work(
    pairs: tuple[tuple[int, int, int], ...],
    n: int,
    k: int,
    rank: int,
    group: Any,
) -> Callable[..., torch.Tensor]:
    """The per-rank interaction-picture sesolve body of a sharded state.

    Shared by the 1-D state sharding (:func:`sesolve_ip_statevector_sharded`)
    and the 2-D trajectory × state mesh
    (:mod:`pulser_tpu_torch.parallel.mesh2d`), which runs it on its local
    trajectory block: every input but the grid may carry leading batch
    axes ``B``, and one exchange then carries the whole block.

    The returned ``local_work(psi_loc, amp, cum_mod, t_stage, dts, eval_t,
    eval_cum_mod, diag_loc)`` takes the rank's ``(B..., block)`` slice of
    the initial state and of the diagonal and the stage arrays of
    ``ops.solver._ip_stage_arrays`` (with ``B`` leading), and returns the
    rank's ``(B..., n_seg, block)`` lab-frame states after each segment.
    """
    from pulser_tpu_torch.ops import solver as S

    n_local = n - k
    block = 2**n_local
    digits = [(rank >> (k - 1 - q)) & 1 for q in range(k)]
    partners = [dict(_xor_perm(2**k, k - 1 - q))[rank] for q in range(k)]
    groups = group_sizes(2, n_local)
    offsets = [sum(groups[:i]) for i in range(len(groups))]

    def local_work(
        psi_loc: torch.Tensor,
        amp: torch.Tensor,
        cum_mod: torch.Tensor,
        t_stage: torch.Tensor,
        dts: np.ndarray,
        eval_t: torch.Tensor,
        eval_cum_mod: torch.Tensor,
        diag_loc: torch.Tensor,
    ) -> torch.Tensor:
        rdt, dev = diag_loc.dtype, diag_loc.device
        lead = tuple(diag_loc.shape[:-1])
        phase_local = S._make_ip_phase_fn(pairs, 2, n_local, rdt, dev)
        # The sharded qubits' projector occupancies: this rank's digits
        occ_sh = torch.tensor(
            [[float(digits[q] == kp) for q in range(k)] for _, _, kp in pairs],
            dtype=rdt,
            device=dev,
        )

        def phase_at(diag: torch.Tensor, t_s: Any, cum_s: torch.Tensor):
            ph = phase_local(diag, t_s, cum_s[..., k:])
            return ph + (cum_s[..., :k] * occ_sh).sum((-1, -2))[..., None]

        def chunk_inputs(s: int, sl: slice) -> tuple:
            a = amp[..., s, sl, :, :, :]
            a_loc = a[..., k:]
            mats = build_drive_matrices(
                a_loc, torch.zeros_like(a_loc.real), pairs, 2, n_local
            )
            gm = [
                -1j * _group_matrix(mats, q0, q0 + g, 2)
                for q0, g in zip(offsets, groups)
            ]
            # m[digit, 1 - digit] of a sharded qubit: amp where the digit
            # is the pair's i, amp* where it is j (one exchange serves
            # every basis)
            coefs = []
            for q in range(k):
                c = None
                for b, (i, _, _) in enumerate(pairs):
                    ab = a[..., b, q]
                    t = ab if digits[q] == i else ab.conj()
                    c = t if c is None else c + t
                coefs.append(-1j * c)
            c_len = sl.stop - sl.start
            ph = phase_at(
                diag_loc[..., None, None, :].expand(lead + (c_len, 3, block)),
                t_stage[s, sl, :, None],
                cum_mod[..., s, sl, :, :, :],
            )
            return gm, coefs, torch.complex(torch.cos(ph), -torch.sin(ph))

        def deriv(p: torch.Tensor, inputs: tuple, i: int, j: int):
            gm, coefs, rot = inputs
            r = rot[..., i, j, :]
            w = r * p
            y = None
            for q0, g, m in zip(offsets, groups, gm):
                t = apply_block_c(
                    m[..., i, j, :, :], w, 2**q0, 2**g, 2 ** (n_local - q0 - g)
                )
                y = t if y is None else y + t
            for q in range(k):
                w_p = comm.exchange(w, partners[q], group)
                y = y + coefs[q][..., i, j, None] * w_p
            return r.conj() * y

        def emit(s: int, phi: torch.Tensor) -> torch.Tensor:
            ph = phase_at(diag_loc, eval_t[s], eval_cum_mod[..., s, :, :])
            return torch.complex(torch.cos(ph), -torch.sin(ph)) * phi

        per_step = 3 * (sum(4**g for g in groups) + 2 * block)
        per_step *= int(np.prod(lead)) if lead else 1
        step_bytes = per_step * 2 * amp.real.element_size()
        return S._scan_segments(
            psi_loc.expand(lead + (block,)), dts, chunk_inputs, deriv,
            step_bytes, emit,
        )

    return local_work


def xy_sesolve_statevector_sharded(
    psi0: np.ndarray,
    plan: Any,
    static_diag: np.ndarray,
    xy_mat: np.ndarray,
    pairs: tuple[tuple[int, int, int], ...],
    n: int,
    mesh: Any,
    xy_indices: tuple[int, int],
    dtype: Any = None,
    axis_name: str = "state",
    device: Any = None,
) -> np.ndarray:
    """XY-mode sesolve with the statevector sharded over the mesh.

    The lab-frame Hamiltonian of ``_sesolve_scan``: the drives with their
    detuning, the static diagonal and the ``(N, N)`` flip-flop coupling,
    applied by lowering every qubit, mixing with ``U`` and raising back.
    Lowering or raising a sharded qubit is one XOR-partner exchange of
    the block plus a per-rank digit mask.

    Args:
        psi0: ``(2**n,)`` complex initial state (host numpy).
        plan: :func:`build_plan` result with ``amp`` and ``det`` stages.
        static_diag: ``(2**n,)`` static diagonal.
        xy_mat: ``(n, n)`` real symmetric flip-flop couplings.
        pairs: Per-basis ``(i, j, k)`` drive triples (qubits only).
        n: The qubit count.
        mesh: A power-of-two ``DeviceMesh``.
        xy_indices: ``(up_idx, down_idx)`` eigenbasis indices.
        device: The torch device of this rank (default: its card).

    Returns:
        ``(n_eval, 2**n)`` complex states at the evaluation times.
    """
    from pulser_tpu_torch.ops import solver as S

    k = _shard_k(mesh, n)
    cdtype = S._complex_dtype(dtype or np.asarray(psi0).dtype)
    rdtype = np.zeros((), dtype=cdtype).real.dtype
    dev = S._resolve_device(device)
    psi0_np = np.asarray(psi0, dtype=cdtype)
    n_seg = plan.seg_dts.shape[0]
    pairs = tuple(tuple(p) for p in pairs)
    up_idx, down_idx = xy_indices
    ys = None
    if comm.in_mesh(mesh):
        comm.check_same_inputs(
            mesh, "XY state solve", psi0_np, static_diag, xy_mat, pairs,
            xy_indices, *comm.plan_arrays(plan),
        )
        group = comm.axis_group(mesh, axis_name)
        rank = comm.axis_rank(mesh, axis_name)
        n_local = n - k
        block = 2**n_local
        sl = slice(rank * block, (rank + 1) * block)
        digits = [(rank >> (k - 1 - q)) & 1 for q in range(k)]
        partners = [
            dict(_xor_perm(2**k, k - 1 - q))[rank] for q in range(k)
        ]
        groups = group_sizes(2, n_local)
        offsets = [sum(groups[:i]) for i in range(len(groups))]

        def to_dev(host: Any, dt: Any) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(host, dtype=dt)).to(
                dev
            )

        amp = to_dev(plan.seg_stage("amp"), cdtype)
        det = to_dev(plan.seg_stage("det").real, rdtype)
        diag_loc = to_dev(np.asarray(static_diag).real[sl], rdtype)
        u = to_dev(np.asarray(xy_mat).real, rdtype).to(amp.dtype)

        def lower_raise(v: torch.Tensor, q: int, src: int, dst: int):
            """The local qubit ``q``'s ``|dst><src|`` on ``v``."""
            view = v.reshape(2**q, 2, 2 ** (n_local - 1 - q))
            out = torch.zeros_like(view)
            out[:, dst] = view[:, src]
            return out.reshape(block)

        def flip_flop(psi: torch.Tensor) -> torch.Tensor:
            rows = [
                (digits[q] == down_idx) * comm.exchange(psi, partners[q], group)
                for q in range(k)
            ] + [lower_raise(psi, q, up_idx, down_idx) for q in range(n_local)]
            mixed = u @ torch.stack(rows)  # (n, block)
            acc = None
            for q in range(k):
                v_p = comm.exchange(mixed[q], partners[q], group)
                t = (digits[q] == up_idx) * v_p
                acc = t if acc is None else acc + t
            for q in range(n_local):
                t = lower_raise(mixed[k + q], q, down_idx, up_idx)
                acc = t if acc is None else acc + t
            return acc

        def chunk_inputs(s: int, sl_: slice) -> tuple:
            a, de = amp[s, sl_], det[s, sl_]
            mats = build_drive_matrices(
                a[..., k:], de[..., k:], pairs, 2, n_local
            )
            gm = [
                _group_matrix(mats, q0, q0 + g, 2)
                for q0, g in zip(offsets, groups)
            ]
            coefs, dets = [], []
            for q in range(k):
                c = det_q = None
                for b, (i, _, kp) in enumerate(pairs):
                    ab = a[..., b, q]
                    t = ab if digits[q] == i else ab.conj()
                    c = t if c is None else c + t
                    o = -de[..., b, q] * float(digits[q] == kp)
                    det_q = o if det_q is None else det_q + o
                coefs.append(c)
                dets.append(det_q)
            return gm, coefs, dets

        def deriv(p: torch.Tensor, inputs: tuple, i: int, j: int):
            gm, coefs, dets = inputs
            out = diag_loc * p
            for q0, g, m in zip(offsets, groups, gm):
                out = out + apply_block_c(
                    m[i, j], p, 2**q0, 2**g, 2 ** (n_local - q0 - g)
                )
            for q in range(k):
                w_p = comm.exchange(p, partners[q], group)
                out = out + coefs[q][i, j] * w_p + dets[q][i, j] * p
            out = out + flip_flop(p)
            return -1j * out

        per_step = 3 * (sum(4**g for g in groups) + 2 * k)
        loc = S._scan_segments(
            to_dev(psi0_np[sl], cdtype), np.asarray(plan.seg_dts, rdtype),
            chunk_inputs, deriv, per_step * 2 * det.element_size(),
            lambda s, psi: psi,
        )
        ys = _gather_blocks(loc, group)
    out = comm.broadcast_from(ys, mesh, (n_seg, 2**n), S._torch_dtype(cdtype))
    S.last_solve_info.clear()
    S.last_solve_info.update(
        kind="sesolve_state_sharded_torch",
        dim=2**n,
        n=n,
        n_steps=int(np.count_nonzero(plan.seg_dts)),
        ranks=comm.mesh_size(mesh),
        ip=False,
    )
    return out.numpy()[plan.eval_map].astype(cdtype)


def qudit_embed_indices(n: int, d: int) -> np.ndarray:
    """Flat indices of the ``(d,)**n`` tensor inside ``(4,)**n``.

    Qudit sharding works on power-of-two digit fields (two bits per
    qudit), so a qutrit register embeds into the d=4 tensor: amplitude
    ``(a_1..a_n)`` lands at ``Σ a_q · 4^(n-1-q)``. No drive pair couples
    level 3, so the padded amplitudes stay exactly zero.
    """
    idx = np.arange(d**n, dtype=np.int64)
    g4 = np.zeros_like(idx)
    rem = idx
    for q in range(n):
        p = d ** (n - 1 - q)
        g4 = g4 * 4 + rem // p
        rem = rem % p
    return g4


def qudit_sesolve_ip_statevector_sharded(
    psi0: np.ndarray,
    plan: Any,
    static_diag: np.ndarray,
    pairs: tuple[tuple[int, int, int], ...],
    n: int,
    mesh: Any,
    d: int,
    dtype: Any = None,
    axis_name: str = "state",
    device: Any = None,
) -> np.ndarray:
    """Sharded interaction-picture sesolve for d ∈ {3, 4} qudits.

    Each qudit is a two-bit digit of the flat ``4^n = 2^(2n)`` index and
    the ranks take the leading ``k`` bits. A drive pair ``(i, j)`` on a
    digit with sharded bits is an XOR by ``i^j`` on that digit's bit
    field: its rank part one exchange (a rank XOR is a permutation of the
    ranks), its local part an axis reversal, masked by the digit
    occupancies ``digit==i`` / ``digit==j``. Fully local digits use the
    single-device solver's grouped matrices. Qutrits (d=3) embed into the
    d=4 tensor (:func:`qudit_embed_indices`).
    """
    from pulser_tpu_torch.ops import solver as S

    n_dev = comm.mesh_size(mesh)
    k = n_dev.bit_length() - 1
    if 2**k != n_dev:
        raise ValueError(f"mesh size must be a power of two, got {n_dev}")
    if d not in (3, 4):
        raise ValueError(f"qudit sharding supports d in (3, 4), not {d}")
    if k > 2 * (n - 1):
        raise ValueError(f"cannot shard {n} qudits over {n_dev} devices")
    for i, j, kp in pairs:
        if max(i, j, kp) >= d:
            raise ValueError(f"pair {(i, j, kp)} outside d={d}")
    cdtype = S._complex_dtype(dtype or np.asarray(psi0).dtype)
    rdtype = np.zeros((), dtype=cdtype).real.dtype
    dev = S._resolve_device(device)
    psi0_np = np.asarray(psi0, dtype=cdtype)
    diag_np = np.asarray(static_diag).real.astype(rdtype)
    g4 = None
    if d == 3:
        g4 = qudit_embed_indices(n, 3)
        psi4 = np.zeros(4**n, dtype=cdtype)
        psi4[g4] = psi0_np
        diag4 = np.zeros(4**n, dtype=rdtype)
        diag4[g4] = diag_np
        psi0_np, diag_np = psi4, diag4
    n_seg = plan.seg_dts.shape[0]
    pairs = tuple(tuple(p) for p in pairs)
    ys = None
    if comm.in_mesh(mesh):
        comm.check_same_inputs(
            mesh, "qudit state solve", psi0_np, diag_np, pairs,
            *comm.plan_arrays(plan),
        )
        group = comm.axis_group(mesh, axis_name)
        rank = comm.axis_rank(mesh, axis_name)
        ys = _gather_blocks(
            _qudit_local_solve(
                psi0_np, diag_np, plan, pairs, n, k, rank, group,
                rdtype, cdtype, dev,
            ),
            group,
        )
    out = comm.broadcast_from(ys, mesh, (n_seg, 4**n), S._torch_dtype(cdtype))
    S.last_solve_info.clear()
    S.last_solve_info.update(
        kind="sesolve_state_sharded_torch",
        dim=d**n,
        n=n,
        n_steps=int(np.count_nonzero(plan.seg_dts)),
        ranks=n_dev,
        ip=True,
    )
    out_np = out.numpy()[plan.eval_map]
    if g4 is not None:
        out_np = out_np[:, g4]
    return out_np.astype(cdtype)


def _qudit_local_solve(
    psi0_np: np.ndarray,
    diag_np: np.ndarray,
    plan: Any,
    pairs: tuple[tuple[int, int, int], ...],
    n: int,
    k: int,
    rank: int,
    group: Any,
    rdtype: Any,
    cdtype: Any,
    dev: torch.device,
) -> torch.Tensor:
    """One rank's ``(n_seg, block)`` of the d=4 sharded IP solve."""
    from pulser_tpu_torch.ops import solver as S

    d = 4
    n_bits = 2 * n
    block = 2 ** (n_bits - k)
    q_loc = -(-k // 2)  # digits with at least one sharded bit
    n_loc4 = n - q_loc  # fully local digits
    pre = block // d**n_loc4  # 1, or 2 when k is odd
    groups = group_sizes(d, n_loc4)
    offsets = [sum(groups[:i]) for i in range(len(groups))]
    nb = len(pairs)
    sl = slice(rank * block, (rank + 1) * block)
    amp, cum_mod, t_stage, dts, eval_t, eval_cum_mod = S._ip_stage_arrays(
        plan, rdtype, cdtype, dev
    )
    rdt = cum_mod.dtype
    diag_loc = torch.from_numpy(np.ascontiguousarray(diag_np[sl])).to(dev)
    glob = rank * block + torch.arange(block, device=dev)

    def digit(q: int) -> torch.Tensor:
        return (glob >> (2 * (n - 1 - q))) & 3

    occ = torch.stack(
        [(digit(q) == kp).to(rdt) for _, _, kp in pairs for q in range(n)]
    ).reshape(nb, n, block)
    dig_f = [digit(q).to(rdt) for q in range(q_loc)]

    def phase_at(t_s: Any, cum_s: torch.Tensor) -> torch.Tensor:
        phi = torch.remainder(diag_loc * t_s, 2 * np.pi)
        return phi + torch.einsum("...bq,bqD->...D", cum_s, occ)

    def bitflip_local(w: torch.Tensor, local_mask: int) -> torch.Tensor:
        """XOR the local flat index by a constant mask."""
        for p in range(n_bits - k):
            if (local_mask >> p) & 1:
                shape = (block // 2 ** (p + 1), 2, 2**p)
                w = torch.flip(w.reshape(shape), dims=(1,)).reshape(block)
        return w

    # Per (digit, basis) with sharded bits: (rank partner, local mask)
    moves = {}
    for q in range(q_loc):
        for b, (i, j, _) in enumerate(pairs):
            if i == j:
                continue
            mask = (i ^ j) << (2 * (n - 1 - q))
            moves[q, b] = (rank ^ (mask >> (n_bits - k)), mask & (block - 1))
    masks = {
        (q, lvl): (dig_f[q] == lvl).to(rdt)
        for q in range(q_loc)
        for lvl in range(d)
    }

    def chunk_inputs(s: int, sl_: slice) -> tuple:
        a = amp[s, sl_]  # (c, 3, nb, n)
        a_loc = a[..., q_loc:]
        mats = build_drive_matrices(
            a_loc, torch.zeros_like(a_loc.real), pairs, d, n_loc4
        )
        gm = [
            _group_matrix(mats, q0, q0 + g, d)
            for q0, g in zip(offsets, groups)
        ]
        c_len = sl_.stop - sl_.start
        ph = phase_at(t_stage[s, sl_, :, None], cum_mod[s, sl_])
        assert ph.shape == (c_len, 3, block)
        return gm, a, torch.complex(torch.cos(ph), -torch.sin(ph))

    def amp_apply(w: torch.Tensor, gm: list, a: torch.Tensor, i_: int, j_: int):
        out = None
        for q0, g, m in zip(offsets, groups, gm):
            t = apply_block_c(
                m[i_, j_], w, pre * d**q0, d**g, d ** (n_loc4 - q0 - g)
            )
            out = t if out is None else out + t
        for q in range(q_loc):
            for b, (i, j, _) in enumerate(pairs):
                ab = a[i_, j_, b, q]
                if i == j:
                    # a σ_ii + a* σ_ii on the diagonal
                    out = out + (2.0 * ab.real) * masks[q, i] * w
                    continue
                partner, local_mask = moves[q, b]
                w_p = comm.exchange(w, partner, group)
                if local_mask:
                    w_p = bitflip_local(w_p, local_mask)
                coef = torch.complex(
                    ab.real * (masks[q, i] + masks[q, j]),
                    ab.imag * (masks[q, i] - masks[q, j]),
                )
                out = out + coef * w_p
        return out

    def deriv(p: torch.Tensor, inputs: tuple, i: int, j: int):
        gm, a, rot = inputs
        r = rot[i, j]
        y = amp_apply(r * p, gm, a, i, j)
        return r.conj() * (-1j * y)

    def emit(s: int, phi: torch.Tensor) -> torch.Tensor:
        ph = phase_at(eval_t[s], eval_cum_mod[s])
        return torch.complex(torch.cos(ph), -torch.sin(ph)) * phi

    per_step = 3 * (sum(16**g for g in groups) + 2 * block)
    return S._scan_segments(
        torch.from_numpy(np.ascontiguousarray(psi0_np[sl])).to(dev),
        dts, chunk_inputs, deriv, per_step * 2 * rdt.itemsize, emit,
    )


class RhoColumns:
    """The row sharding of a density matrix over one mesh axis.

    Rank ``r`` of ``P`` holds ρ's rows ``R_r = [r·B, (r+1)·B)``, ``B =
    dim/P``, stored as the columns ``ρ[:, R_r] = (ρ[R_r, :])†`` (ρ is
    Hermitian): the row-side operators of the master equation (the drive
    groups, the XY term, the anticommutator) then act on a whole row
    index, locally. Two steps need other ranks' entries:

    - :meth:`dag`, the ``X†`` of ``X + X†``: one all-to-all of ``B × B``
      blocks per call (the transpose);
    - :meth:`sup_add`, the column side of ``L ρ L†`` on a qudit whose
      digit does not cycle inside one block: the column slabs of the
      other digit values, from the ranks that hold them, by one
      all-to-all (for qubits, the XOR partner's block).
    """

    def __init__(self, mesh: Any, dim: int, axis_name: str = "state"):
        self.group = comm.axis_group(mesh, axis_name)
        self.size = comm.axis_size(mesh, axis_name)
        self.rank = comm.axis_rank(mesh, axis_name)
        self.block = dim // self.size
        self.cols = slice(self.rank * self.block, (self.rank + 1) * self.block)

    def dag(self, x: torch.Tensor) -> torch.Tensor:
        """``X†[:, R_r]`` from every rank's ``X[:, R_s]`` (``(..., dim,
        B)`` in, ``(..., dim, B)`` out)."""
        b = self.block
        chunks = [x[..., s * b : (s + 1) * b, :] for s in range(self.size)]
        shape = tuple(x.shape[:-2]) + (b, b)
        got = comm.all_to_all(chunks, [shape] * self.size, self.group, x)
        rows = torch.cat(got, dim=-1)  # X[R_r, :]
        return rows.transpose(-1, -2).conj()

    def _digit_needs(
        self, rank: int, s_q: int, run: int, m: int, d: int, sup: list
    ) -> list[tuple[tuple[int, int], int, int]]:
        """The remote column slabs rank ``rank`` reads for the column side
        of ``sup`` on a digit of stride ``s_q``: ``((u, j2), owner,
        offset)`` per run ``u`` of its block and source digit ``j2``."""
        b = self.block
        a0 = (rank * b // s_q) % d
        needs = {}
        for _, i2, _, j2, _ in sup:
            u = i2 - a0
            if 0 <= u < m and not 0 <= j2 - a0 < m:
                g = rank * b + u * run + (j2 - i2) * s_q
                needs[u, j2] = (g // b, g % b)
        return [(key, *needs[key]) for key in sorted(needs)]

    def sup_add(
        self, k: torch.Tensor, p: torch.Tensor, q: int, sup: list, d: int,
        n: int,
    ) -> None:
        """Adds the superoperator entries ``(i1, i2, j1, j2, c)`` of qudit
        ``q`` to the block ``k`` (in place): each moves ``p``'s ``(j1,
        j2)`` (row, column) digit block to ``(i1, i2)``, as the unsharded
        scan's strided adds do. When the digit cycles inside a block the
        adds are local; otherwise a column source of another digit value
        lives on other ranks, and one all-to-all brings every such slab
        (every rank takes part: the decision depends on ``sup`` alone)."""
        lead = tuple(k.shape[:-2])
        b = self.block
        s_q = d ** (n - 1 - q)
        rows = (*lead, d**q, d, d ** (n - 1 - q))
        if b % (d * s_q) == 0:
            shape5 = (*rows[:-1], d ** (n - 1 - q) * (b // (d * s_q)), d, s_q)
            kv, pv = k.view(shape5), p.view(shape5)
            for i1, i2, j1, j2, c in sup:
                kv[..., i1, :, i2, :].add_(pv[..., j1, :, j2, :], alpha=c)
            return
        # The block holds m runs of `run` columns, one digit value each
        run = min(b, s_q)
        m = b // run
        a0 = (self.rank * b // s_q) % d
        remote: dict[tuple[int, int], torch.Tensor] = {}
        if any(i2 != j2 for _, i2, _, j2, _ in sup):
            needs = [
                self._digit_needs(r, s_q, run, m, d, sup)
                for r in range(self.size)
            ]
            chunks: list[torch.Tensor | None] = [None] * self.size
            shapes: list[tuple[int, ...] | None] = [None] * self.size
            for r, need in enumerate(needs):
                mine = [off for _, owner, off in need if owner == self.rank]
                if mine and r != self.rank:
                    chunks[r] = torch.cat(
                        [p[..., off : off + run] for off in mine], dim=-1
                    )
            by_owner: dict[int, list] = {}
            for key, owner, _ in needs[self.rank]:
                by_owner.setdefault(owner, []).append(key)
            for owner, keys in by_owner.items():
                shapes[owner] = (*lead, p.shape[-2], run * len(keys))
            got = comm.all_to_all(chunks, shapes, self.group, p)
            for owner, keys in by_owner.items():
                for key, slab in zip(keys, torch.split(got[owner], run, -1)):
                    remote[key] = slab.contiguous().view(*rows, run)
        kv = k.view(*rows, m, run)
        pv = p.view(*rows, m, run)
        for i1, i2, j1, j2, c in sup:
            u = i2 - a0
            if not 0 <= u < m:
                continue
            if 0 <= j2 - a0 < m:
                src = pv[..., j1, :, j2 - a0, :]
            else:
                src = remote[u, j2][..., j1, :, :]
            kv[..., i1, :, u, :].add_(src, alpha=c)
