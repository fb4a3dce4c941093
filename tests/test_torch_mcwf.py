"""The port's quantum-jump layers against pulser_tpu on identical inputs.

- Staging: ``_stage_on_device`` / ``_stage_cum_on_device`` on plain
  coefficient batches and on :class:`RankFactors`, against the JAX
  functions on the same float32 inputs: max |Δ| ≤ 1e-6 (phases compared
  on the circle; the port integrates the phases in float64, and is held
  against the JAX function run in float64), and ≤ 4e-6 when both
  integrate in float32.
- K2: the plain twin ``mcwf_rows_reference`` (what the ``mcwf_rows``
  wrapper runs on CPU tensors) against the JAX package's Pallas kernel
  ``mcwf_rows_program`` in interpret mode, trajectory for trajectory:
  max |Δ| ≤ 5e-5 and final 1 − F ≤ 1e-6, on random inputs where jumps
  certainly fire and through the whole batched solve
  (``mcsolve_rk4_batched``) on both sides.
- Fused codes: the sampled state indices of ``mcsolve_rows_codes`` equal
  the JAX ones for every draw farther than 1e-5 from a bin edge.
- K3: the plain version ``mcwf_reference`` (what the ``mcwf`` wrapper
  runs on CPU tensors) against the JAX package's ``_mcwf_jit`` in
  interpret mode on the same random inputs (max |Δ| ≤ 5e-5, final
  1 − F ≤ 1e-6), and the port's lab-frame ``mcsolve_rk4_batched``
  against the JAX one on its XLA scan and on K3 (1 − F ≤ 1e-6), under
  general collapse operators.

The JAX rows path engages only in single precision, so every JAX call
here runs with x64 switched off (the suite's conftest switches it on).
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from pulser_tpu.ops import apply as jax_apply
from pulser_tpu.ops import solver as jax_solver
from pulser_tpu.ops.pallas_kernels import _mcwf_jit, mcwf_rows_program

import chip_smoke
import pulser_tpu_torch.ops.kernels as K
from pulser_tpu_torch.ops import solver as torch_solver
from pulser_tpu_torch.ops.apply import apply_axis_c, neg_i

torch.set_num_threads(1)

#: K2's twin against the Pallas kernel: float32 both, other orders.
STATE_TOL = 5e-5
FIDELITY_TOL = 1e-6
STAGE_TOL = 1e-6
#: Both integrating in float32: XLA's cumsum and einsum associate
#: differently from torch's, a few ulps of the unreduced integral
#: (|∫det| < 16 here, ulp 9.5e-7).
STAGE_F32_TOL = 4e-6
#: Draws whose u·total lies within this of a cumsum edge may differ.
EDGE_TOL = 1e-5


@contextlib.contextmanager
def _jax_f32():
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", True)


@pytest.fixture
def rows_interpret(monkeypatch):
    """The JAX rows kernel in interpret mode (no Mosaic on the CPU)."""
    monkeypatch.setenv("PULSER_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PULSER_TPU_MCWF_ROWS", "1")


def _coeffs(rng, n, n_traj, knots_count=41):
    """The drive and detuning batches of ``tests/test_mcwf_rows.py``."""
    knots = np.linspace(0.0, 2.0, knots_count)
    amp = np.stack(
        [
            (0.5 * (1.5 + 0.1 * rng.standard_normal((1, n, 1))))
            * np.exp(1j * 0.3 * rng.standard_normal((1, n, knots_count)))
            * np.sin(np.pi * knots / 2.0) ** 2
            for _ in range(n_traj)
        ]
    )
    det = np.stack(
        [
            2.0 * rng.standard_normal((1, n, 1)) * np.ones((1, n, knots_count))
            + np.linspace(-3, 3, knots_count)
            for _ in range(n_traj)
        ]
    )
    return knots, amp, det


def _factored(rng, n, n_traj, knots_count=41):
    """A rank-2 batch as the emulator's fast path makes it: a shared
    drive and detuning profile, a masked offset profile, and per-
    (trajectory, qubit) coefficients."""
    knots = np.linspace(0.0, 2.0, knots_count)
    amp_prof = (
        0.75
        * np.exp(1j * 0.3 * rng.standard_normal((1, 1, n, knots_count)))
        * np.sin(np.pi * knots / 2.0) ** 2
    )
    amp_coef = 1.0 + 0.05 * rng.standard_normal((n_traj, 1, 1, n))
    mask = (knots > 0.3).astype(float) * np.ones((1, n, 1))
    det_prof = np.stack(
        [np.linspace(-3, 3, knots_count) * np.ones((1, n, 1)), mask]
    )
    det_coef = np.stack(
        [np.ones((n_traj, 1, n)), 2.0 * rng.standard_normal((n_traj, 1, n))],
        axis=1,
    )
    return knots, (amp_prof, amp_coef), (det_prof, det_coef)


def _plans(knots, amp, det, factored=False, max_step=4e-3):
    """The same batched plan in both packages."""
    out = []
    for mod in (jax_solver, torch_solver):
        coeffs = (
            {"amp": mod.RankFactors(*amp), "det": mod.RankFactors(*det)}
            if factored
            else {"amp": amp, "det": det}
        )
        out.append(
            mod.build_plan_batched(
                knots,
                coeffs,
                np.array([0.0, 1.0, 2.0]),
                max_step=max_step,
                host_stage=False,
            )
        )
    return out


def _circ(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return np.minimum(d, 2 * np.pi - d)


def _to_jax(x):
    if isinstance(x, torch_solver.RankFactors):
        return jax_solver.RankFactors(_to_jax(x.profiles), _to_jax(x.coeffs))
    return jnp.asarray(x)


@pytest.mark.parametrize("acc", ["float32", "float64"])
@pytest.mark.parametrize("factored", [False, True])
@pytest.mark.parametrize("n, seed", [(4, 0), (6, 1)])
def test_staging_matches_jax(n, seed, factored, acc):
    """``acc="float32"`` integrates the phases in single precision, as
    the JAX package does; ``"float64"`` (the port's default) integrates
    the same float32 inputs in double precision and rounds the result,
    and is held against the JAX function run in double precision."""
    rng = np.random.default_rng(seed)
    if factored:
        knots, amp, det = _factored(rng, n, 5)
    else:
        knots, amp, det = _coeffs(rng, n, 5)
    jplans, tplans = _plans(knots, amp, det, factored)
    # The port's host prep is the JAX one (the detuning leaf aside,
    # which JAX may ship affine-compressed)
    cin = torch_solver._raw_cum_inputs(tplans, np.float32)
    for got, want in zip(
        cin[1:], jax_solver._raw_cum_inputs(jplans, np.float32)[1:]
    ):
        assert np.array_equal(got, want)
    leaves = torch_solver._raw_drive_leaves(tplans, np.float32)
    jax_prec = _jax_f32() if acc == "float32" else contextlib.nullcontext()
    with jax_prec:
        jcin = (_to_jax(cin[0]),) + tuple(jnp.asarray(x) for x in cin[1:])
        if acc == "float64":
            jcin = jax.tree_util.tree_map(
                lambda x: x.astype(jnp.float64)
                if x.dtype == jnp.float32
                else x,
                jcin,
            )
        want_cum, want_ev = jax_solver._stage_cum_on_device(*jcin)
    with _jax_f32():
        want_amp = [
            np.asarray(
                jax_solver._stage_on_device(
                    _to_jax(leaf),
                    jnp.asarray(cin[2]),
                    jnp.asarray(cin[3]),
                    jnp.asarray(cin[5]),
                )
            )
            for leaf in leaves[:2]
        ]
    tcin = [torch_solver._on_device(x, "cpu") for x in cin]
    got_cum, got_ev = torch_solver._stage_cum_on_device(
        *tcin, acc_dtype=getattr(torch, acc)
    )
    assert got_cum.dtype == got_ev.dtype == torch.float32
    assert got_cum.shape == want_cum.shape and got_ev.shape == want_ev.shape
    tol = STAGE_TOL if acc == "float64" else STAGE_F32_TOL
    assert _circ(got_cum, want_cum).max() <= tol
    assert _circ(got_ev, want_ev).max() <= tol
    for leaf, want in zip(leaves[:2], want_amp):
        got = torch_solver._stage_on_device(
            torch_solver._on_device(leaf, "cpu"), tcin[2], tcin[3], tcin[5]
        )
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= STAGE_TOL


def _pallas_states(args, cops):
    """The JAX Pallas kernel (interpret) on the twin's inputs, as
    ``(B, S, 2, dim)``."""
    n = args[0].shape[-1]
    n_traj, n_seg = args[0].shape[0], args[4].shape[0]
    n_col = min(7, n - 1)
    with _jax_f32():
        out = mcwf_rows_program(
            *(jnp.asarray(a.numpy()) for a in args),
            n_row=n - n_col,
            n_col=n_col,
            cops=cops,
            chunk=args[4].shape[1],
            tb=8,
            interpret=True,
        )
        out = np.asarray(out)  # (S, 2, R, T, C)
    out = np.transpose(out, (3, 0, 1, 2, 4))[:n_traj]
    return out.reshape(n_traj, n_seg, 2, 1 << n)


def _final_infidelity(got, want):
    a = want[:, -1, 0] + 1j * want[:, -1, 1]
    b = got[:, -1, 0] + 1j * got[:, -1, 1]
    ov = np.abs(np.sum(np.conj(a) * b, axis=1)) ** 2
    return 1 - ov / (
        np.linalg.norm(a, axis=1) ** 2 * np.linalg.norm(b, axis=1) ** 2
    )


@pytest.mark.parametrize(
    "n, seed, cops",
    [
        (5, 0, chip_smoke.RANDOM_COPS),
        (6, 1, chip_smoke.RANDOM_COPS[1:]),
        (4, 2, chip_smoke.RANDOM_COPS),
    ],
)
def test_k2_twin_matches_pallas_with_jumps(n, seed, cops):
    """Random inputs whose thresholds start near 1 under a strong decay
    channel: every trajectory jumps, several times. The rows are
    plan-like: a step's end row is the next step's start row in the first
    segment (where the CUDA kernel carries its rotor) and not in the
    second."""
    args = chip_smoke.random_mcwf_inputs(n, seed, "cpu")
    carried, n_real = K.mcwf_rows_carried_steps(*args[2:5])
    assert n_real == 14 and carried.tolist() == [7] * 8
    _check_k2_twin_against_pallas(args, n, cops)


def _check_k2_twin_against_pallas(args, n, cops):
    before = K.launches("mcwf_rows")
    got, jumps = K.mcwf_rows(*args, cops=cops)
    assert K.launches("mcwf_rows") == before  # CPU tensors: the plain twin
    assert got.shape == (8, 2, 2, 1 << n) and got.dtype == torch.float32
    assert int(jumps.min()) >= 1
    want = _pallas_states(args, cops)
    got = got.numpy()
    assert np.abs(got - want).max() <= STATE_TOL
    assert _final_infidelity(got, want).max() <= FIDELITY_TOL


def test_k2_twin_matches_pallas_when_rows_differ():
    """No step's start row equals the step before's end row (times off
    the grid, independent phase integrals): the inputs on which the CUDA
    kernel recomputes every rotor have the Pallas kernel as reference
    too."""
    n, cops = 5, chip_smoke.RANDOM_COPS
    args = chip_smoke.random_mcwf_inputs(n, 3, "cpu", plan_like=False)
    carried, _ = K.mcwf_rows_carried_steps(*args[2:5])
    assert int(carried.sum()) == 0
    _check_k2_twin_against_pallas(args, n, cops)


@pytest.mark.parametrize("factored", [False, True])
@pytest.mark.parametrize("n, seed", [(4, 0), (6, 1)])
def test_k2_rows_share_rotors(n, seed, factored):
    """The rotor sharing K2 relies on, on a staged noisy batch: RK4
    stages 1 and 2 read the same plan row, and each real step's end time
    equals the next real step's start time bit for bit, across segment
    boundaries and padding. The per-trajectory phase integrals of the two
    rows are equal in exact arithmetic; the share of steps on which they
    agree in every bit too (the steps whose rotor the kernel carries) is
    recorded, not required to be all."""
    rng = np.random.default_rng(seed)
    n_traj = 5
    if factored:
        knots, amp, det = _factored(rng, n, n_traj)
    else:
        knots, amp, det = _coeffs(rng, n, n_traj)
    _, tplans = _plans(knots, amp, det, factored)
    assert [(j + 1) >> 1 for j in range(4)] == list(torch_solver._RK_STAGE)
    assert torch_solver._RK_STAGE[1] == torch_solver._RK_STAGE[2]
    psi0 = np.zeros(1 << n, np.complex64)
    psi0[-1] = 1.0
    diags = np.zeros((n_traj, 1 << n))
    args = torch_solver.rows_kernel_inputs(
        psi0, tplans, diags, list(range(n_traj)), "cpu"
    )
    cum, t_stage, seg_dts = args[2], args[3], args[4]
    real = seg_dts.reshape(-1) != 0
    assert not bool(real.all())  # some segments start with padding
    assert np.count_nonzero(tplans.plan.seg_dts.any(axis=1)) > 1
    t = t_stage.reshape(-1, 3)[real].numpy().view(np.int32)
    np.testing.assert_array_equal(t[:-1, 2], t[1:, 0])
    c = cum.reshape(n_traj, -1, 3, n)[:, real].numpy()
    assert _circ(c[:, :-1, 2], c[:, 1:, 0]).max() <= STAGE_TOL
    carried, n_real = K.mcwf_rows_carried_steps(cum, t_stage, seg_dts)
    assert n_real == int(real.sum()) and carried.shape == (n_traj,)
    same = (c[:, :-1, 2].view(np.int32) == c[:, 1:, 0].view(np.int32)).all(-1)
    assert carried.tolist() == same.sum(1).tolist()
    share = float(carried.sum()) / (n_traj * (n_real - 1))
    print(f"n={n}, factored={factored}: rotor carried on {share:.1%} of steps")
    assert 0.0 <= share <= 1.0


def _batched_case(n, n_traj, gammas, seed):
    rng = np.random.default_rng(seed)
    dim = 1 << n
    knots, amp, det = _coeffs(rng, n, n_traj)
    jplans, tplans = _plans(knots, amp, det)
    diags = np.stack([rng.uniform(0, 5, dim) for _ in range(n_traj)])
    cops = [
        np.sqrt(g) * np.diag(d).astype(complex)
        for g, d in zip(gammas, ([1.0, -1.0], [0.0, 1.0]))
    ]
    psi0 = np.zeros(dim, np.complex64)
    psi0[-1] = 1.0
    common = dict(
        pairs=((1, 0, 0),),
        d=2,
        n=n,
        collapse_ops=cops,
        seeds=[11 * (t + 1) + seed for t in range(n_traj)],
        dtype=np.complex64,
        ip=True,
    )
    return jplans, tplans, diags, psi0, common


@pytest.mark.parametrize(
    "n, gammas, seed",
    [(5, (0.05,), 7), (6, (0.05,), 8), (5, (0.25, 0.15), 3), (6, (2.0, 3.0), 4)],
)
def test_batched_solve_matches_pallas(rows_interpret, n, gammas, seed):
    n_traj = 5
    jplans, tplans, diags, psi0, common = _batched_case(n, n_traj, gammas, seed)
    with _jax_f32():
        want = jax_solver.mcsolve_rk4_batched(
            psi0, jplans, diags, mesh=None, **common
        )
    assert jax_solver.last_solve_info["kind"] == "mcwf_rows_pallas"
    got = torch_solver.mcsolve_rk4_batched(
        psi0, tplans, diags, device="cpu", **common
    )
    info = torch_solver.last_solve_info
    assert info["kind"] == "mcwf_rows_torch"
    assert info["n_steps"] == jax_solver.last_solve_info["n_steps"]
    assert got.shape == want.shape == (n_traj, 3, 1 << n)
    assert np.abs(got - want).max() <= STATE_TOL
    for t in range(n_traj):
        fid = abs(np.vdot(want[t, -1], got[t, -1])) ** 2
        assert fid >= 1 - FIDELITY_TOL
    if max(gammas) >= 1.0:
        # The strong-decay case: jumps certainly fire
        args = torch_solver.rows_kernel_inputs(
            psi0, tplans, diags, common["seeds"], "cpu"
        )
        _, jumps = K.mcwf_rows_reference(
            *args, cops=torch_solver._diag_cops_spec(common["collapse_ops"])
        )
        assert int(jumps.sum()) > 0


def test_fused_codes_match_pallas_away_from_edges(rows_interpret):
    n, n_traj, spr = 5, 6, 40
    jplans, tplans, diags, psi0, common = _batched_case(n, n_traj, (0.3,), 5)
    rng = np.random.default_rng(9)
    n_times = 3
    row_traj = np.repeat(np.arange(n_traj), n_times)
    row_ti = np.tile(np.arange(n_times), n_traj)
    samp_u = rng.uniform(size=(n_traj * n_times, spr))
    spec = (samp_u, row_traj, row_ti)
    with _jax_f32():
        want = jax_solver.mcsolve_rows_codes(
            psi0, jplans, diags, sample_spec=spec, mesh=None, **common
        )
    assert want is not None
    got = torch_solver.mcsolve_rows_codes(
        psi0, tplans, diags, sample_spec=spec, device="cpu", **common
    )
    assert torch_solver.last_solve_info["sampled"]
    assert got.shape == want.shape == samp_u.shape
    # Distance of each draw from its row's nearest cumsum edge
    states = torch_solver.mcsolve_rk4_batched(
        psi0, tplans, diags, device="cpu", **common
    )
    p = np.abs(states.astype(np.complex64)) ** 2
    cum = np.cumsum(p, axis=-1, dtype=np.float32)[row_traj, row_ti]
    v = samp_u.astype(np.float32) * cum[:, -1:]
    edge = np.min(np.abs(v[:, :, None] - cum[:, None, :]), axis=-1)
    far = edge > EDGE_TOL
    assert far.mean() > 0.95
    assert np.array_equal(got[far], np.asarray(want)[far])
    near = np.argwhere(~far)
    print(f"{len(near)} draws within {EDGE_TOL} of a bin edge: {near.tolist()}")


RELAXATION = np.sqrt(2.0) * np.array([[0, 1], [0, 0]], complex)


def _scan_case(case):
    """``(jax plans, port plans, diags, psi0, common)`` of a configuration
    the quantum-jump kernels do not take, in complex128, with collapse
    operators strong enough that jumps fire."""
    if case == "n14":
        # Fourteen atoms for a few steps
        rng = np.random.default_rng(14)
        knots, amp, det = _coeffs(rng, 14, 2, knots_count=6)
        knots = knots / 100  # 0.02 µs: five steps of 4 ns
        jplans, tplans = (
            mod.build_plan_batched(
                knots, {"amp": amp, "det": det}, np.array([0.01, 0.02]),
                max_step=4e-3, host_stage=False,
            )
            for mod in (jax_solver, torch_solver)
        )
        diags = rng.uniform(0, 5, (2, 1 << 14))
        psi0 = np.zeros(1 << 14, complex)
        psi0[-1] = 1.0
        common = dict(
            pairs=((1, 0, 0),), d=2, n=14, seeds=[3, 4], ip=True,
            collapse_ops=[np.sqrt(30.0) * np.diag([1.0, -1.0]).astype(complex)],
        )
        return jplans, tplans, diags, psi0, common
    jplans, tplans, diags, psi0, common = _batched_case(4, 3, (2.0, 3.0), 5)
    psi0 = psi0.astype(complex)
    if case == "relaxation":
        common["collapse_ops"] = common["collapse_ops"][:1] + [RELAXATION]
    elif case == "plan_list":
        # One host-staged plan per trajectory, on one grid
        rng = np.random.default_rng(5)
        knots, amp, det = _coeffs(rng, 4, 3)
        jplans, tplans = (
            [
                mod.build_plan(
                    knots, {"amp": amp[t], "det": det[t]},
                    np.array([0.0, 1.0, 2.0]), max_step=4e-3,
                )
                for t in range(3)
            ]
            for mod in (jax_solver, torch_solver)
        )
    elif case == "d3":
        # Qutrits: a single matrix unit and a diagonal operator
        n = 3
        rng = np.random.default_rng(6)
        knots, amp, det = _coeffs(rng, n, 3)
        jplans, tplans = _plans(knots, amp, det)
        diags = rng.uniform(0, 5, (3, 27))
        psi0 = np.zeros(27, complex)
        psi0[0] = 1.0
        common.update(
            d=3, n=n,
            collapse_ops=[
                np.sqrt(2.0) * np.eye(3, k=2).astype(complex),
                np.diag([0.5, -1.0, 1.5]).astype(complex),
            ],
        )
    return jplans, tplans, diags, psi0, common


@pytest.mark.parametrize(
    "case", ["no_cops", "relaxation", "n14", "float64", "plan_list", "d3"]
)
def test_solver_refuses_outside_the_gate(case):
    """Neither quantum-jump kernel takes these (relaxation on the
    interaction-picture grid, 14 atoms, double precision, a list of plans,
    qutrits): in single precision the route is the torch scan, and in
    double precision (where the float64 case would take the row-batched
    kernel in single precision) the scan's states equal the JAX package's vmapped
    scan trajectory for trajectory (1e-10). The fused solve declines
    (None), as the JAX package's does. Without collapse operators there
    is no quantum jump to solve: a ValueError."""
    jplans, tplans, diags, psi0, common = _scan_case(case)
    if case == "no_cops":
        common["collapse_ops"] = []
        with pytest.raises(ValueError, match="runs sesolve_rk4_batched"):
            torch_solver.mcsolve_rk4_batched(
                psi0, tplans, diags, device="cpu", **common
            )
    else:
        route_args = {k: common[k] for k in ("ip", "collapse_ops", "d", "n")}
        assert torch_solver._mcwf_route(
            tplans, pairs=common["pairs"], rdtype=np.float32, **route_args
        ) == ("rows" if case == "float64" else "scan")
        common["dtype"] = np.complex128
        want = jax_solver.mcsolve_rk4_batched(
            psi0, jplans, diags, mesh=None, **common
        )
        got = torch_solver.mcsolve_rk4_batched(
            psi0, tplans, diags, device="cpu", **common
        )
        info = torch_solver.last_solve_info
        assert info["kind"] == "mcwf_batched_torch" and info["ip"] is True
        assert got.shape == want.shape and got.dtype == np.complex128
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    assert (
        torch_solver.mcsolve_rows_codes(
            psi0, tplans, diags, sample_spec=None, device="cpu", **common
        )
        is None
    )


# -- K3: the lab-frame solve with general collapse operators --------------


#: General collapse operators of the batched lab-frame cases: the Pauli
#: channel and a complex operator whose G = Σ L†L has a non-zero
#: off-diagonal (so the folded flip entries carry G[1, 0]).
GENERAL_COPS = [
    np.sqrt(0.4) * np.array([[0, 1], [1, 0]], complex),
    np.sqrt(0.4) * np.array([[0, -1j], [1j, 0]], complex),
    np.sqrt(0.4) * np.array([[1, 0], [0, -1]], complex),
    np.array([[0.3, 0.5 + 0.4j], [0.2 - 0.3j, -0.1j]]),
]


@pytest.mark.parametrize("d, n", [(2, 4), (3, 3)])
def test_apply_axis_and_neg_i_match_jax(d, n):
    """The candidates' single-axis application and −i, against the JAX
    package's real-pair versions (float64: the same products)."""
    rng = np.random.default_rng(d * 10 + n)
    psi = rng.normal(size=(2, d**n)) + 1j * rng.normal(size=(2, d**n))
    op = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    batch = torch.from_numpy(psi)
    for axis in range(n):
        got = apply_axis_c(torch.from_numpy(op), batch, axis, d, n).numpy()
        for b in range(2):
            want = jax_apply.apply_axis_c(
                jnp.asarray(op.real), jnp.asarray(op.imag),
                jnp.asarray(np.stack([psi[b].real, psi[b].imag])), axis, d, n,
            )
            want = np.asarray(want[0]) + 1j * np.asarray(want[1])
            assert np.abs(got[b] - want).max() <= 1e-12
    want = np.asarray(
        jax_apply.neg_i(jnp.asarray(np.stack([psi.real, psi.imag])))
    )
    got = neg_i(batch).numpy()
    assert np.array_equal(got, want[0] + 1j * want[1])


@pytest.mark.parametrize("factored", [False, True])
def test_lab_frame_staging_matches_jax(factored):
    """``_lindblad_drive_arrays`` (drives and detunings staged on the
    device from the raw knots) against the JAX function on the same
    plan, and its host-staged branch (a plan without raw coefficients)
    against its raw branch."""
    rng = np.random.default_rng(3)
    n, n_traj = 4, 3
    if factored:
        knots, amp, det = _factored(rng, n, n_traj)
    else:
        knots, amp, det = _coeffs(rng, n, n_traj)
    jplans, tplans = _plans(knots, amp, det, factored)
    got = torch_solver._lindblad_drive_arrays(tplans, np.float32, "cpu")
    with _jax_f32():
        want = jax_solver._lindblad_drive_arrays(jplans, jnp.float32)
        want = [np.asarray(w) for w in want[:3]]
    assert got[3] is tplans.plan and got[4] == n_traj
    for g, w in zip(got[:3], want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= STAGE_TOL
    if not factored:
        host_plan = torch_solver.build_plan_batched(
            knots, {"amp": amp, "det": det}, np.array([0.0, 1.0, 2.0]),
            max_step=4e-3,
        )
        host_plan.raw_coeffs = None
        hosted = torch_solver._lindblad_drive_arrays(
            host_plan, np.float32, "cpu"
        )
        for g, h in zip(got[:3], hosted[:3]):
            assert np.abs(g.numpy() - h.numpy()).max() <= STAGE_TOL


def _jax_k3(args, kw):
    """The JAX package's K3 (``_mcwf_jit``, interpret mode) on the port's
    inputs, as ``(B, S, 2, dim)``."""
    with _jax_f32():
        out = _mcwf_jit(
            *(jnp.asarray(a.numpy()) for a in args), **kw, interpret=True
        )
        out = np.asarray(out)
    n_traj = args[5].shape[0]
    return out.reshape(n_traj, kw["segs_per_traj"], 2, -1)


@pytest.mark.parametrize("n", [2, 4, 6])
def test_k3_twin_matches_pallas_with_jumps(n):
    """Random inputs under strong general collapse operators (G[1, 0] ≠ 0)
    whose thresholds start near 1: every trajectory jumps several times.
    States after each segment within 5e-5 mean the same jump records: a
    jump that fired on one side only would move the state by O(1)."""
    args, kw = chip_smoke.random_k3_inputs(n, n, "cpu")
    assert kw["g_lo"] != (0.0, 0.0)
    before = K.launches("mcwf")
    got, jumps = K.mcwf(*args, **kw)
    assert K.launches("mcwf") == before  # CPU tensors: the plain version
    assert got.shape == (8, 2, 2, 1 << n) and got.dtype == torch.float32
    assert jumps.dtype == torch.int32 and int(jumps.min()) >= 3
    want = _jax_k3(args, kw)
    got = got.numpy()
    assert np.abs(got - want).max() <= STATE_TOL
    assert _final_infidelity(got, want).max() <= FIDELITY_TOL


def _lab_case(n, n_traj, seed):
    rng = np.random.default_rng(seed)
    knots, amp, det = _coeffs(rng, n, n_traj)
    jplans, tplans = _plans(knots, amp, det, max_step=1e-2)
    diags = np.stack([rng.uniform(0, 5, 1 << n) for _ in range(n_traj)])
    psi0 = np.zeros(1 << n, np.complex64)
    psi0[-1] = 1.0
    common = dict(
        pairs=((1, 0, 0),),
        d=2,
        n=n,
        collapse_ops=GENERAL_COPS,
        seeds=[13 * (t + 1) + seed for t in range(n_traj)],
        dtype=np.complex64,
        ip=False,
    )
    return jplans, tplans, diags, psi0, common


@pytest.mark.parametrize("jax_route", ["xla_scan", "pallas_interpret"])
@pytest.mark.parametrize("n, seed", [(4, 21), (6, 22)])
def test_lab_frame_solve_matches_jax(monkeypatch, jax_route, n, seed):
    """The port's lab-frame quantum-jump solve against the JAX package's,
    on its default vmapped XLA scan and on K3 in interpret mode: 1 − F
    ≤ 1e-6 for every trajectory at every evaluation time (float32 over
    200 steps; no jump record differs at these sizes)."""
    if jax_route == "pallas_interpret":
        monkeypatch.setenv("PULSER_TPU_PALLAS_INTERPRET", "1")
    n_traj = 4
    jplans, tplans, diags, psi0, common = _lab_case(n, n_traj, seed)
    with _jax_f32():
        want = jax_solver.mcsolve_rk4_batched(
            psi0, jplans, diags, mesh=None, **common
        )
    if jax_route == "xla_scan":
        assert jax_solver.last_solve_info["kind"] == "mcwf_batched"
    got = torch_solver.mcsolve_rk4_batched(
        psi0, tplans, diags, device="cpu", **common
    )
    info = torch_solver.last_solve_info
    assert info["kind"] == "mcwf_torch" and info["n_cops"] == 4
    assert got.shape == want.shape == (n_traj, 3, 1 << n)
    ov = np.abs(np.sum(np.conj(want) * got, axis=-1)) ** 2
    norms = np.linalg.norm(want, axis=-1) * np.linalg.norm(got, axis=-1)
    assert (1 - ov / norms**2).max() <= FIDELITY_TOL
    # Jumps fired in every trajectory
    args, kw = torch_solver.mcwf_kernel_inputs(
        psi0, tplans, diags, GENERAL_COPS, common["seeds"], "cpu"
    )
    _, jumps = K.mcwf_reference(*args, **kw)
    assert int(jumps.min()) >= 1
