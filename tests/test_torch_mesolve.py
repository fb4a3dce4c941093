"""The port's Lindblad master equation against pulser_tpu's, on the CPU.

The same numpy inputs, made from a seed, go through the JAX package's
functions (double precision, as the test configuration sets it) and the
port's:

- the density-matrix applies and the collapse algebra, to 1e-12;
- ``mesolve_rk4`` in the lab frame and the interaction picture, with and
  without collapse operators, with interaction interpolation (``int_w``),
  from a dense ρ0 or the ``("pure", ψ)`` sentinel: complex128 within
  1e-10 and complex64 within 1e-5 of the JAX figures, elementwise;
- ``mesolve_rk4_batched`` per trajectory, in both frames;
- ``TorchEmulator(...).run()`` against ``TpuEmulator.from_sequence(...)
  .run()`` under dephasing alone, relaxation alone, depolarizing alone,
  a density-matrix initial state, and ``Solver.MESOLVER`` under
  shot-to-shot noise (the seeded counts equal, the RNG stream left at the
  same point);
- the ``lindblad_dephasing`` golden at the JAX test's bound;
- the XY term with collapse operators and the serial quantum-jump solve
  without shot-to-shot noise, against the JAX package;
- the refusal that remains (sharding over devices).
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import pytest
import torch

import pulser_tpu as tpu
from pulser_tpu.emulator import TpuEmulator
from pulser_tpu.emulator.simulation import Solver as JaxSolver
from pulser_tpu.ops import apply as jax_apply
from pulser_tpu.ops import solver as jax_solver

from pulser_tpu_torch.emulator import Solver, TorchEmulator
from pulser_tpu_torch.emulator import simulation as torch_sim
from pulser_tpu_torch.interop import (
    from_jax_device,
    from_jax_noise_model,
    from_jax_register,
    from_jax_samples,
)
from pulser_tpu_torch.ops import apply as torch_apply
from pulser_tpu_torch.ops import solver as torch_solver
from pulser_tpu_torch.parallel import capacity

from torch_parity import StubMesh

torch.set_num_threads(1)

TOL = {np.complex128: 1e-10, np.complex64: 1e-5}
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
PAIRS = ((1, 0, 0),)
DIAG_COPS = [
    np.sqrt(0.8) * np.array([[1, 0], [0, 0]], complex),
    np.sqrt(0.3) * np.diag([1.0, -1.0]).astype(complex),
]
#: Relaxation, a Pauli X and a general operator whose L†L is not
#: diagonal (the anticommutator's static group products run).
GENERAL_COPS = [
    np.sqrt(0.5) * np.array([[0, 1], [0, 0]], complex),
    np.sqrt(0.2) * np.array([[0, 1], [1, 0]], complex),
    np.sqrt(0.1) * np.array([[1, 0.3j], [0.2, -1]], complex),
]


@pytest.fixture
def f64():
    """The port's emulator in double precision (complex128 states)."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(old)


def _rho(dim, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(dim, dim)) + 1j * rng.normal(size=(dim, dim))
    rho = x @ x.conj().T
    return rho / np.trace(rho)


def _drive(n, k, seed, nb=1):
    """Time-dependent complex drives and detunings, ``(nb, n, k)``."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, k)
    amp = (
        (3.0 * np.sin(np.pi * t) + 1.0)
        * np.exp(1j * (0.7 * t + rng.uniform(0, 1, (nb, n, 1))))
        * rng.uniform(0.5, 1.5, (nb, n, 1))
    )
    det = 2.0 * np.cos(np.pi * t) * rng.uniform(0.5, 1.5, (nb, n, 1))
    return amp, det


# -- the density-matrix applies and the collapse algebra ------------------


@pytest.mark.parametrize("side", ["row", "col"])
@pytest.mark.parametrize("d, n, q", [(2, 3, 0), (2, 3, 2), (3, 2, 1)])
def test_density_matrix_applies_match(side, d, n, q):
    rng = np.random.default_rng(q + 10 * n)
    op = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    rho = _rho(d**n, 1)
    j_fn = getattr(jax_apply, f"apply_{side}_c")
    t_fn = getattr(torch_apply, f"apply_{side}_c")
    rho2 = np.stack([rho.real, rho.imag])
    want = np.asarray(j_fn(op.real, op.imag, rho2, q, d, n))
    got = t_fn(torch.from_numpy(op), torch.from_numpy(rho), q, d, n).numpy()
    np.testing.assert_allclose(got, want[0] + 1j * want[1], atol=1e-12)
    # and the plain definition: op on qudit q of the row (column) index
    full = np.kron(np.kron(np.eye(d**q), op), np.eye(d ** (n - q - 1)))
    ref = full @ rho if side == "row" else rho @ full
    np.testing.assert_allclose(got, ref, atol=1e-12)


@pytest.mark.parametrize(
    "d, n, ops",
    [
        (2, 3, DIAG_COPS),
        (2, 4, GENERAL_COPS),
        (3, 2, [np.diag([0.3, 1.0, 0.5j]), np.eye(3, k=1) * 0.7]),
    ],
    ids=["diagonal", "general", "qutrit"],
)
def test_collapse_algebra_matches(d, n, ops):
    j = jax_solver._collapse_algebra(ops, d, n, np.float64)
    cdc_pair, lrl_idx, lrl_coef, mask_pair, has_mask, has_cops = j
    t = torch_solver._collapse_algebra(ops, d, n, torch.complex128, "cpu")
    assert t.lrl_idx == lrl_idx
    np.testing.assert_allclose(
        np.asarray(t.lrl_coef),
        np.asarray(lrl_coef)[:, 0] + 1j * np.asarray(lrl_coef)[:, 1],
        atol=1e-12,
    )
    np.testing.assert_allclose(
        t.cdc_sum.numpy(),
        np.asarray(cdc_pair[0]) + 1j * np.asarray(cdc_pair[1]),
        atol=1e-12,
    )
    assert (t.diag_mask is not None) == has_mask
    want = np.asarray(mask_pair[0]) + 1j * np.asarray(mask_pair[1])
    if has_mask:
        np.testing.assert_allclose(t.diag_mask.numpy(), want, atol=1e-12)
    assert has_cops
    rho = _rho(d**n, 2)
    np.testing.assert_allclose(
        torch_solver._dag2(torch.from_numpy(rho)).resolve_conj().numpy(),
        rho.conj().T,
    )


# -- mesolve_rk4 ----------------------------------------------------------


def _single_case(case, seed=5):
    """``(rho0, jax plan, port plan, diag, cops, kw)`` on 3 qubits, about
    two hundred steps."""
    n, d = 3, 2
    dim = d**n
    knots = np.linspace(0, 0.2, 201)
    amp, det = _drive(n, len(knots), seed)
    coeffs = {"amp": amp, "det": det}
    rng = np.random.default_rng(seed)
    diag = rng.uniform(0, 40, size=dim)
    kw = {}
    if case.get("int_w"):
        t = np.linspace(0, 1, len(knots))
        coeffs["int_w"] = np.stack([1 - t, t])
        diag = np.stack([diag, rng.uniform(0, 40, size=dim)])
    psi = rng.normal(size=dim) + 1j * rng.normal(size=dim)
    psi /= np.linalg.norm(psi)
    rho0 = ("pure", psi) if case.get("pure") else _rho(dim, seed)
    evals = np.array([0.05, 0.1234, 0.2])
    step = 4e-3 if case.get("ip") else 1e-3
    jplan = jax_solver.build_plan(knots, coeffs, evals, max_step=step,
                                  coarsen=bool(case.get("ip")))
    tplan = torch_solver.build_plan(knots, coeffs, evals, max_step=step,
                                    coarsen=bool(case.get("ip")))
    kw["ip"] = bool(case.get("ip"))
    return rho0, jplan, tplan, diag, case.get("cops", []), kw


SINGLE_CASES = {
    "lab_no_cops": {},
    "lab_diagonal": {"cops": DIAG_COPS},
    "lab_general": {"cops": GENERAL_COPS},
    "lab_int_w": {"cops": GENERAL_COPS, "int_w": True},
    "lab_pure": {"cops": GENERAL_COPS, "pure": True},
    "ip_no_cops": {"ip": True},
    "ip_diagonal": {"ip": True, "cops": DIAG_COPS},
    "ip_pure": {"ip": True, "cops": DIAG_COPS, "pure": True},
}


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64],
                         ids=["c128", "c64"])
@pytest.mark.parametrize("case", list(SINGLE_CASES))
def test_mesolve_rk4_matches(case, dtype):
    rho0, jplan, tplan, diag, cops, kw = _single_case(SINGLE_CASES[case])
    want = jax_solver.mesolve_rk4(
        rho0, jplan, diag, PAIRS, 2, 3, cops, dtype=np.complex128, **kw
    )
    got = torch_solver.mesolve_rk4(
        rho0, tplan, diag, PAIRS, 2, 3, cops, dtype=dtype, device="cpu", **kw
    )
    assert got.shape == want.shape == (3, 8, 8) and got.dtype == dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype])
    info = torch_solver.last_solve_info
    assert info["kind"] == "mesolve_cpu" and info["ip"] == kw["ip"]
    lazy = torch_solver.mesolve_rk4(
        rho0, tplan, diag, PAIRS, 2, 3, cops, dtype=dtype, device="cpu",
        lazy=True, **kw,
    )
    np.testing.assert_array_equal(lazy.state(-1), got[-1])


def test_mesolve_rk4_qutrits_match():
    """Two drive bases on qutrits, general 3×3 collapse operators, in the
    lab frame."""
    n, d = 2, 3
    pairs = ((1, 0, 0), (2, 1, 2))
    knots = np.linspace(0, 0.15, 151)
    amp, det = _drive(n, len(knots), 3, nb=2)
    rng = np.random.default_rng(3)
    diag = rng.uniform(0, 30, size=d**n)
    cops = [np.diag([0.3, 1.0, 0.5j]), np.eye(3, k=1) * 0.7]
    evals = np.array([0.15])
    args = (knots, {"amp": amp, "det": det}, evals)
    jplan = jax_solver.build_plan(*args, max_step=1e-3)
    tplan = torch_solver.build_plan(*args, max_step=1e-3)
    rho0 = _rho(d**n, 4)
    want = jax_solver.mesolve_rk4(rho0, jplan, diag, pairs, d, n, cops,
                                  dtype=np.complex128)
    got = torch_solver.mesolve_rk4(rho0, tplan, diag, pairs, d, n, cops,
                                   dtype=np.complex128, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


# -- mesolve_rk4_batched --------------------------------------------------


def _batched_case(n_traj=4, n=3, seed=7, ip=False):
    k = 121
    knots = np.linspace(0, 0.12, k)
    rng = np.random.default_rng(seed)
    amps, dets = zip(*(_drive(n, k, seed + t) for t in range(n_traj)))
    coeffs = {"amp": np.stack(amps), "det": np.stack(dets)}
    diags = rng.uniform(0, 40, size=(n_traj, 2**n))
    evals = np.array([0.06, 0.12])
    step = 4e-3 if ip else 1e-3
    kw = dict(max_step=step, host_stage=False, coarsen=ip)
    jplans = jax_solver.build_plan_batched(knots, coeffs, evals, **kw)
    tplans = torch_solver.build_plan_batched(knots, coeffs, evals, **kw)
    return jplans, tplans, diags, _rho(2**n, seed)


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64],
                         ids=["c128", "c64"])
@pytest.mark.parametrize("frame", ["lab", "ip", "lab_plan_list"])
def test_mesolve_rk4_batched_matches_per_trajectory(frame, dtype):
    ip = frame == "ip"
    jplans, tplans, diags, rho0 = _batched_case(ip=ip)
    cops = DIAG_COPS if ip else GENERAL_COPS
    if frame == "lab_plan_list":
        # One host-staged plan per trajectory (the same grid)
        knots = np.linspace(0, 0.12, 121)
        plans = []
        for t in range(4):
            amp, det = _drive(3, 121, 7 + t)
            args = (knots, {"amp": amp, "det": det}, np.array([0.06, 0.12]))
            plans.append((jax_solver.build_plan(*args, max_step=1e-3),
                          torch_solver.build_plan(*args, max_step=1e-3)))
        jplans, tplans = [p[0] for p in plans], [p[1] for p in plans]
    want = jax_solver.mesolve_rk4_batched(
        rho0, jplans, diags, PAIRS, 2, 3, cops, dtype=np.complex128, ip=ip
    )
    got = torch_solver.mesolve_rk4_batched(
        rho0, tplans, diags, PAIRS, 2, 3, cops, dtype=dtype, ip=ip,
        device="cpu",
    )
    assert got.shape == want.shape == (4, 2, 8, 8) and got.dtype == dtype
    for t in range(4):
        np.testing.assert_allclose(got[t], want[t], rtol=0, atol=TOL[dtype])
    info = torch_solver.last_solve_info
    assert info["kind"] == "mesolve_batched_cpu" and info["n_traj"] == 4


def test_mesolve_rk4_batched_splits_trajectories(monkeypatch):
    """Device calls of fewer trajectories than the batch give the same
    states, trajectory for trajectory."""
    _, tplans, diags, rho0 = _batched_case(n_traj=5, ip=True)
    args = (rho0, tplans, diags, PAIRS, 2, 3, DIAG_COPS)
    kw = dict(dtype=np.complex128, ip=True, device="cpu")
    whole = torch_solver.mesolve_rk4_batched(*args, **kw)
    monkeypatch.setattr(torch_solver, "_chunk_trajectories", lambda *a: 2)
    split = torch_solver.mesolve_rk4_batched(*args, **kw)
    assert torch_solver.last_solve_info["traj_per_call"] == 2
    np.testing.assert_allclose(split, whole, rtol=0, atol=1e-13)


# -- the emulator ---------------------------------------------------------


def _sequence(shape=(1, 3)):
    reg = tpu.Register.rectangle(*shape, spacing=7.0, prefix="q")
    seq = tpu.Sequence(reg, tpu.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    om = 2 * np.pi * 1.5
    seq.add(
        tpu.Pulse.ConstantDetuning(
            tpu.RampWaveform(200, 0.0, om), -2 * np.pi, 0.0
        ),
        "ryd",
    )
    seq.add(
        tpu.Pulse.ConstantAmplitude(
            om, tpu.RampWaveform(200, -2 * np.pi, 2 * np.pi), 0.3
        ),
        "ryd",
    )
    return seq


def _noise(**params):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)  # runs=
        return tpu.NoiseModel(**params)


def _port(seq, noise=None, **kw):
    return TorchEmulator(
        from_jax_samples(tpu.sampler.sample(seq)),
        from_jax_register(seq.register),
        from_jax_device(seq.device),
        noise_model=from_jax_noise_model(noise or tpu.NoiseModel()),
        torch_device="cpu",
        **kw,
    )


def _final_states(res):
    return np.stack([s.full() for s in res.states])


@pytest.mark.parametrize(
    "params, ip",
    [
        (dict(dephasing_rate=0.3), True),
        (dict(relaxation_rate=0.4), False),
        (dict(depolarizing_rate=0.2), False),
    ],
    ids=["dephasing", "relaxation", "depolarizing"],
)
def test_collapse_operators_alone_run_the_master_equation(f64, params, ip):
    """No shot-to-shot noise: one master-equation solve, every evaluation
    state within 1e-10 of the JAX package's."""
    seq, noise = _sequence(), _noise(**params)
    np.random.seed(3)
    jres = TpuEmulator.from_sequence(seq, noise_model=noise).run()
    np.random.seed(3)
    tres = _port(seq, noise).run()
    info = torch_solver.last_solve_info
    assert info["kind"] == "mesolve_cpu" and info["ip"] is ip
    want, got = _final_states(jres), _final_states(tres)
    assert got.shape == want.shape and got.shape[1:] == (8, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    np.testing.assert_allclose(
        tres.expect([np.diag([1.0] * 4 + [0.0] * 4)])[0],
        jres.expect([np.diag([1.0] * 4 + [0.0] * 4)])[0],
        atol=1e-10,
    )


def test_density_matrix_initial_state(f64):
    """A density-matrix input runs the master equation without noise."""
    seq = _sequence()
    rho = _rho(8, 6)
    jemu = TpuEmulator.from_sequence(seq)
    jemu.set_initial_state(rho)
    temu = _port(seq)
    temu.set_initial_state(rho)
    assert not temu.initial_state.isket and temu.initial_state.isoper
    want, got = _final_states(jemu.run()), _final_states(temu.run())
    assert torch_solver.last_solve_info["kind"] == "mesolve_cpu"
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    final = temu.run().get_final_state()
    assert abs(final.tr() - 1) < 1e-9


STOCHASTIC = dict(
    dephasing_rate=0.2,
    amp_sigma=0.05,
    temperature=40,
    state_prep_error=0.05,
    p_false_pos=0.01,
    p_false_neg=0.02,
    runs=5,
    samples_per_run=7,
)


def _seeded_counts(seq, noise, seed, rho=None, **kw):
    """``(JAX counts, port counts, JAX next draw, port next draw)``."""
    out = []
    pairs = ((TpuEmulator.from_sequence, JaxSolver), (None, Solver))
    for make, solver in pairs:
        np.random.seed(seed)
        if make is None:
            emu = _port(seq, noise, solver=solver.MESOLVER, **kw)
        else:
            emu = make(seq, noise_model=noise, solver=solver.MESOLVER, **kw)
        if rho is not None:
            emu.set_initial_state(rho)
        res = emu.run()
        out.append(([dict(r.bitstring_counts) for r in res], np.random.rand()))
    (jc, jnext), (tc, tnext) = out
    return jc, tc, jnext, tnext


def test_master_equation_solver_under_stochastic_noise(f64):
    """``Solver.MESOLVER`` with shot-to-shot noise: one density matrix
    per trajectory in one batched solve, the counts sampled on the host
    from the numpy global RNG in the JAX package's order."""
    seq = _sequence()
    jc, tc, jnext, tnext = _seeded_counts(
        seq, _noise(**STOCHASTIC), 9, evaluation_times="Minimal"
    )
    info = torch_solver.last_solve_info
    assert info["kind"] == "mesolve_batched_cpu" and info["ip"] is True
    assert tc == jc and tnext == jnext
    assert [sum(c.values()) for c in tc] == [35, 35]


def test_density_matrix_under_stochastic_noise(f64):
    """A density-matrix input under shot-to-shot noise: one master-
    equation solve per trajectory, sampled per trajectory."""
    seq = _sequence()
    noise = _noise(**{k: v for k, v in STOCHASTIC.items()
                      if k != "state_prep_error"})
    jc, tc, jnext, tnext = _seeded_counts(
        seq, noise, 4, rho=_rho(8, 8), evaluation_times="Minimal"
    )
    assert torch_solver.last_solve_info["kind"] == "mesolve_cpu"
    assert tc == jc and tnext == jnext


def test_dissipative_batch_quantum_jump_branch():
    """``_noisy_runs_batched_lindblad`` under the quantum-jump solver: one
    normalized ket per trajectory and evaluation time, through
    ``mcsolve_rk4_batched`` (the rows route), the trajectory seeds drawn
    from the numpy global RNG as the JAX package draws them."""
    seq = _sequence((2, 2))
    noise = _noise(dephasing_rate=0.2, amp_sigma=0.05, temperature=40,
                   runs=3, samples_per_run=2)
    out = []
    for make in (TpuEmulator.from_sequence, None):
        np.random.seed(5)
        if make is None:
            emu = _port(seq, noise, evaluation_times="Minimal")
        else:
            emu = make(seq, noise_model=noise, evaluation_times="Minimal")
        runs = list(emu._noisy_runs_batched_lindblad())
        out.append((runs, np.random.rand()))
    (jruns, jnext), (truns, tnext) = out
    assert torch_solver.last_solve_info["kind"] == "mcwf_rows_torch"
    assert tnext == jnext
    assert [r for _, r in truns] == [r for _, r in jruns]
    for res, _ in truns:
        for state in res.states:
            assert state.isket and abs(state.norm() - 1) < 1e-5


def test_lindblad_dephasing_golden(f64):
    """The DOP853 golden of ``tests/test_goldens.py`` at its bound."""
    data = np.load(os.path.join(GOLDENS, "lindblad_dephasing.npz"))
    reg = tpu.Register({"q0": (-3.0, 0.0), "q1": (3.0, 0.0)})
    seq = tpu.Sequence(reg, tpu.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(tpu.Pulse.ConstantPulse(800, 2 * np.pi, -1.0, 0.0), "ryd")
    emu = _port(
        seq,
        tpu.NoiseModel(dephasing_rate=float(data["rate"])),
        solver=Solver.MESOLVER,
    )
    rho = emu.run().get_final_state().full()
    golden = data["states"][-1].reshape(rho.shape)
    bound = 0.5 * np.sum(np.abs(np.linalg.eigvalsh(golden - rho)))
    assert bound < 1e-6


# -- what stays refused ---------------------------------------------------


def _xy_sequence(P, shape=(1, 3)):
    """An XY chain under the ``mw_global`` channel, built with ``P``."""
    reg = P.Register.rectangle(*shape, spacing=8.0, prefix="a")
    seq = P.Sequence(reg, P.MockDevice)
    seq.declare_channel("mw", "mw_global")
    seq.add(P.Pulse.ConstantPulse(150, 2.0, 0.0, 0.0), "mw")
    return seq


def test_xy_with_collapse_operators_raises(f64):
    """The XY term with collapse operators runs the lab-frame master
    equation, every evaluation state within 1e-10 of the JAX package's,
    through the emulator and through ``mesolve_rk4`` with an XY term."""
    seq = _xy_sequence(tpu)
    noise = tpu.NoiseModel(dephasing_rate=0.3)
    jres = TpuEmulator.from_sequence(seq, noise_model=noise).run()
    tres = _port(seq, noise).run()
    info = torch_solver.last_solve_info
    assert info["kind"] == "mesolve_cpu" and info["ip"] is False
    np.testing.assert_allclose(
        _final_states(tres), _final_states(jres), rtol=0, atol=1e-10
    )
    rho0, jplan, tplan, diag, cops, _ = _single_case({"cops": DIAG_COPS})
    u = np.random.default_rng(2).normal(size=(1, 3, 3))
    u = u + u.transpose(0, 2, 1)
    u[0][np.diag_indices(3)] = 0.0
    kw = dict(xy_static=u, xy_indices=(1, 0), dtype=np.complex128)
    want = jax_solver.mesolve_rk4(rho0, jplan, diag, PAIRS, 2, 3, cops, **kw)
    got = torch_solver.mesolve_rk4(
        rho0, tplan, diag, PAIRS, 2, 3, cops, device="cpu", **kw
    )
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_quantum_jumps_without_shot_to_shot_noise_raise(f64):
    """``Solver.MCSOLVER`` without shot-to-shot noise runs the serial
    quantum-jump solve in the lab frame under depolarizing noise: the
    averaged density matrices equal the JAX package's on the same seed."""
    seq = _sequence()
    out = []
    for make, solver in ((TpuEmulator.from_sequence, JaxSolver), (None, Solver)):
        np.random.seed(12)
        nm = tpu.NoiseModel(depolarizing_rate=1.5)
        kw = dict(solver=solver.MCSOLVER, n_trajectories=4)
        emu = _port(seq, nm, **kw) if make is None else make(
            seq, noise_model=nm, **kw
        )
        out.append(_final_states(emu.run()))
    info = torch_solver.last_solve_info
    assert info["kind"] == "mcwf_serial_torch" and info["ip"] is False
    assert info["n_traj"] == 4 and info["n_cops"] == 3
    np.testing.assert_allclose(out[1], out[0], rtol=0, atol=1e-10)


def test_sharding_raises():
    """The JAX package's refusal of a row-sharded ρ whose rank count does
    not divide ``d**n`` (8 rows over 3 ranks), in both packages
    (``tests/test_parallel.py::test_mesolve_rho_sharded_rejects_bad_mesh``;
    the sharded solves themselves run in ``test_torch_parallel_*.py``)."""
    import jax
    from jax.sharding import Mesh

    rho0, jplan, tplan, diag, cops, _ = _single_case({"cops": DIAG_COPS})
    match = "cannot shard a dim-8 density matrix over 3 devices"
    with pytest.raises(ValueError, match=match):
        torch_solver.mesolve_rk4(rho0, tplan, diag, PAIRS, 2, 3, cops,
                                 state_mesh=StubMesh(3), device="cpu")
    mesh = Mesh(np.array(jax.devices()[:3]), axis_names=("state",))
    with pytest.raises(ValueError, match=match):
        jax_solver.mesolve_rk4(rho0, jplan, diag, PAIRS, 2, 3, cops,
                               state_mesh=mesh)


# -- the capacity contract ------------------------------------------------


def test_capacity_contract(monkeypatch):
    """No measured memory on the CPU: no check. With a measured 1 GiB,
    a 12-atom density matrix raises with the modeled ceiling; the
    emulator checks before its master-equation solve."""
    assert capacity.measured_memory_bytes("cpu") is None
    capacity.check_capacity(2, 14, density_matrix=True)  # CPU: no-op
    report = capacity.capacity_report("cpu")
    assert report["memory_bytes"] == capacity.H100_MEMORY_BYTES
    ceilings = report["ceilings"]
    assert ceilings[2] > ceilings[3] > ceilings[4]
    monkeypatch.setattr(capacity, "measured_memory_bytes", lambda *a: 1 << 30)
    capacity.check_capacity(2, 6, density_matrix=True)
    with pytest.raises(capacity.CapacityError, match="n=12, d=2 density"):
        capacity.check_capacity(2, 12, density_matrix=True, what="x")
    calls = []
    monkeypatch.setattr(
        torch_sim, "check_capacity", lambda *a, **k: calls.append((a, k))
    )
    _port(_sequence(), tpu.NoiseModel(dephasing_rate=0.1)).run()
    assert calls and calls[0][1]["density_matrix"] is True
