"""The port's quantum-jump scan against pulser_tpu's, on the CPU.

The same numpy inputs, made from a seed, go through the JAX package's
functions (double precision, as the test configuration sets it) and the
port's torch loops:

- ``mcsolve_rk4``, the serial solve of ``ntraj`` trajectories averaged
  into density matrices, in the lab frame (with the XY term and
  ``int_w``) and in the interaction picture: complex128 within 1e-10;
  complex64 within 1e-5 against the JAX package in single precision
  (the same float32 threefry draws);
- one trajectory of the serial solve equals the batched solve's on the
  same seed (the key derivations agree), and splitting the trajectories
  into device calls never changes the result;
- ``mcsolve_rk4_batched`` on the torch scan under relaxation at n = 4–6
  (``tests/test_torch_mcwf.py::test_solver_refuses_outside_the_gate``
  holds the 14-atom, float64, list-of-plans and qutrit cases);
- emulator runs whose seeded counts equal the JAX package's: relaxation
  with doppler and SPAM (the batched scan), depolarizing with SPAM (the
  serial solve per trajectory), and ``Solver.MCSOLVER`` without
  shot-to-shot noise.
"""

from __future__ import annotations

import contextlib
import warnings

import numpy as np
import pytest
import torch

import jax
import pulser_tpu as tpu
from pulser_tpu.emulator import TpuEmulator
from pulser_tpu.emulator.simulation import Solver as JaxSolver
from pulser_tpu.ops import solver as jax_solver

from pulser_tpu_torch.emulator import Solver
from pulser_tpu_torch.interop import (
    from_jax_device,
    from_jax_noise_model,
    from_jax_register,
    from_jax_samples,
)
from pulser_tpu_torch.emulator import TorchEmulator
from pulser_tpu_torch.ops import solver as torch_solver

torch.set_num_threads(1)

PAIRS = ((1, 0, 0),)
#: Relaxation (a single matrix unit) and dephasing, strong enough that
#: every trajectory jumps within the solve.
IP_COPS = [
    np.sqrt(3.0) * np.array([[0, 0], [1, 0]], complex),
    np.sqrt(1.5) * np.diag([1.0, -1.0]).astype(complex),
]
#: A depolarizing channel (X, Y, Z): the lab frame only.
LAB_COPS = [
    np.sqrt(1.2) * np.array(p, complex)
    for p in ([[0, 1], [1, 0]], [[0, -1j], [1j, 0]], [[1, 0], [0, -1]])
]
TOL = {np.complex128: 1e-10, np.complex64: 1e-5}


@pytest.fixture
def f64():
    """The port's emulator in double precision (complex128 states)."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(old)


@contextlib.contextmanager
def _jax_precision(dtype):
    """The JAX package in the precision of ``dtype`` (the suite runs it
    in double precision)."""
    jax.config.update("jax_enable_x64", dtype == np.complex128)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", True)


def _drive(n, knots, seed, n_traj=None):
    """Time-dependent complex drives and real detunings, ``(1, n, K)``
    (``(B, 1, n, K)`` with ``n_traj``)."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, len(knots))
    lead = (n_traj,) if n_traj else ()
    amp = (2.5 * np.sin(np.pi * t) + 0.5) * np.exp(
        1j * (0.4 * t + rng.uniform(0, 1, lead + (1, n, 1)))
    )
    det = 2.0 * np.cos(np.pi * t) * rng.uniform(0.5, 1.5, lead + (1, n, 1))
    return amp, det


def _serial_case(frame, n=3, seed=2):
    """``(psi0, jax plan, port plan, diag, cops, kw)`` for ``frame``."""
    d, dim = 2, 2**n
    knots = np.linspace(0, 0.15, 151)
    amp, det = _drive(n, knots, seed)
    coeffs = {"amp": amp, "det": det}
    rng = np.random.default_rng(seed)
    diag = rng.uniform(0, 25, dim)
    kw: dict = {"ip": frame == "ip"}
    cops = IP_COPS if frame == "ip" else LAB_COPS
    if frame == "lab_xy":
        t = np.linspace(0, 1, len(knots))
        coeffs["int_w"] = np.stack([1 - t, t])
        diag = np.stack([diag, rng.uniform(0, 25, dim)])
        u = rng.normal(size=(2, n, n)) * 3
        u = u + u.transpose(0, 2, 1)
        for k in range(2):
            np.fill_diagonal(u[k], 0.0)
        kw.update(xy_static=u, xy_indices=(1, 0))
    step = 5e-3 if frame == "ip" else 1e-3
    args = (knots, coeffs, np.array([0.07, 0.15]))
    jplan = jax_solver.build_plan(*args, max_step=step, coarsen=kw["ip"])
    tplan = torch_solver.build_plan(*args, max_step=step, coarsen=kw["ip"])
    psi0 = np.zeros(dim, complex)
    psi0[-1] = 1.0
    return psi0, jplan, tplan, diag, cops, kw


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64],
                         ids=["c128", "c64"])
@pytest.mark.parametrize("frame", ["lab", "lab_xy", "ip"])
def test_mcsolve_rk4_matches(frame, dtype, monkeypatch):
    """The averaged density matrices, and each trajectory's normalized
    states at the segment ends (recorded from both packages' trajectory
    bodies), agree."""
    psi0, jplan, tplan, diag, cops, kw = _serial_case(frame)
    args = (psi0.astype(dtype), diag, PAIRS, 2, 3, cops)
    traj = {}
    j_scan, t_states = jax_solver._mcsolve_scan, torch_solver._mcwf_traj_states

    def j_record(*a, **k):
        # The JAX trajectory body on the scan's own arguments (the
        # arguments before the weights)
        states = np.asarray(jax_solver._mcwf_traj_states(*a[:13], **k))
        traj["jax"] = states[:, :, 0] + 1j * states[:, :, 1]
        return j_scan(*a, **k)

    def t_record(*a, **k):
        traj["port"] = t_states(*a, **k).numpy()
        return torch.from_numpy(traj["port"])

    monkeypatch.setattr(jax_solver, "_mcsolve_scan", j_record)
    monkeypatch.setattr(torch_solver, "_mcwf_traj_states", t_record)
    with _jax_precision(dtype):
        want = jax_solver.mcsolve_rk4(
            args[0], jplan, *args[1:], ntraj=6, seed=21, dtype=dtype, **kw
        )
    got = torch_solver.mcsolve_rk4(
        args[0], tplan, *args[1:], ntraj=6, seed=21, dtype=dtype,
        device="cpu", **kw,
    )
    assert traj["port"].shape == traj["jax"].shape == (6, 2, 8)
    np.testing.assert_allclose(
        traj["port"], traj["jax"], rtol=0, atol=TOL[dtype]
    )
    info = torch_solver.last_solve_info
    assert info["kind"] == "mcwf_serial_torch" and info["ip"] == kw["ip"]
    assert got.shape == want.shape == (2, 8, 8) and got.dtype == dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype])
    # Jumps fired: the averaged final state is mixed
    assert np.trace(got[-1] @ got[-1]).real < 0.95
    np.testing.assert_allclose(np.trace(got, axis1=1, axis2=2), 1, atol=1e-5)


def test_serial_trajectory_is_the_batched_one():
    """The serial solve's trajectory ``split(PRNGKey(s), 1)[0]`` is the
    batched solve's trajectory on seed ``s``; splitting the serial solve
    into device calls of two trajectories changes nothing."""
    psi0, _, tplan, diag, cops, kw = _serial_case("ip")
    plans = torch_solver.build_plan_batched(
        tplan.knots,
        {"amp": np.stack([_drive(3, tplan.knots, 2)[0]] * 2),
         "det": np.stack([_drive(3, tplan.knots, 2)[1]] * 2)},
        np.array([0.07, 0.15]), max_step=5e-3, coarsen=True,
    )
    common = dict(dtype=np.complex128, device="cpu", ip=True)
    states = torch_solver.mcsolve_rk4_batched(
        psi0, plans, np.stack([diag] * 2), PAIRS, 2, 3, cops, [31, 32],
        **common,
    )
    for b, seed in enumerate((31, 32)):
        rho = torch_solver.mcsolve_rk4(
            psi0, tplan, diag, PAIRS, 2, 3, cops, ntraj=1, seed=seed, **common
        )
        np.testing.assert_allclose(
            rho, np.einsum("ea,eb->eab", states[b], states[b].conj()),
            rtol=0, atol=1e-12,
        )
    whole = torch_solver.mcsolve_rk4(
        psi0, tplan, diag, PAIRS, 2, 3, cops, ntraj=5, seed=4, **common
    )
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch_solver, "_chunk_trajectories", lambda *a: 2)
        split = torch_solver.mcsolve_rk4(
            psi0, tplan, diag, PAIRS, 2, 3, cops, ntraj=5, seed=4, **common
        )
    assert torch_solver.last_solve_info["traj_per_call"] == 2
    np.testing.assert_allclose(split, whole, rtol=0, atol=1e-13)


@pytest.mark.parametrize("n", [4, 5, 6])
def test_batched_scan_under_relaxation_matches(n):
    """Relaxation on the interaction-picture grid: the torch scan, each
    trajectory within 1e-10 of the JAX package's vmapped scan."""
    knots = np.linspace(0, 0.2, 81)
    amp, det = _drive(n, knots, n, n_traj=3)
    kw = dict(max_step=5e-3, host_stage=False, coarsen=True)
    jplans, tplans = (
        mod.build_plan_batched(
            knots, {"amp": amp, "det": det}, np.array([0.1, 0.2]), **kw
        )
        for mod in (jax_solver, torch_solver)
    )
    diags = np.random.default_rng(n).uniform(0, 20, (3, 2**n))
    psi0 = np.zeros(2**n, complex)
    psi0[-1] = 1.0
    common = dict(dtype=np.complex128, ip=True)
    args = (psi0, diags, PAIRS, 2, n, IP_COPS, [7, 8, 9])
    want = jax_solver.mcsolve_rk4_batched(
        psi0, jplans, *args[1:], mesh=None, **common
    )
    got = torch_solver.mcsolve_rk4_batched(
        psi0, tplans, *args[1:], device="cpu", **common
    )
    assert torch_solver.last_solve_info["kind"] == "mcwf_batched_torch"
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


# -- the emulator ---------------------------------------------------------


def _sequence():
    reg = tpu.Register.rectangle(1, 3, spacing=7.0, prefix="q")
    seq = tpu.Sequence(reg, tpu.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(tpu.Pulse.ConstantPulse(200, 2 * np.pi, -1.0, 0.0), "ryd")
    return seq


def _noise(**params):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)  # runs=
        return tpu.NoiseModel(**params)


def _both_counts(seq, noise, seed, **kw):
    """``(JAX counts, port counts)`` of seeded runs, and the next draw of
    the numpy global RNG after each (equal when both consumed it alike)."""
    out = []
    for port in (False, True):
        np.random.seed(seed)
        if port:
            emu = TorchEmulator(
                from_jax_samples(tpu.sampler.sample(seq)),
                from_jax_register(seq.register),
                from_jax_device(seq.device),
                noise_model=from_jax_noise_model(noise),
                evaluation_times="Minimal",
                torch_device="cpu",
                **{k: getattr(Solver, v.name) if k == "solver" else v
                   for k, v in kw.items()},
            )
        else:
            emu = TpuEmulator.from_sequence(
                seq, noise_model=noise, evaluation_times="Minimal", **kw
            )
        res = emu.run()
        if "solver" in kw:  # no shot-to-shot noise: sample the final ρ
            counts = [dict(res.sample_final_state(50))]
        else:
            counts = [dict(r.bitstring_counts) for r in res]
        out.append((counts, np.random.rand()))
    (jc, jnext), (tc, tnext) = out
    assert tnext == jnext
    return jc, tc


@pytest.mark.parametrize(
    "params, kw, kind",
    [
        (
            dict(relaxation_rate=1.0, temperature=40, state_prep_error=0.05,
                 p_false_pos=0.02, runs=5, samples_per_run=6),
            {},
            "mcwf_batched_torch",
        ),
        (
            dict(depolarizing_rate=1.0, state_prep_error=0.05,
                 p_false_neg=0.03, runs=4, samples_per_run=6),
            {},
            "mcwf_serial_torch",
        ),
        (
            dict(dephasing_rate=1.0, relaxation_rate=0.5),
            dict(solver=JaxSolver.MCSOLVER, n_trajectories=6),
            "mcwf_serial_torch",
        ),
    ],
    ids=["relaxation_doppler_spam", "depolarizing_spam", "mcsolver_no_noise"],
)
def test_emulator_counts_match(f64, params, kw, kind):
    jc, tc = _both_counts(_sequence(), _noise(**params), 6, **kw)
    assert torch_solver.last_solve_info["kind"] == kind
    assert tc == jc
    assert all(sum(c.values()) > 0 for c in tc)
