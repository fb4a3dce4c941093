"""The port's XY mode against pulser_tpu's, on the CPU.

The same numpy inputs, made from a seed, go through the JAX package's
functions (double precision, as the test configuration sets it) and the
port's:

- the flip-flop term ``apply_flip_flop_r`` (on a state, a batch, and the
  row index of a density matrix) and ``H·ψ`` with the XY term, in
  complex128 within 1e-12;
- the lab-frame ``sesolve_rk4`` with ``(1, N, N)`` couplings and with
  ``(2, N, N)`` couplings interpolated by ``int_w``: complex128 within
  1e-10, complex64 within 1 − F ≤ 1e-6;
- ``TorchEmulator.from_sequence`` on the ``xy_chain`` golden (1 − F ≤
  1e-6), and an XY sequence with an SLM mask written once for both
  packages, whose states equal ``pulser_tpu``'s (results API included:
  expectation values, sampling in the XY basis, the final state);
- XY with SPAM (one lab-frame sesolve per trajectory) and with SPAM and
  dephasing (one quantum-jump solve per trajectory): the seeded counts
  equal ``pulser_tpu``'s;
- the XY term under the master equation, against the JAX package.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import pytest
import torch

import pulser_tpu as tpu
from pulser_tpu.emulator import TpuEmulator
from pulser_tpu.ops import apply as jax_apply
from pulser_tpu.ops import solver as jax_solver

import chip_smoke
import pulser_tpu_torch as ptt
from pulser_tpu_torch.emulator import TorchEmulator
from pulser_tpu_torch.ops import apply as torch_apply
from pulser_tpu_torch.ops import solver as torch_solver

torch.set_num_threads(1)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.fixture
def f64():
    """The port's emulator in double precision (complex128 states)."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(old)


def _couplings(rng, n, k=1):
    """``(k, n, n)`` real symmetric couplings with a zero diagonal."""
    u = rng.normal(size=(k, n, n)) * 4
    u = u + u.transpose(0, 2, 1)
    for m in u:
        np.fill_diagonal(m, 0.0)
    return u


def _pair(x):
    return np.stack([x.real, x.imag])


def _fidelity(a, b):
    return abs(np.vdot(a / np.linalg.norm(a), b / np.linalg.norm(b))) ** 2


# -- the flip-flop term and H·ψ ------------------------------------------


@pytest.mark.parametrize(
    "d, n, up, down", [(2, 3, 0, 1), (2, 5, 1, 0), (3, 3, 0, 2), (3, 2, 2, 1)]
)
def test_flip_flop_matches(d, n, up, down):
    rng = np.random.default_rng(d * 10 + n)
    dim = d**n
    u = _couplings(rng, n)[0]
    psi = rng.normal(size=(2, dim)) + 1j * rng.normal(size=(2, dim))
    want = np.stack([
        np.asarray(jax_apply.apply_flip_flop_r(u, _pair(p), d, n, up, down))
        for p in psi
    ])
    got = torch_apply.apply_flip_flop_r(
        torch.from_numpy(u), torch.from_numpy(psi), d, n, up, down
    ).numpy()
    np.testing.assert_allclose(got, want[:, 0] + 1j * want[:, 1], atol=1e-12)
    # The row side of a density matrix: the term on each column
    rho = rng.normal(size=(dim, dim)) + 1j * rng.normal(size=(dim, dim))
    rows = torch_apply.apply_flip_flop_r(
        torch.from_numpy(u), torch.from_numpy(rho), d, n, up, down, rows=True
    ).numpy()
    cols = np.stack([
        np.asarray(jax_apply.apply_flip_flop_r(u, _pair(c), d, n, up, down))
        for c in rho.T
    ], axis=-1)
    np.testing.assert_allclose(rows, cols[0] + 1j * cols[1], atol=1e-12)


@pytest.mark.parametrize("n", [3, 6])
def test_hpsi_with_xy_matches(n):
    rng = np.random.default_rng(n)
    dim = 2**n
    pairs = ((0, 1, 1),)
    u = _couplings(rng, n)[0]
    diag = rng.uniform(0, 20, dim)
    amp = rng.normal(size=(1, n)) + 1j * rng.normal(size=(1, n))
    det = rng.normal(size=(1, n))
    psi = rng.normal(size=dim) + 1j * rng.normal(size=dim)
    want = np.asarray(
        jax_apply.hamiltonian_matvec(
            _pair(psi), diag, amp.real, amp.imag, det, pairs, 2, n, u, (0, 1)
        )
    )
    t = torch.from_numpy
    got = torch_apply.hamiltonian_matvec(
        t(psi), t(diag), t(amp), t(det), pairs, 2, n, t(u), (0, 1)
    ).numpy()
    np.testing.assert_allclose(got, want[0] + 1j * want[1], atol=1e-12)


# -- the lab-frame sesolve ------------------------------------------------


def _lab_case(n_xy, n=4, seed=3):
    """``(psi0, jax plan, port plan, diag, kw)``: time-dependent drives and
    detunings, ``n_xy`` coupling configurations (2: interpolated with a
    ramp of ``int_w``, the diagonal too)."""
    rng = np.random.default_rng(seed)
    dim = 2**n
    knots = np.linspace(0, 0.2, 201)
    t = np.linspace(0, 1, len(knots))
    amp = (2 * np.sin(np.pi * t) + 1) * np.exp(
        1j * (0.5 * t + rng.uniform(0, 1, (1, n, 1)))
    )
    det = 1.5 * np.cos(np.pi * t) * rng.uniform(0.5, 1.5, (1, n, 1))
    coeffs = {"amp": amp, "det": det}
    diag = rng.uniform(0, 20, dim)
    if n_xy == 2:
        coeffs["int_w"] = np.stack([1 - t, t])
        diag = np.stack([diag, rng.uniform(0, 20, dim)])
    args = (knots, coeffs, np.array([0.05, 0.1234, 0.2]))
    jplan = jax_solver.build_plan(*args, max_step=1e-3)
    tplan = torch_solver.build_plan(*args, max_step=1e-3)
    psi0 = rng.normal(size=dim) + 1j * rng.normal(size=dim)
    kw = dict(xy_static=_couplings(rng, n, n_xy), xy_indices=(0, 1))
    return psi0 / np.linalg.norm(psi0), jplan, tplan, diag, kw


@pytest.mark.parametrize("n_xy", [1, 2], ids=["static", "int_w"])
def test_lab_frame_sesolve_matches(n_xy):
    psi0, jplan, tplan, diag, kw = _lab_case(n_xy)
    pairs = ((0, 1, 1),)
    want = jax_solver.sesolve_rk4(
        psi0, jplan, diag, pairs, 2, 4, dtype=np.complex128, **kw
    )
    got = torch_solver.sesolve_rk4(
        psi0, tplan, diag, pairs, 2, 4, dtype=np.complex128, device="cpu",
        **kw,
    )
    info = torch_solver.last_solve_info
    assert info["kind"] == "sesolve_torch_loop" and info["ip"] is False
    assert got.shape == want.shape == (3, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    got64 = torch_solver.sesolve_rk4(
        psi0, tplan, diag, pairs, 2, 4, dtype=np.complex64, device="cpu",
        lazy=True, **kw,
    )
    for i in range(3):
        assert got64.state(i).dtype == np.complex64
        assert 1 - _fidelity(want[i], got64.state(i)) <= 1e-6


# -- the emulator ---------------------------------------------------------


def test_xy_chain_golden():
    """The DOP853 golden of ``tests/test_goldens.py`` at its bound,
    through ``TorchEmulator.from_sequence`` in the default precision."""
    reg = ptt.Register({"q0": (0.0, 0.0), "q1": (8.0, 0.0), "q2": (16.0, 0.0)})
    seq = ptt.Sequence(reg, ptt.MockDevice)
    seq.declare_channel("mw", "mw_global")
    seq.add(ptt.Pulse.ConstantPulse(400, 2 * np.pi * 0.5, 0.0, 0.0), "mw")
    seq.delay(600, "mw")
    golden = np.load(os.path.join(GOLDENS, "xy_chain.npz"))["states"][-1]
    final = (
        TorchEmulator.from_sequence(seq, torch_device="cpu")
        .run()
        .get_final_state(ignore_global_phase=False)
        .full()[:, 0]
    )
    assert torch_solver.last_solve_info["kind"] == "sesolve_torch_loop"
    assert 1 - _fidelity(golden, final) < 1e-6


def xy_slm(P):
    """An XY sequence with an SLM mask, written once for both packages
    (the pattern of ``tests/test_torch_sequence.py::SCENARIOS``): a 2x2
    square at 9 µm, a field along z, the mask on one diagonal, a shaped
    pulse the mask holds off it, then free exchange with a phase."""
    reg = P.Register.square(2, spacing=9.0, prefix="q")
    seq = P.Sequence(reg, P.MockDevice)
    seq.set_magnetic_field(0.0, 0.0, 30.0)
    seq.declare_channel("mw", "mw_global")
    seq.config_slm_mask(["q0", "q3"])
    seq.add(
        P.Pulse.ConstantDetuning(P.BlackmanWaveform(60, np.pi), 0.0, 0.0),
        "mw",
    )
    seq.add(P.Pulse.ConstantPulse(300, 1.0, 0.5, 0.7), "mw")
    return seq


def test_xy_slm_sequence_matches_pulser_tpu(f64):
    """The same XY + SLM scenario in both packages: the interaction
    interpolation runs (``(2, N, N)`` couplings), every evaluation state
    within 1e-10, and the results API agrees in the XY basis."""
    jemu = TpuEmulator.from_sequence(xy_slm(tpu), evaluation_times="Full")
    temu = TorchEmulator.from_sequence(
        xy_slm(ptt), evaluation_times="Full", torch_device="cpu"
    )
    ham = temu._current_hamiltonian
    assert ham.xy_mat.shape == (2, 4, 4) and ham.int_w is not None
    assert temu.basis_name == "XY"
    jres, tres = jemu.run(), temu.run()
    want = np.stack([s.full()[:, 0] for s in jres.states])
    got = np.stack([s.full()[:, 0] for s in tres.states])
    assert got.shape == want.shape and len(got) > 300
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    n_d = np.diag([bin(i).count("1") for i in range(16)]).astype(float)
    np.testing.assert_allclose(
        tres.expect([n_d])[0], jres.expect([n_d])[0], atol=1e-10
    )
    np.testing.assert_allclose(
        tres.get_final_state().full(), jres.get_final_state().full(),
        atol=1e-10,
    )
    np.random.seed(2)
    jcounts = jres.sample_final_state(200)
    np.random.seed(2)
    assert tres.sample_final_state(200) == jcounts


@pytest.mark.parametrize(
    "extra, kind",
    [({}, "sesolve_torch_loop"), ({"dephasing_rate": 2.0}, "mcwf_serial_torch")],
    ids=["spam", "spam_dephasing"],
)
def test_xy_with_spam_counts_match(f64, extra, kind):
    """XY with state-preparation and measurement errors: one lab-frame
    solve per trajectory (the XY term does not batch; with dephasing, one
    quantum-jump solve each), the seeded counts equal the JAX package's
    and the RNG stream ends at the same point."""
    from pulser_tpu_torch.interop import from_jax_noise_model

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)  # runs=
        noise = tpu.NoiseModel(
            state_prep_error=0.2, p_false_pos=0.05, p_false_neg=0.1,
            runs=4, samples_per_run=5, **extra,
        )
    out = []
    for P in (tpu, ptt):
        np.random.seed(9)
        if P is tpu:
            emu = TpuEmulator.from_sequence(
                xy_slm(tpu), noise_model=noise, evaluation_times="Minimal"
            )
        else:
            emu = TorchEmulator.from_sequence(
                xy_slm(ptt), noise_model=from_jax_noise_model(noise),
                evaluation_times="Minimal", torch_device="cpu",
            )
        res = emu.run()
        out.append(([dict(r.bitstring_counts) for r in res], np.random.rand()))
    assert torch_solver.last_solve_info["kind"] == kind
    assert out[1] == out[0]
    assert sum(out[1][0][-1].values()) == 20


def test_xy_master_equation_matches(f64):
    """The XY term with dephasing under the master equation (lab frame,
    ``int_w``): every evaluation ρ within 1e-10 of the JAX package's, and
    a density-matrix initial state in XY mode."""
    from pulser_tpu_torch.interop import from_jax_noise_model

    noise = tpu.NoiseModel(dephasing_rate=0.8)
    jemu = TpuEmulator.from_sequence(
        xy_slm(tpu), noise_model=noise, evaluation_times="Minimal"
    )
    temu = TorchEmulator.from_sequence(
        xy_slm(ptt), noise_model=from_jax_noise_model(noise),
        evaluation_times="Minimal", torch_device="cpu",
    )
    want = np.stack([s.full() for s in jemu.run().states])
    got = np.stack([s.full() for s in temu.run().states])
    info = torch_solver.last_solve_info
    assert info["kind"] == "mesolve_cpu" and info["ip"] is False
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(16, 16)) + 1j * rng.normal(size=(16, 16))
    rho = x @ x.conj().T / np.trace(x @ x.conj().T)
    jemu, temu = (
        mk(seq, evaluation_times="Minimal", **kw)
        for mk, seq, kw in (
            (TpuEmulator.from_sequence, xy_slm(tpu), {}),
            (TorchEmulator.from_sequence, xy_slm(ptt), {"torch_device": "cpu"}),
        )
    )
    jemu.set_initial_state(rho)
    temu.set_initial_state(rho)
    np.testing.assert_allclose(
        temu.run().get_final_state().full(),
        jemu.run().get_final_state().full(), rtol=0, atol=1e-10,
    )


def test_xy16_sequence_builds_in_both_packages():
    """``chip_smoke.xy16_build`` gives the same Hamiltonian in both
    packages: two coupling configurations and diagonals interpolated by
    ``int_w`` (the mask holds the π pulse off the 8 masked atoms), equal
    drive samples (the card's XY16 path)."""
    jh, th = (
        mk(chip_smoke.xy16_build(P), **kw)._current_hamiltonian
        for mk, P, kw in (
            (TpuEmulator.from_sequence, tpu, {}),
            (TorchEmulator.from_sequence, ptt, {"torch_device": "cpu"}),
        )
    )
    assert th.xy_mat.shape == (2, 16, 16) and th.int_diag.shape == (2, 2**16)
    for name in ("xy_mat", "int_diag", "int_w", "amp_coeffs", "det_coeffs"):
        np.testing.assert_array_equal(getattr(th, name), getattr(jh, name))
    # The masked atoms (one checkerboard colour) see no π pulse
    masked = [i for i in range(16) if (i // 4 + i % 4) % 2 == 0]
    assert not np.any(th.amp_coeffs[0, masked])
    assert np.all(np.abs(th.amp_coeffs[0, 1, 1:48]) > 30)
    assert len(chip_smoke.XY16_EVAL_TIMES) == 51


def test_xy_initial_states_match(f64):
    """A product of ``u`` and ``d`` states as the initial state (in the XY
    basis ``u`` is index 0 and ``d`` index 1): the port's evolution and
    its final-state sampling equal the JAX package's."""
    psi = np.zeros(16, complex)
    psi[0b0110] = 1.0  # u d d u
    out = []
    for mk, P, kw in (
        (TpuEmulator.from_sequence, tpu, {}),
        (TorchEmulator.from_sequence, ptt, {"torch_device": "cpu"}),
    ):
        emu = mk(xy_slm(P), evaluation_times="Minimal", **kw)
        emu.set_initial_state(psi)
        res = emu.run()
        np.random.seed(4)
        out.append((res.get_final_state().full(), res.sample_final_state(80)))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=0, atol=1e-10)
    assert out[1][1] == out[0][1]
