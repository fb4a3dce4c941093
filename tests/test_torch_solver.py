"""The ported solver layers against pulser_tpu on identical inputs.

- ``hamiltonian_matvec`` (structured H·ψ) against the JAX real-pair
  version in float64: max |Δ| ≤ 1e-12.
- ``sesolve_rk4`` in the interaction picture, on the plan ``pulser_tpu``
  builds for a short 10-atom AFM sweep: complex128 against the JAX
  complex128 solve to max |Δ| ≤ 1e-12 (same grid and RK4 arithmetic,
  other summation orders), and complex64 against the same JAX solve to
  1 − F ≤ 1e-6 (float32 rounding over the sweep).
- ``sesolve_rk4_batched`` (noise-trajectory batches) against the JAX
  package's vmapped XLA route on the same batched plan: complex128 to
  max |Δ| ≤ 1e-12, complex64 to 1 − F ≤ 1e-6, for qubits, for a d = 3
  basis, for a list of plans, and through the batched kernel's plain
  twin.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import pulser_tpu as tpu
from pulser_tpu.emulator import TpuEmulator
from pulser_tpu.ops import apply as jax_apply
from pulser_tpu.ops import solver as jax_solver

from pulser_tpu_torch.emulator import TorchEmulator
from pulser_tpu_torch.ops import apply as torch_apply
from pulser_tpu_torch.ops import solver as torch_solver

torch.set_num_threads(1)


def _afm10_sequence():
    """A short 10-atom version of the BASELINE AFM sweep."""
    reg = tpu.Register.rectangle(2, 5, spacing=6.0, prefix="q")
    seq = tpu.Sequence(reg, tpu.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    omega_max = 2.0 * 2 * np.pi
    delta_0 = -6 * 2 * np.pi
    delta_f = 2 * 2 * np.pi
    seq.add(
        tpu.Pulse.ConstantDetuning(
            tpu.RampWaveform(100, 0.0, omega_max), delta_0, 0.0
        ),
        "ryd",
    )
    seq.add(
        tpu.Pulse.ConstantAmplitude(
            omega_max, tpu.RampWaveform(400, delta_0, delta_f), 0.0
        ),
        "ryd",
    )
    seq.add(
        tpu.Pulse.ConstantDetuning(
            tpu.RampWaveform(100, omega_max, 0.0), delta_f, 0.0
        ),
        "ryd",
    )
    return seq


def _infidelity(want, got):
    """1 − F per evaluation time (both sides normalized: RK4 does not
    conserve the norm exactly)."""
    overlap = np.abs(np.sum(np.conj(want) * got, axis=1)) ** 2
    norms = np.linalg.norm(want, axis=1) * np.linalg.norm(got, axis=1)
    return 1 - overlap / norms**2


@pytest.mark.parametrize("n, seed", [(4, 0), (7, 1)])
def test_hamiltonian_matvec_matches_jax(n, seed):
    rng = np.random.default_rng(seed)
    psi = rng.normal(size=2**n) + 1j * rng.normal(size=2**n)
    diag = rng.uniform(0, 50, 2**n)
    amp = rng.normal(size=(1, n)) + 1j * rng.normal(size=(1, n))
    det = rng.normal(size=(1, n))
    pairs = ((1, 0, 0),)
    want = np.asarray(
        jax_apply.hamiltonian_matvec(
            jnp.stack([psi.real, psi.imag]),
            jnp.asarray(diag),
            jnp.asarray(amp.real),
            jnp.asarray(amp.imag),
            jnp.asarray(det),
            pairs,
            2,
            n,
        )
    )
    got = torch_apply.hamiltonian_matvec(
        torch.from_numpy(psi),
        torch.from_numpy(diag),
        torch.from_numpy(amp),
        torch.from_numpy(det),
        pairs,
        2,
        n,
    ).numpy()
    assert np.max(np.abs(got - (want[0] + 1j * want[1]))) <= 1e-12


@pytest.mark.parametrize("n", [7, 13])
def test_synthesized_ip_phase_matches_occupancy_masks(n):
    """The interaction-picture phase built from the basis index equals
    the one built from ``TorchEmulator._make_ip_occ``'s 0/1 masks."""
    rng = np.random.default_rng(n)
    pairs = ((1, 0, 0),)
    ham = SimpleNamespace(dim=2, n_qudits=n, pairs=pairs)
    occ = TorchEmulator._make_ip_occ(ham).astype(np.float64)
    diag = rng.uniform(0, 300, 2**n)
    cum = rng.uniform(0, 2 * np.pi, (1, n))
    t = 0.37
    want = np.mod(diag * t, 2 * np.pi) + np.einsum("bq,bqD->D", cum, occ)
    phase_at = torch_solver._make_ip_phase_fn(
        pairs, 2, n, torch.float64, torch.device("cpu")
    )
    got = phase_at(
        torch.from_numpy(diag),
        torch.tensor(t, dtype=torch.float64),
        torch.from_numpy(cum),
    ).numpy()
    assert np.max(np.abs(got - want)) <= 1e-12


@pytest.fixture(scope="module")
def afm10():
    """The JAX emulator's Hamiltonian, plan and complex128 solve."""
    emu = TpuEmulator.from_sequence(
        _afm10_sequence(), evaluation_times=np.linspace(0, 0.6, 7)
    )
    emu.run()
    plan = emu._plan_cache[1]
    ham = emu._current_hamiltonian
    psi0 = emu.initial_state.full()[:, 0]
    want = jax_solver.sesolve_rk4(
        psi0.astype(np.complex128),
        plan,
        ham.int_diag,
        ham.pairs,
        2,
        10,
        ip_occ=emu._make_ip_occ(ham),
        dtype=np.complex128,
    )
    return plan, ham, psi0, want


def _port_solve(afm10, dtype):
    plan, ham, psi0, _ = afm10
    return torch_solver.sesolve_rk4(
        psi0,
        plan,
        ham.int_diag,
        ham.pairs,
        2,
        10,
        dtype=dtype,
        ip_occ=True,
        device="cpu",
    )


def test_sesolve_complex128_matches_jax(afm10):
    want = afm10[3]
    got = _port_solve(afm10, np.complex128)
    assert got.shape == want.shape and got.dtype == np.complex128
    assert np.max(np.abs(got - want)) <= 1e-12
    assert torch_solver.last_solve_info["kind"] == "sesolve_torch_loop"


def test_sesolve_complex64_matches_jax_complex128(afm10):
    want = afm10[3]
    got = _port_solve(afm10, np.complex64)
    assert got.dtype == np.complex64
    assert np.max(_infidelity(want, got)) <= 1e-6


def test_kernel_route_on_cpu_matches_jax(afm10):
    """``_sesolve_rk4_kernel`` (the kernel's plain twin on CPU tensors)
    on the same plan: float32, so 1 − F ≤ 1e-6."""
    plan, ham, psi0, want = afm10
    got = torch_solver._sesolve_rk4_kernel(
        psi0, plan, ham.int_diag, 10, np.complex64, "cpu"
    )
    assert torch_solver.last_solve_info["kind"] == "ip_sesolve_plain"
    assert np.max(_infidelity(want, got)) <= 1e-6


@pytest.mark.parametrize("case", ["lab_frame", "xy", "mesh"])
def test_outside_the_slice_raises(afm10, case):
    """The lab frame (no ``ip_occ``) and the XY term run the lab-frame
    loop on 1 ns steps and equal the JAX package's lab-frame solve in
    complex128 (1e-10); only state sharding still raises, naming its
    ROADMAP item."""
    _, ham, psi0, _ = afm10
    if case == "mesh":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            torch_solver.sesolve_rk4(
                psi0, afm10[0], ham.int_diag, ham.pairs, 2, 10, ip_occ=True,
                state_mesh=object(), device="cpu",
            )
        return
    kw = {}
    if case == "xy":
        u = np.random.default_rng(4).normal(size=(10, 10))
        u = u + u.T
        np.fill_diagonal(u, 0.0)
        kw = dict(xy_static=u[None], xy_indices=(1, 0), ip_occ=True)
    args = (
        ham.sampling_times,
        {"amp": ham.amp_coeffs, "det": ham.det_coeffs},
        np.array([0.1, 0.6]),
    )
    jplan = jax_solver.build_plan(*args, max_step=1e-3)
    tplan = torch_solver.build_plan(*args, max_step=1e-3)
    psi0 = psi0.astype(np.complex128)
    want = jax_solver.sesolve_rk4(
        psi0, jplan, ham.int_diag, ham.pairs, 2, 10, dtype=np.complex128,
        **kw,
    )
    got = torch_solver.sesolve_rk4(
        psi0, tplan, ham.int_diag, ham.pairs, 2, 10, dtype=np.complex128,
        device="cpu", **kw,
    )
    info = torch_solver.last_solve_info
    assert info["kind"] == "sesolve_torch_loop" and info["ip"] is False
    assert abs(np.linalg.norm(got[-1]) - 1) < 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def _afm16_plan(monkeypatch):
    """The AFM16 plan ``TorchEmulator.run()`` builds (the solve itself is
    stopped before it starts)."""
    import chip_smoke

    class _Stop(Exception):
        pass

    captured = {}

    def stop(psi0, plan, *args, **kwargs):
        captured["plan"] = plan
        raise _Stop

    samples, register, mock = chip_smoke.afm16_inputs()
    emu = TorchEmulator(
        samples, register, mock,
        evaluation_times=np.linspace(0, samples.max_duration * 1e-3, 101),
        torch_device="cpu",
    )
    monkeypatch.setattr(torch_solver, "sesolve_rk4", stop)
    with pytest.raises(_Stop):
        emu.run()
    return captured["plan"], 16


def _padded_plan(monkeypatch):
    """A 10-atom plan whose segments hold 13, 37, 1 and 49 steps, so
    three of them start with padding."""
    rng = np.random.default_rng(5)
    knots = np.linspace(0.0, 1.0, 101)
    shape = (1, 10, 101)
    coeffs = {
        "amp": rng.normal(size=shape) + 1j * rng.normal(size=shape),
        "det": rng.normal(scale=20.0, size=shape),
    }
    plan = torch_solver.build_plan(
        knots, coeffs, np.array([0.0, 0.13, 0.5, 0.51, 1.0])
    )
    return plan, 10


@pytest.mark.parametrize("make_plan", [_afm16_plan, _padded_plan],
                         ids=["afm16", "padded"])
def test_ip_kernel_rows_share_rotors(monkeypatch, make_plan):
    """The rotor sharing K1 relies on: RK4 stages 1 and 2 read the same
    plan row, and each real step's end row (t + h) equals the next real
    step's start row bit for bit (time and phase integrals), across
    segment boundaries and padding, so the end-of-step rotor is carried."""
    plan, n = make_plan(monkeypatch)
    assert [(j + 1) >> 1 for j in range(4)] == list(torch_solver._RK_STAGE)
    assert torch_solver._RK_STAGE[1] == torch_solver._RK_STAGE[2]
    psi0 = np.zeros(1 << n, dtype=np.complex64)
    psi0[0] = 1.0
    diag = np.zeros(1 << n)
    args, _ = torch_solver.ip_kernel_inputs(psi0, plan, diag, n, "cpu")
    cum, t_stage, seg_dts = args[2], args[3], args[4]
    real = seg_dts.reshape(-1) != 0
    assert not bool(real.all())  # some segments start with padding
    t = t_stage.reshape(-1, 3)[real].numpy().view(np.int32)
    c = cum.reshape(-1, 3, n)[real].numpy().view(np.int32)
    assert len(t) == np.count_nonzero(plan.dts)
    np.testing.assert_array_equal(t[:-1, 2], t[1:, 0])
    np.testing.assert_array_equal(c[:-1, 2], c[1:, 0])
    # The steps compared cross segment boundaries
    assert np.count_nonzero(plan.seg_dts.any(axis=1)) > 1


def _batched_case(n, d, pairs, n_traj=3, seed=12):
    """A random trajectory batch on six knots, as the JAX package's own
    batched tests build it: ``(knots, coeffs, eval_times, diags, psi0)``."""
    rng = np.random.default_rng(seed)
    nb = len(pairs)
    knots = np.linspace(0.0, 0.1, 6)
    amp_b = rng.uniform(1, 5, size=(n_traj, nb, n, 6)) * np.exp(
        1j * rng.uniform(0, 2 * np.pi, size=(n_traj, nb, n, 1))
    )
    det_b = rng.normal(0, 2, size=(n_traj, nb, n, 6))
    diags = rng.uniform(0, 20, size=(n_traj, d**n))
    psi0 = np.zeros(d**n, complex)
    psi0[-1] = 1.0
    return (
        knots, {"amp": amp_b, "det": det_b}, np.array([0.0, 0.04, 0.1]),
        diags, psi0,
    )


def _jax_batched(case, pairs, d, n, dtype):
    knots, coeffs, eval_times, diags, psi0 = case
    plans = jax_solver.build_plan_batched(
        knots, coeffs, eval_times, max_step=2e-3
    )
    return jax_solver.sesolve_rk4_batched(
        psi0, plans, diags, pairs, d, n, True, dtype=dtype
    )


@pytest.mark.parametrize(
    "n, d, pairs",
    [(6, 2, ((1, 0, 0),)), (10, 2, ((1, 0, 0),)), (4, 3, ((0, 1, 0), (1, 2, 2)))],
    ids=["qubits6", "qubits10", "qutrits4"],
)
@pytest.mark.parametrize(
    "dtype, check",
    [
        (np.complex128, lambda w, g: np.max(np.abs(w - g)) <= 1e-12),
        (
            np.complex64,
            lambda w, g: max(np.max(_infidelity(a, b)) for a, b in zip(w, g))
            <= 1e-6,
        ),
    ],
    ids=["complex128", "complex64"],
)
def test_sesolve_batched_matches_jax(monkeypatch, n, d, pairs, dtype, check):
    monkeypatch.delenv("PULSER_TPU_PALLAS_INTERPRET", raising=False)
    case = _batched_case(n, d, pairs)
    want = np.asarray(_jax_batched(case, pairs, d, n, np.complex128))
    knots, coeffs, eval_times, diags, psi0 = case
    plans = torch_solver.build_plan_batched(
        knots, coeffs, eval_times, max_step=2e-3
    )
    got = torch_solver.sesolve_rk4_batched(
        psi0, plans, diags, pairs, d, n, True, dtype=dtype, device="cpu"
    )
    info = torch_solver.last_solve_info
    assert info["kind"] == "sesolve_batched_torch" and info["n_traj"] == 3
    assert got.shape == want.shape == (3, 3, d**n) and got.dtype == dtype
    assert check(want, got)
    # The trajectories differ, and each starts from psi0
    assert np.allclose(got[:, 0], psi0, atol=1e-6)
    assert np.max(np.abs(got[0, -1] - got[1, -1])) > 1e-2


def test_sesolve_batched_takes_a_list_of_plans():
    """One plan per trajectory on one grid, as the JAX function takes."""
    n, d, pairs = 5, 2, ((1, 0, 0),)
    knots, coeffs, eval_times, diags, psi0 = _batched_case(n, d, pairs)
    batched = torch_solver.build_plan_batched(
        knots, coeffs, eval_times, max_step=2e-3
    )
    plans = [
        torch_solver.build_plan(
            knots, {k: v[t] for k, v in coeffs.items()}, eval_times,
            max_step=2e-3,
        )
        for t in range(3)
    ]
    kw = dict(dtype=np.complex128, device="cpu")
    want = torch_solver.sesolve_rk4_batched(
        psi0, batched, diags, pairs, d, n, True, **kw
    )
    got = torch_solver.sesolve_rk4_batched(
        psi0, plans, diags, pairs, d, n, True, **kw
    )
    assert np.max(np.abs(got - want)) <= 1e-14
    jplans = [
        jax_solver.build_plan(
            knots, {k: v[t] for k, v in coeffs.items()}, eval_times,
            max_step=2e-3,
        )
        for t in range(3)
    ]
    jwant = jax_solver.sesolve_rk4_batched(
        psi0, jplans, diags, pairs, d, n, True, dtype=np.complex128
    )
    assert np.max(np.abs(got - np.asarray(jwant))) <= 1e-12


def test_sesolve_batched_kernel_route_on_cpu_matches_jax():
    """The batched kernel's dispatch with its plain twin (what a CPU
    tensor gets) against the JAX XLA route: float32, 1 − F ≤ 1e-6."""
    n, d, pairs = 10, 2, ((1, 0, 0),)
    case = _batched_case(n, d, pairs)
    want = np.asarray(_jax_batched(case, pairs, d, n, np.complex128))
    knots, coeffs, eval_times, diags, psi0 = case
    plans = torch_solver.build_plan_batched(
        knots, coeffs, eval_times, max_step=2e-3
    )
    got = torch_solver._sesolve_batched_kernel(
        psi0.astype(np.complex64), plans, diags, n, np.complex64, "cpu"
    )
    info = torch_solver.last_solve_info
    assert info["kind"] == "ip_sesolve_batched_plain" and info["n_traj"] == 3
    assert got.shape == want.shape
    assert max(np.max(_infidelity(a, b)) for a, b in zip(want, got)) <= 1e-6


def test_sesolve_batched_refuses_a_mesh_and_needs_a_device():
    n, d, pairs = 4, 2, ((1, 0, 0),)
    knots, coeffs, eval_times, diags, psi0 = _batched_case(n, d, pairs)
    plans = torch_solver.build_plan_batched(knots, coeffs, eval_times)
    with pytest.raises(NotImplementedError, match="Parallel and serving"):
        torch_solver.sesolve_rk4_batched(
            psi0, plans, diags, pairs, d, n, True, mesh=object(), device="cpu"
        )
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            torch_solver.sesolve_rk4_batched(
                psi0, plans, diags, pairs, d, n, True
            )
