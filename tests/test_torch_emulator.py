"""The port's slice end to end: sampled sequence → TorchEmulator.run().

Sequences are built and sampled with ``pulser_tpu`` and carried across
with :mod:`pulser_tpu_torch.interop`. The states must reach 1 − F < 1e-6
against the physics goldens (``bell``, ``afm9`` at every evaluation
time) and against ``pulser_tpu``'s own run of a short 10-atom AFM sweep,
and the step count must equal ``pulser_tpu``'s. The port runs in its
default precision here (complex64, torch's float32 default) unless a
test sets float64.
"""

from __future__ import annotations

import os
from collections import Counter

import numpy as np
import pytest
import torch

import pulser_tpu as tpu
from pulser_tpu.emulator import TpuEmulator
from pulser_tpu.ops import solver as jax_solver

from pulser_tpu_torch import NoiseModel
from pulser_tpu_torch.emulator import CoherentResults, TorchEmulator
from pulser_tpu_torch.interop import (
    from_jax_device,
    from_jax_register,
    from_jax_samples,
)
from pulser_tpu_torch.ops import solver as torch_solver

torch.set_num_threads(1)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def _fidelity(a, b):
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    return abs(np.vdot(a, b)) ** 2


def _port(seq, **kwargs):
    return TorchEmulator(
        from_jax_samples(tpu.sampler.sample(seq)),
        from_jax_register(seq.register),
        from_jax_device(seq.device),
        torch_device="cpu",
        **kwargs,
    )


class _PlanOnly(Exception):
    """Raised by the stubbed JAX solver once the plan is built."""


def _stop(*args, **kwargs):
    raise _PlanOnly


def _jax_steps(seq, **kwargs):
    """``pulser_tpu``'s step count for the sequence (plan only)."""
    emu = TpuEmulator.from_sequence(seq, **kwargs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("pulser_tpu.emulator.simulation.sesolve_rk4", _stop)
        with pytest.raises(_PlanOnly):
            emu.run()
    return int(np.count_nonzero(emu._plan_cache[1].seg_dts))


def _afm_sequence(reg, omega, d0, df, t_rise, t_sweep, t_fall):
    seq = tpu.Sequence(reg, tpu.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(
        tpu.Pulse.ConstantDetuning(
            tpu.RampWaveform(t_rise, 0.0, omega), d0, 0.0
        ),
        "ryd",
    )
    seq.add(
        tpu.Pulse.ConstantAmplitude(
            omega, tpu.RampWaveform(t_sweep, d0, df), 0.0
        ),
        "ryd",
    )
    seq.add(
        tpu.Pulse.ConstantDetuning(
            tpu.RampWaveform(t_fall, omega, 0.0), df, 0.0
        ),
        "ryd",
    )
    return seq


@pytest.fixture
def float64_default():
    before = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(before)


def test_bell_golden():
    reg = tpu.Register({"q0": (-2.5, 0.0), "q1": (2.5, 0.0)})
    seq = tpu.Sequence(reg, tpu.AnalogDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(
        tpu.Pulse.ConstantDetuning(
            tpu.BlackmanWaveform(1000, np.pi * np.sqrt(2)), 0.0, 0.0
        ),
        "ryd",
    )
    golden = np.load(os.path.join(GOLDENS, "bell.npz"))["states"][-1]
    res = _port(seq).run()
    assert isinstance(res, CoherentResults)
    final = res.get_final_state(ignore_global_phase=False).full()[:, 0]
    assert 1 - _fidelity(golden, final) < 1e-6
    assert torch_solver.last_solve_info["n_steps"] == _jax_steps(seq)


@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_afm9_golden_at_every_eval_time(dtype, request):
    if dtype == "complex128":
        request.getfixturevalue("float64_default")
    om = 2 * np.pi * 1.8
    seq = _afm_sequence(
        tpu.Register.square(3, spacing=6.0, prefix="q"),
        om, -2 * np.pi * 5, 2 * np.pi * 2, 252, 2000, 252,
    )
    data = np.load(os.path.join(GOLDENS, "afm9.npz"))
    eval_times = data["eval_times_us"]
    res = _port(seq, evaluation_times=eval_times).run()
    for k, golden in enumerate(data["states"]):
        state = res.get_state(
            eval_times[k], ignore_global_phase=False
        ).full()[:, 0]
        assert state.dtype == np.complex128  # Qobj data
        assert 1 - _fidelity(golden, state) < 1e-6, eval_times[k]
    assert torch_solver.last_solve_info["n_steps"] == _jax_steps(
        seq, evaluation_times=eval_times
    )


@pytest.fixture(scope="module")
def afm10():
    """A short 10-atom AFM sweep and ``pulser_tpu``'s run of it."""
    seq = _afm_sequence(
        tpu.Register.rectangle(2, 5, spacing=6.0, prefix="q"),
        2 * np.pi * 2.0, -2 * np.pi * 6, 2 * np.pi * 2, 100, 400, 100,
    )
    eval_times = np.linspace(0, 0.6, 13)
    res = TpuEmulator.from_sequence(seq, evaluation_times=eval_times).run()
    states = [s.full()[:, 0] for s in res.states]
    return seq, eval_times, states, jax_solver.last_solve_info["n_steps"]


def test_afm10_matches_pulser_tpu(afm10):
    seq, eval_times, want, n_steps = afm10
    emu = _port(seq, evaluation_times=eval_times)
    res = emu.run()
    assert torch_solver.last_solve_info["kind"] == "sesolve_torch_loop"
    assert torch_solver.last_solve_info["n_steps"] == n_steps
    assert len(res.states) == len(want)
    for got, ref in zip(res.states, want):
        assert 1 - _fidelity(ref, got.full()[:, 0]) < 1e-6
    # A second run reuses the plan and gives the same states
    again = emu.run()
    assert emu._plan_cache[1] is not None
    assert np.array_equal(
        again.states[-1].full(), res.states[-1].full()
    )


def test_afm10_through_the_kernel_plain_twin(afm10, monkeypatch):
    """The emulator's kernel route (taken on a card) on CPU tensors runs
    the kernel's plain twin: same states and step count."""
    seq, eval_times, want, n_steps = afm10
    real = torch_solver._sesolve_rk4_kernel
    calls = []

    def route_to_kernel(psi0, plan, diag, pairs, d, n, **kw):
        calls.append(n)
        return real(psi0, plan, diag, n, np.complex64, "cpu", kw["lazy"])

    monkeypatch.setattr(torch_solver, "sesolve_rk4", route_to_kernel)
    res = _port(seq, evaluation_times=eval_times).run()
    assert calls == [10]
    assert torch_solver.last_solve_info["kind"] == "ip_sesolve_plain"
    assert torch_solver.last_solve_info["n_steps"] == n_steps
    for got, ref in zip(res.states, want):
        assert 1 - _fidelity(ref, got.full()[:, 0]) < 1e-6


def test_results_api(afm10):
    seq, eval_times, _, _ = afm10
    res = _port(seq, evaluation_times=eval_times).run()
    final = res.get_final_state()
    assert final.shape == (2**10, 1)
    assert np.isclose(np.linalg.norm(final.full()), 1.0, atol=1e-6)
    rng_state = np.random.get_state()
    try:
        np.random.seed(7)
        counts = res.sample_final_state(500)
    finally:
        np.random.set_state(rng_state)
    assert isinstance(counts, Counter)
    assert sum(counts.values()) == 500
    assert all(len(b) == 10 for b in counts)
    assert np.allclose(res._sim_times, eval_times)


def test_noise_is_not_ported_yet():
    """Dephasing alone runs the master equation; the quantum-jump solver
    without shot-to-shot noise runs the serial solve of ``n_trajectories``
    trajectories (interaction picture: dephasing is diagonal), whose
    averaged density matrices equal the JAX package's on the same seed
    (complex128, 1e-10)."""
    from pulser_tpu.emulator.simulation import Solver as JaxSolver

    from pulser_tpu_torch.emulator import Solver

    seq = _afm_sequence(
        tpu.Register.square(2, spacing=6.0, prefix="q"),
        2 * np.pi, -2 * np.pi, 2 * np.pi, 100, 100, 100,
    )
    res = _port(seq, noise_model=NoiseModel(dephasing_rate=0.1)).run()
    assert torch_solver.last_solve_info["kind"] == "mesolve_cpu"
    assert res.get_final_state().shape == (16, 16)
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        np.random.seed(8)
        jres = TpuEmulator.from_sequence(
            seq, noise_model=tpu.NoiseModel(dephasing_rate=2.0),
            solver=JaxSolver.MCSOLVER, n_trajectories=5,
        ).run()
        np.random.seed(8)
        tres = _port(
            seq, noise_model=NoiseModel(dephasing_rate=2.0),
            solver=Solver.MCSOLVER, n_trajectories=5,
        ).run()
    finally:
        torch.set_default_dtype(old)
    info = torch_solver.last_solve_info
    assert info["kind"] == "mcwf_serial_torch" and info["n_traj"] == 5
    assert info["ip"] is True
    want = np.stack([s.full() for s in jres.states])
    got = np.stack([s.full() for s in tres.states])
    assert got.shape == want.shape and got.shape[1:] == (16, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


# -- SPAM measurement errors on coherent results --------------------------


def _coherent_pair(meas_errors, seed=3, n=3, n_times=2):
    """The same random states as ``CoherentResults`` of both packages."""
    from pulser_tpu.emulator.sim_result import TpuResult
    from pulser_tpu.emulator.simresults import CoherentResults as JaxCoherent
    from pulser_tpu.emulator import qobj as jax_qobj

    from pulser_tpu_torch.emulator.qobj import Qobj
    from pulser_tpu_torch.emulator.sim_result import TorchResult

    rng = np.random.default_rng(seed)
    states = rng.normal(size=(n_times, 2**n)) + 1j * rng.normal(
        size=(n_times, 2**n)
    )
    states /= np.linalg.norm(states, axis=1, keepdims=True)
    qids = tuple(f"q{i}" for i in range(n))
    times = np.linspace(0.0, 1.0, n_times)
    dims = [[2] * n, [1] * n]
    out = []
    for result_cls, qobj_cls, res_cls in (
        (TpuResult, jax_qobj.Qobj, JaxCoherent),
        (TorchResult, Qobj, CoherentResults),
    ):
        results = [
            result_cls(
                qids, "ground-rydberg", qobj_cls(s, dims=dims), True,
                evaluation_time=float(t),
            )
            for s, t in zip(states, times)
        ]
        out.append(
            res_cls(
                results, n, "ground-rydberg", times, "ground-rydberg",
                meas_errors,
            )
        )
    return out


@pytest.mark.parametrize(
    "meas_errors",
    [
        {"epsilon": 0.1, "epsilon_prime": 0.25},
        {"epsilon": 0.0, "epsilon_prime": 0.3},
        {"epsilon": 0.0, "epsilon_prime": 0.0},
        None,
    ],
    ids=["both", "false_neg", "zero", "none"],
)
def test_coherent_results_meas_errors_match_pulser_tpu(meas_errors):
    """``sample_state`` (SPAM flips from the numpy global RNG),
    ``_meas_projector`` and the pseudo-density expectation equal the JAX
    package's on the same states and seed."""
    jres, tres = _coherent_pair(meas_errors)
    assert tres._use_pseudo_dens == jres._use_pseudo_dens == (
        meas_errors is not None
    )
    for state_n in (0, 1):
        assert np.array_equal(
            tres._meas_projector(state_n).full(),
            np.asarray(jres._meas_projector(state_n).full()),
        )
    rng_state = np.random.get_state()
    try:
        for t in (0.0, 1.0):
            np.random.seed(11)
            want = jres.sample_state(t, n_samples=300)
            j_after = np.random.rand()
            np.random.seed(11)
            got = tres.sample_state(t, n_samples=300)
            assert np.random.rand() == j_after
            assert got == want and sum(got.values()) == 300
    finally:
        np.random.set_state(rng_state)
    # A diagonal observable: the Rydberg occupation of atom 0
    obs = np.kron(np.diag([1.0, 0.0]), np.eye(4))
    assert np.allclose(
        tres.expect([obs])[0], np.asarray(jres.expect([obs])[0]), atol=1e-12
    )


def test_coherent_results_meas_errors_keys():
    with pytest.raises(ValueError, match="epsilon"):
        _coherent_pair({"epsilon": 0.1})


def test_spam_measurement_errors_alone_stay_coherent():
    """False positives and negatives without preparation errors are no
    shot-to-shot noise: one coherent run whose samples carry the flips,
    as in the JAX package."""
    seq = _afm_sequence(
        tpu.Register.square(2, spacing=6.0, prefix="q"),
        2 * np.pi, -2 * np.pi, 2 * np.pi, 100, 100, 100,
    )
    spam = dict(p_false_pos=0.1, p_false_neg=0.2)
    jres = TpuEmulator.from_sequence(
        seq, noise_model=tpu.NoiseModel(**spam), evaluation_times="Minimal"
    ).run()
    tres = _port(
        seq, noise_model=NoiseModel(**spam), evaluation_times="Minimal"
    ).run()
    assert isinstance(tres, CoherentResults)
    assert tres._meas_errors == jres._meas_errors == {
        "epsilon": 0.1, "epsilon_prime": 0.2,
    }
    rng_state = np.random.get_state()
    try:
        np.random.seed(2)
        want = jres.sample_final_state(200)
        np.random.seed(2)
        got = tres.sample_final_state(200)
    finally:
        np.random.set_state(rng_state)
    moved = sum(abs(got.get(k, 0) - want.get(k, 0)) for k in set(got) | set(want))
    # complex64 against complex128 states: a draw within float32 rounding
    # of a bin edge may move one count
    assert moved <= 2


# -- Shots of a coherent result -------------------------------------------


def _skewed_state(n, dim, seed):
    """A seeded, unnormalized host state over ``dim**n`` levels whose
    probabilities spread over decades, so a thousand shots repeat their
    likeliest outcomes."""
    rng = np.random.default_rng(seed)
    size = dim**n
    amps = rng.normal(size=size) + 1j * rng.normal(size=size)
    return 3.7 * amps * rng.exponential(size=size) ** 4


def _result_pair(state, n, dim, meas_basis, matching):
    """``TpuResult`` and ``TorchResult`` over the same complex128 state."""
    from pulser_tpu.emulator import qobj as jax_qobj
    from pulser_tpu.emulator.sim_result import TpuResult

    from pulser_tpu_torch.emulator.qobj import Qobj
    from pulser_tpu_torch.emulator.sim_result import TorchResult

    qids = tuple(f"q{i}" for i in range(n))
    dims = [[dim] * n, [1] * n]
    with pytest.warns(DeprecationWarning):
        jres = TpuResult(
            qids, meas_basis, jax_qobj.Qobj(state, dims=dims), matching
        )
    with pytest.warns(DeprecationWarning):
        tres = TorchResult(qids, meas_basis, Qobj(state, dims=dims), matching)
    return jres, tres


# (dim, meas_basis, matching, basis the result resolves to)
_WEIGHT_BASES = {
    "ground-rydberg": (2, "ground-rydberg", True, "ground-rydberg"),
    "digital": (2, "digital", True, "digital"),
    "non-matching": (2, "ground-rydberg", False, "digital"),
    "ground-rydberg_with_error": (
        3, "ground-rydberg", True, "ground-rydberg_with_error"
    ),
    "all_with_error": (4, "ground-rydberg", True, "all_with_error"),
}


@pytest.mark.parametrize(
    "basis, n",
    [
        (basis, n)
        for basis in ("ground-rydberg", "digital", "non-matching")
        for n in (10, 12, 16)
    ]
    # 3**16 and 4**12 amplitudes do not fit a test's memory
    + [("ground-rydberg_with_error", n) for n in (10, 12)]
    + [("all_with_error", 10)],
)
def test_result_weights_bit_equal_to_pulser_tpu(basis, n):
    """``TorchResult._weights`` normalizes with the JAX package's
    sequential sum: the same bits, not merely close values."""
    dim, meas_basis, matching, resolved = _WEIGHT_BASES[basis]
    state = _skewed_state(n, dim, seed=n + 100 * dim)
    jres, tres = _result_pair(state, n, dim, meas_basis, matching)
    assert tres._basis_name == jres._basis_name == resolved
    want = np.asarray(jres._weights())
    got = tres._weights()
    assert got.dtype == want.dtype == np.float64
    assert np.array_equal(got, want)
    # The state is far from normalized: the division is what is compared
    assert abs(np.sum(np.abs(state) ** 2) - 1.0) > 0.1


@pytest.fixture(scope="module")
def shots16():
    """``CoherentResults`` of both packages over one 16-atom host state."""
    from pulser_tpu.emulator.simresults import CoherentResults as JaxCoherent

    n = 16
    state = _skewed_state(n, 2, seed=16)
    times = np.array([1.0])
    jres, tres = _result_pair(state, n, 2, "ground-rydberg", True)
    return (
        JaxCoherent([jres], n, "ground-rydberg", times, "ground-rydberg"),
        CoherentResults([tres], n, "ground-rydberg", times, "ground-rydberg"),
    )


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_sample_final_state_n16_equals_pulser_tpu(shots16, seed):
    """Seeded shots of a 16-atom state: the same Counter as the JAX
    package's, in the same iteration order, and the RNG left at the
    same point."""
    jres, tres = shots16
    rng_state = np.random.get_state()
    try:
        np.random.seed(seed)
        want = jres.sample_final_state(1000)
        j_after = np.random.rand()
        np.random.seed(seed)
        got = tres.sample_final_state(1000)
        assert np.random.rand() == j_after
    finally:
        np.random.set_state(rng_state)
    assert got == want and sum(got.values()) == 1000
    assert list(got) == list(want)
    assert got.most_common() == want.most_common()
    # Outcomes repeat, so the order of first draws is what is held
    assert max(got.values()) > 1 and len(got) < 1000


@pytest.mark.parametrize("kind", ["span", "empty", "beyond"])
@pytest.mark.parametrize("width", [1, 2, 16, 29, 62, 63])
def test_labels_of_equals_format(width, kind):
    """The bit-table labels equal ``format`` item for item; widths above
    62, an empty array and an index past ``2**width`` (what
    ``searchsorted`` gives a uniform beyond the last cumulative weight)
    take the ``format`` fallback."""
    from pulser_tpu_torch.result import _labels_of

    rng = np.random.default_rng(width)
    if kind == "span":
        idx = np.concatenate(
            [
                [0, 2**width - 1],
                rng.integers(0, 2**width, size=200, dtype=np.int64),
            ]
        ).astype(np.int64)
    elif kind == "empty":
        idx = np.array([], dtype=np.int64)
    else:
        idx = np.array([2**width - 1, 2 ** min(width, 62), 0], dtype=np.int64)
    want = [format(int(i), f"0{width}b") for i in idx]
    got = _labels_of(idx, width)
    assert got == want
    assert all(type(s) is str for s in got)
