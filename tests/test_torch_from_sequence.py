"""``TorchEmulator.from_sequence`` end to end on the CPU.

Every sequence here is built with the port's own ``Sequence`` and enters
through ``TorchEmulator.from_sequence(seq, torch_device="cpu")``; no
object is carried across from the JAX package. Tolerances:

- Bell and 3×3 AFM against the physics goldens (``tests/goldens``):
  1 − F < 1e-6 at every evaluation time, the acceptance bar of the
  goldens themselves;
- a short 10-atom sweep against ``TpuEmulator.from_sequence`` of the
  same sequence built with ``pulser_tpu``: equal step counts; in
  complex128 max |Δψ| ≤ 1e-12 (same plan, same arithmetic, other
  summation order); in complex64 1 − F ≤ 1e-6;
- a 4-atom noisy run (SPAM, doppler, amplitude) in double precision on
  the same seed: the bitstring counts are equal and the numpy global RNG
  ends at the same point;
- the five refusals of ``from_sequence`` raise the JAX package's errors.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import pytest
import torch
from test_torch_sequence import SCENARIOS, _rng

import jax
import pulser_tpu as tpu
from pulser_tpu.emulator import TpuEmulator
from pulser_tpu.ops import solver as jax_solver

import pulser_tpu_torch as ptt
from pulser_tpu_torch.emulator import (
    CoherentResults,
    NoisyResults,
    TorchEmulator,
)
from pulser_tpu_torch.ops import solver as torch_solver

torch.set_num_threads(1)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
EMULATORS = {tpu: TpuEmulator, ptt: TorchEmulator}


def _fidelity(a, b):
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    return abs(np.vdot(a, b)) ** 2


def _afm_sequence(P, reg, omega, d0, df, t_rise, t_sweep, t_fall):
    seq = P.Sequence(reg, P.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(
        P.Pulse.ConstantDetuning(P.RampWaveform(t_rise, 0.0, omega), d0, 0.0),
        "ryd",
    )
    seq.add(
        P.Pulse.ConstantAmplitude(omega, P.RampWaveform(t_sweep, d0, df), 0.0),
        "ryd",
    )
    seq.add(
        P.Pulse.ConstantDetuning(P.RampWaveform(t_fall, omega, 0.0), df, 0.0),
        "ryd",
    )
    return seq


def _afm10(P):
    return _afm_sequence(
        P,
        P.Register.rectangle(2, 5, spacing=6.0, prefix="q"),
        2 * np.pi * 2.0, -2 * np.pi * 6, 2 * np.pi * 2, 100, 400, 100,
    )


@pytest.fixture
def double_precision():
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(torch.float32)


def test_bell_golden():
    reg = ptt.Register({"q0": (-2.5, 0.0), "q1": (2.5, 0.0)})
    seq = ptt.Sequence(reg, ptt.AnalogDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(
        ptt.Pulse.ConstantDetuning(
            ptt.BlackmanWaveform(1000, np.pi * np.sqrt(2)), 0.0, 0.0
        ),
        "ryd",
    )
    golden = np.load(os.path.join(GOLDENS, "bell.npz"))["states"][-1]
    res = TorchEmulator.from_sequence(seq, torch_device="cpu").run()
    assert isinstance(res, CoherentResults)
    final = res.get_final_state(ignore_global_phase=False).full()[:, 0]
    assert 1 - _fidelity(golden, final) < 1e-6


@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_afm9_golden_at_every_eval_time(dtype, request):
    if dtype == "complex128":
        request.getfixturevalue("double_precision")
    seq = _afm_sequence(
        ptt,
        ptt.Register.square(3, spacing=6.0, prefix="q"),
        2 * np.pi * 1.8, -2 * np.pi * 5, 2 * np.pi * 2, 252, 2000, 252,
    )
    data = np.load(os.path.join(GOLDENS, "afm9.npz"))
    eval_times = data["eval_times_us"]
    res = TorchEmulator.from_sequence(
        seq, evaluation_times=eval_times, torch_device="cpu"
    ).run()
    for k, golden in enumerate(data["states"]):
        state = res.get_state(
            eval_times[k], ignore_global_phase=False
        ).full()[:, 0]
        assert 1 - _fidelity(golden, state) < 1e-6, eval_times[k]


@pytest.fixture(scope="module")
def jax_afm10():
    """``pulser_tpu``'s run of the 10-atom sweep (complex128)."""
    eval_times = np.linspace(0, 0.6, 13)
    res = TpuEmulator.from_sequence(
        _afm10(tpu), evaluation_times=eval_times
    ).run()
    states = [np.asarray(s.full())[:, 0] for s in res.states]
    return eval_times, states, jax_solver.last_solve_info["n_steps"]


@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_afm10_matches_pulser_tpu(jax_afm10, dtype, request):
    if dtype == "complex128":
        request.getfixturevalue("double_precision")
    eval_times, want, n_steps = jax_afm10
    res = TorchEmulator.from_sequence(
        _afm10(ptt), evaluation_times=eval_times, torch_device="cpu"
    ).run()
    assert torch_solver.last_solve_info["n_steps"] == n_steps
    assert len(res.states) == len(want)
    for got, ref in zip(res.states, want):
        state = got.full()[:, 0]
        if dtype == "complex128":
            assert np.max(np.abs(state - ref)) <= 1e-12
        else:
            assert 1 - _fidelity(ref, state) <= 1e-6


def test_with_modulation_matches_pulser_tpu(double_precision):
    """``with_modulation`` samples the expected output over the fall
    time: same step count and states as ``pulser_tpu`` (≤ 1e-12)."""

    def seq_of(P):
        reg = P.Register.rectangle(1, 3, spacing=7.0, prefix="q")
        seq = P.Sequence(reg, P.AnalogDevice)
        seq.declare_channel("ryd", "rydberg_global")
        seq.add(
            P.Pulse.ConstantDetuning(P.BlackmanWaveform(300, 1.0), 1.0, 0.0),
            "ryd",
        )
        return seq

    jres = TpuEmulator.from_sequence(
        seq_of(tpu), with_modulation=True, evaluation_times="Minimal"
    ).run()
    n_steps = jax_solver.last_solve_info["n_steps"]
    tres = TorchEmulator.from_sequence(
        seq_of(ptt),
        with_modulation=True,
        evaluation_times="Minimal",
        torch_device="cpu",
    ).run()
    assert torch_solver.last_solve_info["n_steps"] == n_steps
    assert np.array_equal(tres._sim_times, jres._sim_times)
    assert tres._sim_times[-1] > 0.3  # the fall time is simulated
    got = tres.states[-1].full()[:, 0]
    want = np.asarray(jres.states[-1].full())[:, 0]
    assert np.max(np.abs(got - want)) <= 1e-12


NOISE = dict(
    amp_sigma=0.02,
    temperature=40,
    laser_waist=175,
    state_prep_error=0.05,
    p_false_pos=0.01,
    p_false_neg=0.02,
    runs=6,
    samples_per_run=4,
)


def _noisy4(P):
    reg = P.Register.rectangle(2, 2, spacing=7.0, prefix="q")
    seq = P.Sequence(reg, P.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(P.Pulse.ConstantPulse(400, 2 * np.pi, -1.0, 0.0), "ryd")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)  # runs=
        noise = P.NoiseModel(**NOISE)
    return seq, noise


def test_noisy_counts_equal_pulser_tpu(monkeypatch, double_precision):
    """SPAM + doppler + amplitude on 4 atoms, 6 trajectories of 4 samples,
    double precision, seed 77: equal counts at every evaluation time."""
    monkeypatch.setenv("PULSER_TPU_DISABLE_SHARDING", "1")
    monkeypatch.delenv("PULSER_TPU_PALLAS_INTERPRET", raising=False)
    monkeypatch.delenv("PULSER_TPU_SESOLVE_PALLAS_BATCHED", raising=False)
    assert jax.config.jax_enable_x64
    results, after = [], []
    for P in (tpu, ptt):
        seq, noise = _noisy4(P)
        kwargs = {"torch_device": "cpu"} if P is ptt else {}
        np.random.seed(77)
        emu = EMULATORS[P].from_sequence(
            seq, noise_model=noise, evaluation_times="Minimal", **kwargs
        )
        results.append(emu.run())
        after.append(np.random.rand())
    jres, tres = results
    assert after[0] == after[1]
    assert torch_solver.last_solve_info["kind"] == "sesolve_batched_torch"
    assert isinstance(tres, NoisyResults)
    assert np.array_equal(tres._sim_times, jres._sim_times)
    assert tres.n_measures == jres.n_measures == 24
    for t_res, j_res in zip(tres, jres):
        assert t_res.evaluation_time == j_res.evaluation_time
        assert dict(t_res.bitstring_counts) == dict(j_res.bitstring_counts)


def _refusals(P) -> list:
    Emulator = EMULATORS[P]
    kwargs = {"torch_device": "cpu"} if P is ptt else {}
    reg = P.Register.square(2, spacing=6.0, prefix="q")

    def parametrized():
        seq = P.Sequence(reg, P.MockDevice)
        seq.declare_channel("ryd", "rydberg_global")
        v = seq.declare_variable("v", dtype=float)
        seq.add(P.Pulse.ConstantPulse(100, v, 0.0, 0.0), "ryd")
        return seq

    def mappable():
        layout = P.register.RegisterLayout(
            [[6.0 * i, 6.0 * j] for i in range(3) for j in range(2)]
        )
        seq = P.Sequence(layout.make_mappable_register(2), P.MockDevice)
        seq.declare_channel("ryd", "rydberg_global")
        seq.add(P.Pulse.ConstantPulse(100, 1.0, 0.0, 0.0), "ryd")
        return seq

    def no_channel():
        return P.Sequence(reg, P.MockDevice)

    def no_instruction():
        seq = P.Sequence(reg, P.MockDevice)
        seq.declare_channel("ryd", "rydberg_global")
        return seq

    def masked():
        seq = P.Sequence(reg, P.DigitalAnalogDevice)
        seq.config_slm_mask(["q0"], "dmm_0")
        seq.declare_channel("ryd", "rydberg_global")
        seq.add(P.Pulse.ConstantPulse(100, 1.0, 0.0, 0.0), "ryd")
        return seq

    calls = [
        lambda: Emulator.from_sequence("sequence", **kwargs),
        lambda: Emulator.from_sequence(parametrized(), **kwargs),
        lambda: Emulator.from_sequence(mappable(), **kwargs),
        lambda: Emulator.from_sequence(no_channel(), **kwargs),
        lambda: Emulator.from_sequence(no_instruction(), **kwargs),
        lambda: Emulator.from_sequence(
            masked(), with_modulation=True, **kwargs
        ),
    ]
    out = []
    for call in calls:
        with pytest.raises(Exception) as err:
            call()
        out.append((err.type.__name__, str(err.value)))
    return out


def test_from_sequence_refusals_match():
    """Not a ``Sequence``, parametrized, mappable, no channel, no
    instruction, SLM mask with modulation: the JAX package's errors."""
    jax_errs, port_errs = (_refusals(P) for P in (tpu, ptt))
    assert jax_errs == port_errs
    assert [kind for kind, _ in port_errs] == [
        "TypeError",
        "ValueError",
        "ValueError",
        "ValueError",
        "ValueError",
        "NotImplementedError",
    ]


def test_from_sequence_needs_a_card_or_the_cpu(monkeypatch):
    """With no ``torch_device`` the entry runs on the card, and raises
    without one instead of moving to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seq = _afm10(ptt)
    with pytest.raises(RuntimeError, match="torch_device='cpu'"):
        TorchEmulator.from_sequence(seq)
    emu = TorchEmulator.from_sequence(seq, torch_device="cpu")
    assert emu._torch_device == torch.device("cpu")


@pytest.mark.parametrize("name", ["eom_mode", "global_local"])
def test_scenarios_reach_the_port_or_its_refusal(name):
    """A built scenario of ``test_torch_sequence.py`` enters
    ``from_sequence``: it runs (one basis) or raises the port's
    ``NotImplementedError`` naming ROADMAP.md (several bases are not
    ported), never anything else."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        seq = SCENARIOS[name](ptt, _rng(3))
    try:
        emu = TorchEmulator.from_sequence(
            seq, evaluation_times="Minimal", torch_device="cpu"
        )
        res = emu.run()
    except NotImplementedError as err:
        assert "ROADMAP" in str(err)
    else:
        final = res.get_final_state().full()
        assert np.isclose(np.linalg.norm(final), 1.0, atol=1e-5)
