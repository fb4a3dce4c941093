"""Host layers of the PyTorch port are bit-exact against pulser_tpu.

The same sequence is built and sampled with ``pulser_tpu``, carried
across with :mod:`pulser_tpu_torch.interop`, and every host-side value
on the way to the solver is compared with ``np.array_equal``: samples,
register, device, interaction diagonal, Hamiltonian coefficients, the
chosen step and coarsening flag, and every array of the evolution plan.
The 16-atom case stops at the plan (no solve).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import pulser_tpu as tpu
import pulser_tpu.emulator.simulation as jax_sim
from pulser_tpu.emulator import TpuEmulator

import pulser_tpu_torch.ops.solver as torch_solver
from pulser_tpu_torch.emulator import TorchEmulator
from pulser_tpu_torch.interop import (
    from_jax_device,
    from_jax_register,
    from_jax_samples,
)

torch.set_num_threads(1)


def _afm_sequence(rows, cols, t_rise, t_sweep, t_fall):
    """The BASELINE AFM sweep (``bench.py:33``) on a rows x cols array."""
    reg = tpu.Register.rectangle(rows, cols, spacing=6.0, prefix="q")
    seq = tpu.Sequence(reg, tpu.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    omega_max = 2.0 * 2 * np.pi
    delta_0 = -6 * 2 * np.pi
    delta_f = 2 * 2 * np.pi
    seq.add(
        tpu.Pulse.ConstantDetuning(
            tpu.RampWaveform(t_rise, 0.0, omega_max), delta_0, 0.0
        ),
        "ryd",
    )
    seq.add(
        tpu.Pulse.ConstantAmplitude(
            omega_max, tpu.RampWaveform(t_sweep, delta_0, delta_f), 0.0
        ),
        "ryd",
    )
    seq.add(
        tpu.Pulse.ConstantDetuning(
            tpu.RampWaveform(t_fall, omega_max, 0.0), delta_f, 0.0
        ),
        "ryd",
    )
    return seq


def _bell_sequence():
    reg = tpu.Register({"q0": (-2.5, 0.0), "q1": (2.5, 0.0)})
    seq = tpu.Sequence(reg, tpu.AnalogDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(
        tpu.Pulse.ConstantDetuning(
            tpu.BlackmanWaveform(1000, np.pi * np.sqrt(2)), 0.0, 0.0
        ),
        "ryd",
    )
    return seq


CONFIGS = {
    "afm10": lambda: _afm_sequence(2, 5, 100, 400, 100),
    "afm16": lambda: _afm_sequence(4, 4, 252, 2700, 252),
    "bell": _bell_sequence,
}


class _PlanOnly(Exception):
    """Raised by the stubbed solvers once the plan is built."""


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    """``(JAX emulator, port emulator, JAX samples, sequence)``, with
    both emulators stopped right before their solve."""
    seq = CONFIGS[request.param]()
    samples = tpu.sampler.sample(seq)
    jax_emu = TpuEmulator.from_sequence(seq)
    torch_emu = TorchEmulator(
        from_jax_samples(samples),
        from_jax_register(seq.register),
        from_jax_device(seq.device),
        torch_device="cpu",
    )

    def stop(*args, **kwargs):
        raise _PlanOnly

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_sim, "sesolve_rk4", stop)
        mp.setattr(torch_solver, "sesolve_rk4", stop)
        for emu in (jax_emu, torch_emu):
            with pytest.raises(_PlanOnly):
                emu.run()
    return jax_emu, torch_emu, samples, seq


def test_samples_carry_across_bit_exact(pair):
    _, torch_emu, samples, _ = pair
    ported = from_jax_samples(samples)
    assert ported.channels == samples.channels
    for jcs, tcs in zip(samples.samples_list, ported.samples_list):
        for name in ("amp", "det", "phase"):
            assert np.array_equal(
                getattr(jcs, name).as_array(), getattr(tcs, name).as_array()
            )
        assert [(s.ti, s.tf, s.targets) for s in jcs.slots] == [
            (s.ti, s.tf, s.targets) for s in tcs.slots
        ]
        assert len(jcs.eom_blocks) == len(tcs.eom_blocks)
    for ch in samples.channels:
        assert repr(samples._ch_objs[ch]) == repr(ported._ch_objs[ch])
    assert ported._slm_mask.targets == samples._slm_mask.targets
    assert ported._slm_mask.end == samples._slm_mask.end
    assert ported.max_duration == samples.max_duration


def test_register_and_device_carry_across(pair):
    _, _, _, seq = pair
    reg = from_jax_register(seq.register)
    assert reg.qubit_ids == seq.register.qubit_ids
    for qid, pos in seq.register.qubits.items():
        assert np.array_equal(reg.qubits[qid].as_array(), pos.as_array())
    dev = from_jax_device(seq.device)
    for f in dataclasses.fields(dev):
        if f.name in ("channel_objects", "dmm_objects"):
            continue
        if f.name == "pre_calibrated_layouts":
            # Layouts of two packages: the same class name, slug and hash
            assert [
                (type(x).__name__, str(x), x.static_hash())
                for x in getattr(dev, f.name)
            ] == [
                (type(x).__name__, str(x), x.static_hash())
                for x in getattr(seq.device, f.name)
            ]
            continue
        assert getattr(dev, f.name) == getattr(seq.device, f.name), f.name
    assert [repr(c) for c in dev.channel_objects] == [
        repr(c) for c in seq.device.channel_objects
    ]
    assert dev.interaction_coeff == seq.device.interaction_coeff


def test_hamiltonian_bit_exact(pair):
    jax_emu, torch_emu, _, _ = pair
    jh = jax_emu._current_hamiltonian
    th = torch_emu._current_hamiltonian
    assert np.array_equal(jh.int_diag, th.int_diag)
    assert np.array_equal(jh.amp_coeffs, th.amp_coeffs)
    assert np.array_equal(jh.det_coeffs, th.det_coeffs)
    assert np.array_equal(jh.sampling_times, th.sampling_times)
    assert jh.pairs == th.pairs
    assert np.array_equal(
        jax_emu._eval_times_array, torch_emu._eval_times_array
    )


def test_step_policy_matches(pair):
    jax_emu, torch_emu, _, _ = pair
    # plan keys: (..., eval-times bytes, max_step, coarsen)
    assert jax_emu._plan_cache[0][1:] == torch_emu._plan_cache[0]


def test_evolution_plan_bit_exact(pair):
    jax_emu, torch_emu, _, _ = pair
    jp = jax_emu._plan_cache[1]
    tp = torch_emu._plan_cache[1]
    for f in dataclasses.fields(jp):
        if f.name in ("runtime_cache", "stage_arrays", "stage_knots"):
            continue
        assert np.array_equal(getattr(jp, f.name), getattr(tp, f.name)), (
            f.name
        )
    assert jp.stage_arrays.keys() == tp.stage_arrays.keys()
    for name, arr in jp.stage_arrays.items():
        assert np.array_equal(arr, tp.stage_arrays[name]), name
    for a, b in zip(jp.stage_knots, tp.stage_knots):
        assert np.array_equal(a, b)


def _phase_steps(samples):
    """The phase references as their (time, phase) breakpoints."""
    return {
        basis: {q: ref.phase._steps for q, ref in refs.items()}
        for basis, refs in samples._basis_ref.items()
    }


def test_chip_smoke_afm16_inputs_match_the_sampler():
    """The smoke script's 16-atom samples, built and sampled by the port,
    equal ``pulser_tpu.sampler.sample(seq)`` bit for bit."""
    import chip_smoke

    seq = CONFIGS["afm16"]()
    expected = from_jax_samples(tpu.sampler.sample(seq))
    samples, register, device = chip_smoke.afm16_inputs()
    assert samples.channels == expected.channels
    (got,), (want,) = samples.samples_list, expected.samples_list
    for name in ("amp", "det", "phase"):
        assert np.array_equal(
            getattr(got, name).as_array(), getattr(want, name).as_array()
        )
    assert got.slots == want.slots
    assert got.target_time_slots == want.target_time_slots
    assert _phase_steps(samples) == _phase_steps(expected)
    assert repr(samples._ch_objs["ryd"]) == repr(expected._ch_objs["ryd"])
    assert register.qubit_ids == seq.register.qubit_ids
    for qid, pos in seq.register.qubits.items():
        assert np.array_equal(register.qubits[qid].as_array(), pos.as_array())
    assert device.name == seq.device.name


def test_chip_smoke_afm16_plan_matches_pulser_tpu():
    """The smoke script's main path (101 evaluation times) gets the same
    step policy and plan as ``pulser_tpu``."""
    import chip_smoke

    seq = CONFIGS["afm16"]()
    eval_times = np.linspace(0, seq.get_duration() * 1e-3, 101)
    jax_emu = TpuEmulator.from_sequence(seq, evaluation_times=eval_times)
    torch_emu = TorchEmulator(
        *chip_smoke.afm16_inputs(),
        evaluation_times=eval_times,
        torch_device="cpu",
    )

    def stop(*args, **kwargs):
        raise _PlanOnly

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_sim, "sesolve_rk4", stop)
        mp.setattr(torch_solver, "sesolve_rk4", stop)
        for emu in (jax_emu, torch_emu):
            with pytest.raises(_PlanOnly):
                emu.run()
    assert jax_emu._plan_cache[0][1:] == torch_emu._plan_cache[0]
    jp, tp = jax_emu._plan_cache[1], torch_emu._plan_cache[1]
    assert np.array_equal(jp.seg_dts, tp.seg_dts)
    assert np.array_equal(jp.grid, tp.grid)
    for name, arr in jp.stage_arrays.items():
        assert np.array_equal(arr, tp.stage_arrays[name]), name
