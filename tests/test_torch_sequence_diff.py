"""Differentiability of the port's sequence → sampler pipeline.

The torch counterparts of ``tests/test_sequence_diff.py``: each loss is
written once as a function of a package namespace ``P`` and run under
``jax.grad`` (``P = pulser_tpu``) and ``torch.autograd.grad``
(``P = pulser_tpu_torch``) on the same float64 parameters. Both
backends differentiate the same numpy-ordered arithmetic in double
precision, so the gradients must agree to 1e-9 relative (to the
gradient's largest entry), and the loss values to 1e-12 relative.
A value is live in the port when it is a tensor that requires grad;
concrete values stay Python floats.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import pulser_tpu as tpu

import pulser_tpu_torch as ptt

torch.set_num_threads(1)

GRAD_RTOL = 1e-9
VALUE_RTOL = 1e-12


@pytest.fixture(autouse=True)
def double_precision():
    """float64 on both sides (``tests/conftest.py`` enables x64 in JAX)."""
    assert jax.config.jax_enable_x64
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(torch.float32)


def _total(x):
    t = x.as_tensor() if hasattr(x, "as_tensor") else x
    if isinstance(t, torch.Tensor):
        return t.abs().sum()
    return jnp.sum(jnp.abs(t))


def _value_and_grad(loss, P, params) -> tuple[float, np.ndarray]:
    """``loss(P, params)`` and its gradient by the package's backend."""
    if P is tpu:
        value, grad = jax.value_and_grad(lambda p: loss(P, p))(
            jnp.asarray(params, jnp.float64)
        )
        return float(value), np.asarray(grad)
    p = torch.tensor(params, dtype=torch.float64, requires_grad=True)
    value = loss(P, p)
    assert isinstance(value, torch.Tensor) and value.requires_grad
    (grad,) = torch.autograd.grad(value, p)
    return float(value.detach()), grad.numpy()


def _assert_grads_agree(loss, params, nonzero=None) -> np.ndarray:
    jv, jg = _value_and_grad(loss, tpu, params)
    tv, tg = _value_and_grad(loss, ptt, params)
    assert np.all(np.isfinite(tg)), tg
    assert abs(tv - jv) <= VALUE_RTOL * abs(jv), (tv, jv)
    assert np.max(np.abs(tg - jg)) <= GRAD_RTOL * np.max(np.abs(jg)), (tg, jg)
    idx = slice(None) if nonzero is None else nonzero
    assert np.abs(tg[idx]).min() > 0.0, tg
    return tg


def _mod_device(P):
    """A device with modulated, EOM-capable channels and two DMMs (the
    second one modulated), as the ``mod_device`` fixture of the JAX
    package's tests."""
    ch = P.channels
    return P.devices.Device(
        name="ModDevice",
        dimensions=3,
        rydberg_level=70,
        max_atom_num=2000,
        max_radial_distance=1000,
        min_atom_distance=1,
        supports_slm_mask=True,
        channel_objects=(
            ch.Rydberg.Global(
                1000,
                200,
                clock_period=1,
                min_duration=1,
                mod_bandwidth=4.0,
                eom_config=ch.eom.RydbergEOM(
                    mod_bandwidth=30.0,
                    limiting_beam=ch.eom.RydbergBeam.RED,
                    max_limiting_amp=50 * 2 * np.pi,
                    intermediate_detuning=800 * 2 * np.pi,
                    controlled_beams=(ch.eom.RydbergBeam.BLUE,),
                ),
            ),
        ),
        dmm_objects=(
            ch.DMM(bottom_detuning=-100, total_bottom_detuning=-10000),
            ch.DMM(
                clock_period=4,
                mod_bandwidth=4.0,
                bottom_detuning=-50,
                total_bottom_detuning=-5000,
            ),
        ),
    )


@pytest.mark.parametrize("with_modulation", [False, True])
@pytest.mark.parametrize("parametrized", [False, True])
def test_diff_through_pulse_and_dmm(parametrized, with_modulation):
    """Gradients through a Blackman pulse and a DMM ramp, concrete and
    through a parametrized build, with and without output modulation."""

    def loss(P, params):
        amp, det_a, det_b, phase = params
        reg = P.Register.from_coordinates(
            [(0.0, 0.0), (-5.0, 5.0)], prefix="q"
        )
        seq = P.Sequence(
            reg, _mod_device(P) if with_modulation else P.MockDevice
        )
        seq.declare_channel("ryd_global", "rydberg_global")
        area = (
            seq.declare_variable("v_amp", dtype=float)
            if parametrized
            else amp
        )
        seq.add(
            P.Pulse.ConstantDetuning(
                P.BlackmanWaveform(1000, area), det_a, phase
            ),
            "ryd_global",
        )
        det_map = reg.define_detuning_map({"q0": 1.0})
        # The device's first DMM has no modulation bandwidth
        dmm_id = "dmm_1" if with_modulation else "dmm_0"
        seq.config_detuning_map(det_map, dmm_id)
        seq.add_dmm_detuning(P.RampWaveform(2000, det_a, det_b), dmm_id)
        if parametrized:
            seq = seq.build(v_amp=amp)
        s = P.sampler.sample(seq, modulation=with_modulation)
        ryd = s.channel_samples["ryd_global"]
        dmm = s.channel_samples[dmm_id]
        assert ryd.amp.is_tensor and dmm.det.is_tensor
        return (
            _total(ryd.amp)
            + _total(ryd.det)
            + _total(ryd.phase)
            + _total(dmm.det)
        )

    _assert_grads_agree(loss, [1.0, -2.0, -1.0, 2.0])


@pytest.mark.parametrize("with_modulation", [False, True])
def test_diff_through_eom_mode(with_modulation):
    """Gradients through EOM enable, setpoint change and pulses with
    phase-drift correction."""

    def loss(P, params):
        amp, det_on, det_off, phase = params
        reg = P.Register.from_coordinates(
            [(0.0, 0.0), (-5.0, 5.0)], prefix="q"
        )
        seq = P.Sequence(reg, P.AnalogDevice)
        seq.declare_channel("ryd_global", "rydberg_global")
        seq.enable_eom_mode("ryd_global", amp, det_on, det_off)
        seq.add_eom_pulse(
            "ryd_global", 100, phase, correct_phase_drift=False
        )
        seq.delay(100, "ryd_global")
        seq.modify_eom_setpoint("ryd_global", amp * 2, det_off, -det_on)
        seq.add_eom_pulse(
            "ryd_global", 100, -phase, correct_phase_drift=True
        )
        seq.disable_eom_mode("ryd_global")
        s = P.sampler.sample(seq, modulation=with_modulation)
        ch = s.channel_samples["ryd_global"]
        return _total(ch.amp) + _total(ch.det) + _total(ch.phase)

    # amp and the detunings all matter
    _assert_grads_agree(loss, [1.0, -2.0, -1.0, 2.0], nonzero=slice(0, 3))


def test_diff_through_register_coordinates():
    """Register construction accepts live coordinates and keeps them."""

    def loss(P, params):
        (x,) = params
        if P is tpu:
            coords = jnp.stack(
                [jnp.stack([x, jnp.float64(0.0)]), jnp.asarray([5.0, 0.0])]
            )
        else:
            coords = torch.stack(
                [torch.stack([x, torch.tensor(0.0)]), torch.tensor([5.0, 0.0])]
            )
        reg = P.Register.from_coordinates(coords, center=False, prefix="q")
        q = reg.qubits
        d = q["q1"].as_tensor() - q["q0"].as_tensor()
        return (d**2).sum()

    grad = _assert_grads_agree(loss, [1.0])
    assert grad[0] == pytest.approx(-8.0)  # d/dx (5 - x)^2 at x = 1


def test_diff_parametrized_phase_preserved():
    """The pulse phase is never a variable; its gradient survives a
    parametrized build."""

    def loss(P, params):
        (phase,) = params
        reg = P.Register.from_coordinates([(0.0, 0.0)], prefix="q")
        seq = P.Sequence(reg, P.DigitalAnalogDevice)
        seq.declare_channel("ryd_global", "rydberg_global")
        v = seq.declare_variable("v", dtype=float)
        seq.add(
            P.Pulse.ConstantDetuning(
                P.BlackmanWaveform(500, v), -1.0, phase
            ),
            "ryd_global",
        )
        built = seq.build(v=1.0)
        ch = P.sampler.sample(built).channel_samples["ryd_global"]
        return _total(ch.phase)

    grad = _assert_grads_agree(loss, [2.0])
    assert grad[0] == pytest.approx(500.0, rel=1e-9)


WAVEFORM_SCALARS = {
    # The Blackman area parameter is the integral
    "blackman_integral": (
        lambda P, a: P.BlackmanWaveform(1000, a).integral, np.pi, 1.0,
    ),
    # d/dstop of (start + stop) / 2 over 1 µs
    "ramp_integral": (
        lambda P, s: P.RampWaveform(1000, 0.0, s).integral, 2.0, 0.5,
    ),
    "ramp_last_value": (
        lambda P, s: P.RampWaveform(1000, 0.0, s).last_value, 2.0, 1.0,
    ),
    "ramp_first_value": (
        lambda P, s: P.RampWaveform(1000, s, 5.0).first_value, 2.0, 1.0,
    ),
    "kaiser_integral": (
        lambda P, a: P.KaiserWaveform(800, a, 9.0).integral, 1.3, 1.0,
    ),
    "composite_integral": (
        lambda P, a: P.CompositeWaveform(
            P.ConstantWaveform(100, a), P.RampWaveform(100, a, 0.0)
        ).integral,
        3.0,
        0.15,
    ),
    "scaled_custom_integral": (
        lambda P, a: (P.CustomWaveform(np.arange(50.0)) * a).integral,
        0.5,
        1.225,
    ),
}


@pytest.mark.parametrize("case", list(WAVEFORM_SCALARS))
def test_waveform_scalars_stay_differentiable(case):
    """``integral``, ``first_value`` and ``last_value`` pass a live value
    through instead of casting it to a host float."""
    fn, at, expected = WAVEFORM_SCALARS[case]

    def loss(P, params):
        out = fn(P, params[0])
        return out.as_tensor() if hasattr(out, "as_tensor") else out

    grad = _assert_grads_agree(loss, [at])
    assert grad[0] == pytest.approx(expected, rel=1e-9)


def test_concrete_values_stay_floats():
    wf = ptt.BlackmanWaveform(1000, np.pi)
    assert isinstance(wf.integral, float)
    assert isinstance(wf.first_value, float)
    assert isinstance(wf.last_value, float)
    assert wf.integral == pytest.approx(np.pi)
    assert not wf.samples.is_tensor
    # A tensor that does not require grad is a concrete value too
    ramp = ptt.RampWaveform(100, 0.0, torch.tensor(2.0))
    assert isinstance(ramp.integral, float)
    assert isinstance(ramp.last_value, float)
    assert ramp.last_value == 2.0
