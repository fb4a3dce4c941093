"""Waveforms, pulses and parametrized objects: the port against pulser_tpu.

Every scenario is written once as a function of a package namespace
``P`` and run with ``P = pulser_tpu`` and ``P = pulser_tpu_torch`` on
parameters made from a seed with numpy. Concrete values take the numpy
branch in both packages, in the same operation order, so every compared
array must be equal bit for bit (``==``, no tolerance), and every
compared scalar and string equal.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import pulser_tpu as tpu

import pulser_tpu_torch as ptt

torch.set_num_threads(1)

PACKAGES = (tpu, ptt)


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def _waveform_params(kind: str, seed: int) -> tuple:
    rng = _rng(seed)
    dur = int(rng.integers(16, 400))
    a, b = (float(x) for x in rng.uniform(-8.0, 8.0, 2))
    if kind == "constant":
        return (dur, a)
    if kind == "ramp":
        return (dur, a, b)
    if kind == "blackman":
        return (dur, a)
    if kind == "kaiser":
        return (dur, a, float(rng.uniform(2.0, 16.0)))
    if kind == "custom":
        return (rng.uniform(-3.0, 3.0, dur),)
    if kind == "interpolated":
        return (dur, rng.uniform(0.0, 5.0, int(rng.integers(3, 8))))
    if kind == "interpolated_times":
        k = int(rng.integers(3, 7))
        times = np.sort(rng.uniform(0.0, 1.0, k))
        times[0], times[-1] = 0.0, 1.0
        return (dur, rng.uniform(-2.0, 2.0, k), times)
    if kind == "composite":
        return (dur, a, b, int(rng.integers(8, 100)))
    raise AssertionError(kind)


def _make_waveform(P, kind: str, params: tuple):
    if kind == "constant":
        return P.ConstantWaveform(*params)
    if kind == "ramp":
        return P.RampWaveform(*params)
    if kind == "blackman":
        return P.BlackmanWaveform(*params)
    if kind == "kaiser":
        return P.KaiserWaveform(*params)
    if kind == "custom":
        return P.CustomWaveform(*params)
    if kind.startswith("interpolated"):
        return P.InterpolatedWaveform(*params)
    dur, a, b, dur2 = params
    return P.CompositeWaveform(
        P.RampWaveform(dur, a, b),
        P.ConstantWaveform(dur2, b),
        P.BlackmanWaveform(dur, abs(a) + 0.1),
    )


def _arr(x) -> np.ndarray:
    return np.asarray(x.as_array(detach=True))


def _waveform_facts(P, kind: str, params: tuple) -> dict:
    wf = _make_waveform(P, kind, params)
    mod_ch = P.AnalogDevice.channels["rydberg_global"]
    eom_ch = P.AnalogDevice.channels["rydberg_global"]
    facts = {
        "duration": wf.duration,
        "samples": _arr(wf.samples),
        "integral": wf.integral,
        "first": wf.first_value,
        "last": wf.last_value,
        "str": str(wf),
        "repr": repr(wf),
        "modulated": _arr(wf.modulated_samples(mod_ch)),
        "modulated_eom": _arr(wf.modulated_samples(eom_ch, eom=True)),
        "buffers": wf.modulation_buffers(mod_ch),
        "scaled": _arr((wf * 0.37).samples),
        "negated": _arr((-wf).samples),
        "divided": _arr((wf / 3.0).samples),
        "slice": _arr(wf[3:11]),
        "truncated": _arr(wf.truncated(7).samples),
        "hash_equal": hash(wf) == hash(_make_waveform(P, kind, params)),
    }
    if kind in ("constant", "ramp", "blackman", "kaiser") or kind.startswith(
        "interpolated"
    ):
        facts["new_duration"] = _arr(
            wf.with_new_duration(wf.duration + 13).samples
        )
    return facts


def _assert_same(a, b, where: str = "") -> None:
    """Equal, bit for bit where arrays or floats are compared."""
    assert type(a) is type(b) or (
        isinstance(a, (int, float, np.generic))
        and isinstance(b, (int, float, np.generic))
    ), (where, type(a), type(b))
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b), where
    else:
        assert a == b, (where, a, b)


WAVEFORM_KINDS = (
    "constant",
    "ramp",
    "blackman",
    "kaiser",
    "custom",
    "interpolated",
    "interpolated_times",
    "composite",
)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", WAVEFORM_KINDS)
def test_waveform_bit_exact(kind, seed):
    """samples, integral, first/last value, modulated samples, arithmetic,
    slicing, truncation and strings: ``==`` between the packages."""
    params = _waveform_params(kind, 100 * seed + len(kind))
    jax_facts, port_facts = (
        _waveform_facts(P, kind, params) for P in PACKAGES
    )
    assert isinstance(port_facts["integral"], float)
    _assert_same(jax_facts, port_facts, kind)


@pytest.mark.parametrize(
    "cls, max_val, area, extra",
    [
        ("BlackmanWaveform", 2 * np.pi, np.pi, ()),
        ("BlackmanWaveform", -3.0, -1.7, ()),
        ("BlackmanWaveform", 11.0, 0.25, ()),
        ("KaiserWaveform", 2 * np.pi, np.pi, ()),
        ("KaiserWaveform", -4.0, -2.2, (9.0,)),
        ("KaiserWaveform", 30.0, 0.04, (3.5,)),
    ],
)
def test_from_max_val_bit_exact(cls, max_val, area, extra):
    out = []
    for P in PACKAGES:
        wf = getattr(P, cls).from_max_val(max_val, area, *extra)
        out.append((wf.duration, _arr(wf.samples), repr(wf)))
    _assert_same(out[0], out[1], cls)


def _raised(calls) -> list:
    """(error type, message) of each call, the package's name taken out."""
    out = []
    for call in calls:
        with pytest.raises(Exception) as err:
            call()
        out.append(
            (
                err.type.__name__,
                str(err.value).replace("pulser_tpu_torch", "pulser_tpu"),
            )
        )
    return out


def _waveform_errors(P) -> list:
    calls = [
        lambda: P.ConstantWaveform(0, 1.0),
        lambda: P.ConstantWaveform("abc", 1.0),
        lambda: P.RampWaveform(10, "x", 1.0),
        lambda: P.CompositeWaveform(P.ConstantWaveform(10, 1.0)),
        lambda: P.CompositeWaveform(P.ConstantWaveform(10, 1.0), 3),
        lambda: P.KaiserWaveform(100, 1.0, -1.0),
        lambda: P.BlackmanWaveform.from_max_val(-1.0, 1.0),
        lambda: P.InterpolatedWaveform(100, [1, 2, 3], times=[0, 0.5, 1.5]),
        lambda: P.InterpolatedWaveform(100, [1, 2, 3], times=[0, 0.5]),
        lambda: P.InterpolatedWaveform(100, [1, 2], interpolator="spline"),
        lambda: P.ConstantWaveform(10, 1.0) / 0,
        lambda: P.ConstantWaveform(10, 1.0)[10],
        lambda: P.ConstantWaveform(10, 1.0)[0:5:2],
        lambda: P.CustomWaveform([1.0, 2.0]).with_new_duration(5),
    ]
    return _raised(calls)


def test_waveform_errors_match():
    """The same error type and message for 14 invalid calls."""
    jax_errs, port_errs = (_waveform_errors(P) for P in PACKAGES)
    assert jax_errs == port_errs


# --- Pulse ---------------------------------------------------------------


def _pulse_facts(P, ctor: str, seed: int) -> dict:
    rng = _rng(seed)
    dur = int(rng.integers(20, 300))
    amp, det, phase, post = (float(x) for x in rng.uniform(0.1, 6.0, 4))
    if ctor == "Pulse":
        pulse = P.Pulse(
            P.BlackmanWaveform(dur, amp),
            P.RampWaveform(dur, -det, det),
            phase,
            post,
        )
    elif ctor == "ConstantDetuning":
        pulse = P.Pulse.ConstantDetuning(
            P.RampWaveform(dur, 0.0, amp), -det, phase, post
        )
    elif ctor == "ConstantAmplitude":
        pulse = P.Pulse.ConstantAmplitude(
            amp, P.RampWaveform(dur, -det, det), phase
        )
    elif ctor == "ConstantPulse":
        pulse = P.Pulse.ConstantPulse(dur, amp, -det, phase + 7.0)
    elif ctor == "ArbitraryPhase":
        pulse = P.Pulse.ArbitraryPhase(
            P.ConstantWaveform(dur, amp),
            P.InterpolatedWaveform(dur, rng.uniform(0.0, 3.0, 5)),
            post,
        )
    elif ctor == "ArbitraryPhaseRamp":
        pulse = P.Pulse.ArbitraryPhase(
            P.ConstantWaveform(dur, amp), P.RampWaveform(dur, 0.0, phase)
        )
    else:
        raise AssertionError(ctor)
    channels = P.AnalogDevice.channels
    ch = channels["rydberg_global"]
    return {
        "duration": pulse.duration,
        "amp": _arr(pulse.amplitude.samples),
        "det": _arr(pulse.detuning.samples),
        "phase": float(pulse.phase),
        "post": pulse.post_phase_shift,
        "str": str(pulse),
        "repr": repr(pulse),
        "fall_time": pulse.fall_time(ch),
        "fall_time_eom": pulse.fall_time(ch, in_eom_mode=True),
        "full": pulse.get_full_duration(ch),
        "full_eom": pulse.get_full_duration(ch, in_eom_mode=True),
        "eq": pulse == pulse and pulse != "pulse",
        "hash": hash(pulse) == hash(pulse),
    }


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize(
    "ctor",
    [
        "Pulse",
        "ConstantDetuning",
        "ConstantAmplitude",
        "ConstantPulse",
        "ArbitraryPhase",
        "ArbitraryPhaseRamp",
    ],
)
def test_pulse_bit_exact(ctor, seed):
    """The four constructors (and ``Pulse`` itself), ``fall_time`` and
    ``get_full_duration``: ``==`` between the packages."""
    jax_facts, port_facts = (_pulse_facts(P, ctor, seed) for P in PACKAGES)
    _assert_same(jax_facts, port_facts, ctor)


def _pulse_errors(P) -> list:
    ch = P.AnalogDevice.channels["rydberg_global"]
    no_eom = P.MockDevice.channels["rydberg_global"]
    wf = P.ConstantWaveform(100, 1.0)
    calls = [
        lambda: P.Pulse(wf, 1.0, 0.0),
        lambda: P.Pulse(wf, P.ConstantWaveform(50, 1.0), 0.0),
        lambda: P.Pulse(P.RampWaveform(100, -1.0, 1.0), wf, 0.0),
        lambda: P.Pulse(wf, wf, [0.0, 1.0]),
        lambda: P.Pulse.ArbitraryPhase(wf, 1.0),
        lambda: P.Pulse.ConstantPulse(100, 1.0, 0.0, 0.0).get_full_duration(
            "ch"
        ),
        lambda: P.Pulse.ConstantPulse(100, 1.0, 0.0, 0.0).get_full_duration(
            no_eom, in_eom_mode=True
        ),
        lambda: ch.validate_pulse(wf),
        lambda: ch.validate_pulse(P.Pulse.ConstantPulse(100, 1e4, 0.0, 0.0)),
        lambda: ch.validate_pulse(P.Pulse.ConstantPulse(100, 1.0, 1e4, 0.0)),
    ]
    return _raised(calls)


def test_pulse_errors_match():
    """The same error type and message for 10 invalid calls, the restored
    ``Channel.validate_pulse`` among them."""
    jax_errs, port_errs = (_pulse_errors(P) for P in PACKAGES)
    assert jax_errs == port_errs


def _dmm_validate(P) -> list:
    dmm = P.AnalogDevice.dmm_channels
    device = P.DigitalAnalogDevice
    dmm = device.dmm_channels["dmm_0"]
    out = []
    for det in (-1.0, 1.0, -1e5):
        pulse = P.Pulse.ConstantPulse(100, 0.0, det, 0.0)
        try:
            dmm.validate_pulse(pulse)
            out.append("ok")
        except ValueError as e:
            out.append(str(e))
    return out


def test_dmm_validate_pulse_matches():
    jax_out, port_out = (_dmm_validate(P) for P in PACKAGES)
    assert jax_out == port_out
    assert jax_out[0] == "ok" and jax_out[1] != "ok" and jax_out[2] != "ok"


# --- Variable / ParamObj --------------------------------------------------


def _param_facts(P, seed: int) -> dict:
    rng = _rng(seed)
    vals = rng.uniform(0.5, 3.0, 3)
    Variable = P.parametrized.Variable
    x = Variable("x", float, size=3)
    n = Variable("n", int)
    exprs = {
        "add": x[0] + 2.0,
        "radd": 2.0 + x[1],
        "sub": x[0] - x[2],
        "rsub": 1.0 - x[2],
        "mul": x[1] * x[2],
        "div": x[0] / x[1],
        "rdiv": 3.0 / x[1],
        "pow": x[0] ** 2,
        "rpow": 2 ** x[0],
        "mod": x[2] % 0.7,
        "neg": -x[0],
        "abs": abs(-x[1]),
        "floordiv": x[0] // 0.3,
        "round": round(x[1] * 10, 2),
        "sqrt": np.sqrt(x[0]),
        "exp": np.exp(x[1]),
        "log": np.log(x[2]),
        "log2": np.log2(x[2]),
        "sin": np.sin(x[0]),
        "cos": np.cos(x[0]),
        "tan": np.tan(x[1]),
        "tanh": np.tanh(x[1]),
        "ceil": np.ceil(x[2]),
        "floor": np.floor(x[2]),
        "slice": x[0:2] * 2,
        "int": n * 3 + 1,
        "wf": P.RampWaveform(n * 10, x[0], x[1] * 2),
        "pulse": P.Pulse.ConstantDetuning(
            P.BlackmanWaveform(n * 25, x[0]), -x[1], x[2]
        ),
        "from_max_val": P.BlackmanWaveform.from_max_val(x[0] * 4, x[1]),
        "interp": P.InterpolatedWaveform(200, x),
    }
    strs = {k: str(v) for k, v in exprs.items()}
    kinds = {k: type(v).__name__ for k, v in exprs.items()}
    x._assign(vals)
    n._assign(4)
    built = {}
    for k, v in exprs.items():
        b = v.build()
        if k in ("wf", "from_max_val", "interp"):
            built[k] = (repr(b), _arr(b.samples))
        elif k == "pulse":
            built[k] = (
                repr(b),
                _arr(b.amplitude.samples),
                _arr(b.detuning.samples),
                float(b.phase),
            )
        else:
            built[k] = _arr(b)
    return {
        "strs": strs,
        "kinds": kinds,
        "built": built,
        "variables": sorted(exprs["pulse"].variables),
        "len": len(x),
        "items": [str(i) for i in x],
    }


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_variable_paramobj_arithmetic_bit_exact(seed):
    """Deferred arithmetic, math functions, waveforms and pulses of
    variables: the same strings, and the same built values (``==``)."""
    jax_facts, port_facts = (_param_facts(P, seed) for P in PACKAGES)
    _assert_same(jax_facts, port_facts, "param")


def _variable_errors(P) -> list:
    Variable = P.parametrized.Variable
    x = Variable("x", float, size=2)
    calls = [
        lambda: Variable(3, float),
        lambda: Variable("y", str),
        lambda: Variable("y", float, size=0),
        lambda: Variable("y", float, size=1.5),
        lambda: x._assign([1.0, 2.0, 3.0]),
        lambda: x[2],
        lambda: x["a"],
        lambda: Variable("z", float).build(),
    ]
    return _raised(calls)


def test_variable_errors_match():
    jax_errs, port_errs = (_variable_errors(P) for P in PACKAGES)
    assert jax_errs == port_errs
