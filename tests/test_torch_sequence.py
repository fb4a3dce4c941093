"""``Sequence``: the port against pulser_tpu, scenario by scenario.

Each scenario is a function of a package namespace ``P`` (``pulser_tpu``
or ``pulser_tpu_torch``) and a numpy generator made from a seed; it is
run with both packages on the same numbers. ``Sequence`` works on
concrete values in numpy in both packages, in the same operation order:
everything compared here must be equal (``==``), with no tolerance.
:data:`SCENARIOS` and :func:`sequence_facts` are shared with
``test_torch_sampler.py`` and ``test_torch_from_sequence.py``.
"""

from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

import pulser_tpu as tpu

import pulser_tpu_torch as ptt

torch.set_num_threads(1)

PACKAGES = (tpu, ptt)


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def _u(rng, lo: float, hi: float) -> float:
    return float(rng.uniform(lo, hi))


# --- scenarios -------------------------------------------------------------


def global_local(P, rng):
    """Global + local channels in two bases: target, align, delay, phase
    shifts, all three protocols, measure."""
    reg = P.Register.square(2, spacing=6.0, prefix="q")
    seq = P.Sequence(reg, P.DigitalAnalogDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.declare_channel("loc", "rydberg_local", initial_target="q0")
    seq.declare_channel("ram", "raman_local", initial_target="q1")
    amp, det, phi = _u(rng, 1, 6), _u(rng, -8, 8), _u(rng, 0, 6)
    seq.add(P.Pulse.ConstantPulse(200, amp, det, phi), "ryd")
    seq.add(
        P.Pulse.ConstantDetuning(P.BlackmanWaveform(152, amp / 2), det, 0.0),
        "loc",
        protocol="min-delay",
    )
    seq.target("q2", "loc")
    seq.add(
        P.Pulse.ConstantAmplitude(
            amp, P.RampWaveform(300, -det, det), phi, post_phase_shift=0.7
        ),
        "ram",
        protocol="no-delay",
    )
    seq.phase_shift(_u(rng, 0, 3), "q1", "q3", basis="digital")
    seq.target({"q3"}, "ram")
    seq.delay(96, "ram")
    seq.add(
        P.Pulse.ConstantPulse(100, amp, 0.0, 0.0),
        "ram",
        protocol="wait-for-all",
    )
    seq.align("ryd", "loc")
    seq.phase_shift_index(_u(rng, 0, 3), basis="ground-rydberg")
    seq.add(P.Pulse.ConstantPulse(120, amp, -det, phi / 2), "loc")
    seq.target_index(1, "loc")
    seq.add(P.Pulse.ConstantPulse(80, amp / 3, det, 0.0), "ryd")
    seq.phase_shift_index(_u(rng, 0, 3), 0, 2, basis="ground-rydberg")
    seq.measure("digital")
    return seq


def _eom_body(P, rng):
    reg = P.Register.rectangle(1, 3, spacing=7.0, prefix="q")
    seq = P.Sequence(reg, P.AnalogDevice)
    seq.declare_channel("ryd", "rydberg_global")
    amp, det, phi = _u(rng, 1, 8), _u(rng, -4, 4), _u(rng, 0, 6)
    seq.add(P.Pulse.ConstantPulse(100, amp / 2, det, phi), "ryd")
    seq.enable_eom_mode(
        "ryd", amp_on=amp, detuning_on=det, optimal_detuning_off=-10.0
    )
    seq.add_eom_pulse("ryd", 100, phi)
    seq.delay(200, "ryd")
    seq.add_eom_pulse("ryd", 60, 0.0, post_phase_shift=0.3)
    seq.modify_eom_setpoint(
        "ryd",
        amp_on=amp * 1.5,
        detuning_on=-det,
        optimal_detuning_off=-20.0,
        correct_phase_drift=True,
    )
    seq.add_eom_pulse("ryd", 80, phi / 3, correct_phase_drift=True)
    seq.delay(40, "ryd")
    seq.disable_eom_mode("ryd", correct_phase_drift=True)
    seq.add(
        P.Pulse.ConstantDetuning(P.BlackmanWaveform(200, 1.0), 0.0, 0.0),
        "ryd",
    )
    seq.delay(100, "ryd", at_rest=True)
    seq.enable_eom_mode("ryd", amp, 0.0, correct_phase_drift=True)
    seq.add_eom_pulse("ryd", 52, 1.0)
    seq.disable_eom_mode("ryd")
    return seq


def eom_mode(P, rng):
    """EOM mode: setpoint changes, detuned delays, phase-drift
    correction, a regular pulse afterwards, measured."""
    seq = _eom_body(P, rng)
    seq.measure()
    return seq


def dmm_detuning(P, rng):
    """A detuning map on a DMM beside a global drive."""
    reg = P.Register.rectangle(2, 2, spacing=6.0, prefix="q")
    seq = P.Sequence(reg, P.DigitalAnalogDevice)
    seq.declare_channel("ryd", "rydberg_global")
    weights = rng.uniform(0.1, 1.0, 3)
    det_map = reg.define_detuning_map(
        {f"q{i}": float(w) for i, w in enumerate(weights)}
    )
    seq.config_detuning_map(det_map, "dmm_0")
    amp, det = _u(rng, 1, 6), _u(rng, 0.5, 4)
    seq.add(P.Pulse.ConstantPulse(300, amp, 0.0, 0.0), "ryd")
    seq.add_dmm_detuning(P.RampWaveform(200, -det, 0.0), "dmm_0")
    seq.add_dmm_detuning(
        P.ConstantWaveform(100, -det / 2), "dmm_0", protocol="wait-for-all"
    )
    seq.add(P.Pulse.ConstantPulse(100, amp / 2, det, 1.0), "ryd")
    seq.measure("ground-rydberg")
    return seq


def slm_mask(P, rng):
    """An SLM mask over the first global pulse."""
    reg = P.Register.rectangle(1, 4, spacing=6.0, prefix="q")
    seq = P.Sequence(reg, P.DigitalAnalogDevice)
    seq.config_slm_mask(["q0", "q2"], "dmm_0")
    seq.declare_channel("ryd", "rydberg_global")
    amp = _u(rng, 1, 6)
    seq.add(
        P.Pulse.ConstantDetuning(P.RampWaveform(200, 0.0, amp), 0.0, 0.0),
        "ryd",
    )
    seq.add(P.Pulse.ConstantPulse(100, amp, _u(rng, -3, 3), 0.0), "ryd")
    return seq


def xy_field(P, rng):
    """XY mode with a magnetic field and a masked first pulse."""
    reg = P.Register.rectangle(1, 3, spacing=8.0, prefix="a")
    seq = P.Sequence(reg, P.MockDevice)
    seq.declare_channel("mw", "mw_global")
    seq.set_magnetic_field(_u(rng, 0, 30), _u(rng, 0, 30), _u(rng, 1, 30))
    seq.config_slm_mask(["a1"])
    amp = _u(rng, 1, 6)
    seq.add(P.Pulse.ConstantPulse(150, amp, 0.0, 0.0), "mw")
    seq.phase_shift(_u(rng, 0, 3), basis="XY")
    seq.add(
        P.Pulse.ConstantDetuning(P.BlackmanWaveform(100, 1.0), 0.5, 0.3), "mw"
    )
    seq.measure("XY")
    return seq


def truncated(P, rng):
    """The EOM scenario cut in the middle of its second EOM pulse."""
    seq = _eom_body(P, rng)
    seq.truncate(540)
    return seq


def parametrized(P, rng):
    """A parametrized sequence with variables in waveforms, pulses,
    targets, delays and phase shifts, built with values from the seed."""
    reg = P.Register.square(2, spacing=6.0, prefix="q")
    seq = P.Sequence(reg, P.DigitalAnalogDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.declare_channel("ram", "raman_local", initial_target="q0")
    omega = seq.declare_variable("omega", dtype=float)
    dets = seq.declare_variable("dets", size=2, dtype=float)
    dur = seq.declare_variable("dur", dtype=int)
    tgt = seq.declare_variable("tgt", dtype=int)
    seq.add(
        P.Pulse.ConstantDetuning(
            P.BlackmanWaveform(dur * 4, omega / 4), dets[0], 0.0
        ),
        "ryd",
    )
    seq.add(
        P.Pulse.ConstantAmplitude(
            omega * 2, P.RampWaveform(dur, dets[0], dets[1]), 0.5
        ),
        "ram",
    )
    seq.target_index(tgt, "ram")
    seq.delay(dur // 2, "ram")
    seq.phase_shift_index(dets[1] / 4, tgt)
    seq.add(P.Pulse.ConstantPulse(dur, omega, -dets[1], omega / 3), "ram")
    seq.measure("digital")
    assert seq.is_parametrized()
    return seq.build(
        omega=_u(rng, 1, 5),
        dets=rng.uniform(-5, 5, 2),
        dur=int(rng.integers(20, 60)) * 4,
        tgt=int(rng.integers(1, 4)),
    )


def mappable(P, rng):
    """A mappable register on a layout, pinned at build time."""
    rl = P.register.RegisterLayout(
        [[6.0 * i, 6.0 * j] for i in range(3) for j in range(2)]
    )
    mreg = rl.make_mappable_register(3)
    seq = P.Sequence(mreg, P.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.declare_channel("loc", "rydberg_local", initial_target="q1")
    amp = _u(rng, 1, 5)
    seq.add(P.Pulse.ConstantPulse(100, amp, 0.0, 0.0), "ryd")
    seq.add(P.Pulse.ConstantPulse(60, amp, 1.0, 0.2), "loc")
    assert seq.is_register_mappable()
    return seq.build(qubits={"q0": 4, "q1": 0, "q2": 3})


def new_register(P, rng):
    """The global + local scenario moved onto another register."""
    seq = global_local(P, rng)
    other = P.Register.square(2, spacing=9.0, prefix="q")
    return seq.with_new_register(other)


SCENARIOS = {
    fn.__name__: fn
    for fn in (
        global_local,
        eom_mode,
        dmm_detuning,
        slm_mask,
        xy_field,
        truncated,
        parametrized,
        mappable,
        new_register,
    )
}
#: Channels without a modulation bandwidth (``MockDevice``) warn when
#: asked to modulate, and the tests promote warnings to errors.
UNMODULATED = ("xy_field", "mappable")


# --- what is compared --------------------------------------------------------


def _arr(x) -> np.ndarray:
    return np.asarray(x.as_array(detach=True))


def _slot_type(t):
    if isinstance(t, str):
        return t
    return (
        _arr(t.amplitude.samples),
        _arr(t.detuning.samples),
        float(t.phase),
        t.post_phase_shift,
        str(t),
    )


def schedule_facts(seq) -> dict:
    """Every channel's timeline, slot by slot."""
    out = {}
    for name, sched in seq._schedule.items():
        out[name] = {
            "slots": [
                (_slot_type(s.type), s.ti, s.tf, sorted(s.targets))
                for s in sched.slots
            ],
            "eom_blocks": [
                (
                    _arr(b.rabi_freq),
                    _arr(b.detuning_on),
                    _arr(b.detuning_off),
                    b.ti,
                    b.tf,
                    [beam.name for beam in b.switching_beams],
                )
                for b in sched.eom_blocks
            ],
        }
    return out


def sequence_facts(seq) -> dict:
    """What a user can read off a built sequence."""
    facts = {
        "str": str(seq),
        "duration": seq.get_duration(),
        "duration_fall": seq.get_duration(include_fall_time=True),
        "per_channel": {
            ch: (
                seq.get_duration(ch),
                seq.get_duration(ch, include_fall_time=True),
            )
            for ch in seq.declared_channels
        },
        "bases": seq.get_addressed_bases(),
        "states": seq.get_addressed_states(),
        "measured": seq.is_measured(),
        "qubits": {
            q: _arr(pos) for q, pos in seq.register.qubits.items()
        },
        "phase_refs": {
            basis: {q: list(ref.phase._steps) for q, ref in refs.items()}
            for basis, refs in seq._basis_ref.items()
        },
        "schedule": schedule_facts(seq),
        "slm": (sorted(seq._slm_mask_targets), list(seq._slm_mask_time)),
        "available": sorted(seq.available_channels),
    }
    if seq.is_measured():
        facts["measurement"] = seq.get_measurement_basis()
    if seq._in_xy:
        facts["field"] = np.asarray(seq.magnetic_field)
    return facts


def assert_same(a, b, where: str = "") -> None:
    """Equal, bit for bit where arrays or floats are compared."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b), where
    else:
        assert a == b, (where, a, b)


def both(name: str, seed: int) -> tuple:
    """The scenario built with pulser_tpu and with the port."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return tuple(SCENARIOS[name](P, _rng(seed)) for P in PACKAGES)


@pytest.mark.parametrize("seed", [11, 12])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_sequence_scenario_bit_exact(name, seed):
    """``str(seq)``, durations, timelines, EOM blocks, phase references,
    SLM mask and field: ``==`` between the packages."""
    jax_seq, port_seq = both(name, seed)
    assert type(port_seq).__module__.startswith("pulser_tpu_torch.")
    assert_same(sequence_facts(jax_seq), sequence_facts(port_seq), name)


def _estimates(P, rng) -> list:
    seq = global_local(P, rng)
    pulse = P.Pulse.ConstantPulse(100, 1.0, 0.0, 2.0)
    return [
        seq.estimate_added_delay(pulse, ch, protocol)
        for ch in ("loc", "ram")
        for protocol in ("min-delay", "no-delay", "wait-for-all")
    ] + [
        float(seq.current_phase_ref(q, basis))
        for q in ("q0", "q1", "q3")
        for basis in ("digital", "ground-rydberg")
    ]


def test_estimate_added_delay_and_phase_refs_match():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jax_out, port_out = (_estimates(P, _rng(21)) for P in PACKAGES)
    assert jax_out == port_out


def _invalid_calls(P) -> list:
    reg = P.Register.square(2, spacing=6.0, prefix="q")

    def fresh(device=None):
        seq = P.Sequence(reg, device or P.DigitalAnalogDevice)
        seq.declare_channel("ryd", "rydberg_global")
        return seq

    def in_eom():
        seq = P.Sequence(reg, P.AnalogDevice)
        seq.declare_channel("ryd", "rydberg_global")
        seq.enable_eom_mode("ryd", 2.0, 0.0)
        return seq

    def parametrized_seq():
        seq = fresh()
        v = seq.declare_variable("v", dtype=float)
        seq.add(P.Pulse.ConstantPulse(100, v, 0.0, 0.0), "ryd")
        return seq

    pulse = P.Pulse.ConstantPulse(100, 1.0, 0.0, 0.0)
    calls = [
        lambda: P.Sequence(reg, "device"),
        lambda: P.Sequence("reg", P.MockDevice),
        lambda: fresh().declare_channel("ryd", "rydberg_global"),
        lambda: fresh().declare_channel("x", "no_such_channel"),
        lambda: fresh().declare_channel("loc", "rydberg_local"),
        lambda: fresh().add(pulse, "nope"),
        lambda: fresh().add("pulse", "ryd"),
        lambda: fresh().add(pulse, "ryd", protocol="fastest"),
        lambda: fresh().add(
            P.Pulse.ConstantPulse(100, 1e5, 0.0, 0.0), "ryd"
        ),
        lambda: fresh().target("q0", "ryd"),
        lambda: fresh().delay(-10, "ryd"),
        lambda: fresh().measure("XY"),
        lambda: fresh().phase_shift(1.0, "q9"),
        lambda: fresh().phase_shift("a", "q0"),
        lambda: fresh().enable_eom_mode("ryd", 1.0, 0.0),
        lambda: in_eom().add(pulse, "ryd"),
        lambda: in_eom().enable_eom_mode("ryd", 1.0, 0.0),
        lambda: fresh(P.AnalogDevice).add_eom_pulse("ryd", 100, 0.0),
        lambda: fresh(P.AnalogDevice).disable_eom_mode("ryd"),
        lambda: fresh().add_dmm_detuning(
            P.ConstantWaveform(100, -1.0), "dmm_0"
        ),
        lambda: fresh().config_slm_mask(["q7"]),
        lambda: fresh().set_magnetic_field(1.0, 0.0, 0.0),
        lambda: fresh().truncate(-5),
        lambda: fresh().declare_variable("qubits"),
        lambda: parametrized_seq().build(),
        lambda: parametrized_seq().build(v=1.0, w=2.0),
        lambda: fresh().build(v=1.0),
        lambda: fresh().align("ryd"),
        lambda: P.sampler.sample(parametrized_seq()),
    ]
    out = []
    for i, call in enumerate(calls):
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                call()
        except Exception as err:
            out.append(
                (
                    i,
                    type(err).__name__,
                    str(err).replace("pulser_tpu_torch", "pulser_tpu"),
                )
            )
        else:
            out.append((i, None, None))
    return out


def test_invalid_calls_raise_the_same():
    """The same error type and message for 29 invalid calls (at least 25
    of them must raise)."""
    jax_errs, port_errs = (_invalid_calls(P) for P in PACKAGES)
    assert jax_errs == port_errs
    assert sum(kind is not None for _, kind, _ in jax_errs) >= 25


def test_device_switching_and_drawing_are_not_ported():
    """Once refused (hence the name), device switching and drawing now
    run in the port as in pulser_tpu: the switched sequences are equal,
    the deprecated ``switch_device`` warns alike, and ``draw`` makes the
    same number of figures. Serialization is ported too: the switched
    sequences write the same abstract repr."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    facts = []
    for P, seq in zip(PACKAGES, both("global_local", 0)):
        plt.close("all")
        with warnings.catch_warnings():
            # The replayed calls warn again (phase shifts on all qubits)
            warnings.simplefilter("ignore", UserWarning)
            with pytest.warns(DeprecationWarning, match="switch_device"):
                moved_old = seq.switch_device(P.MockDevice)
            moved = seq.with_new_device(P.MockDevice)
            seq.draw(show=False)
        facts.append(
            (
                sequence_facts(moved),
                str(moved_old) == str(moved),
                len(plt.get_fignums()),
            )
        )
        plt.close("all")
    assert_same(*facts)
    assert facts[1][1] and facts[1][2] > 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        jax_str, port_str = (
            seq.with_new_device(P.MockDevice).to_abstract_repr()
            for P, seq in zip(PACKAGES, both("global_local", 0))
        )
    assert port_str == jax_str
