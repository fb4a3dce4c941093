"""``Sequence.with_new_device`` in the port against pulser_tpu.

The cases of ``tests/test_switch_device.py`` (channel matching, strict
parameter checks, DMMs, EOM configurations, time slots), each written
once as a function of a package namespace and run through both packages
by ``tests/torch_parity.py::assert_parity``: the switched sequence's
``str``, its device, its declared channels and its samples are equal
(bit for bit: tolerance 0), and a refused switch raises the same error
with the same message; the warnings are the same too. TRI16's switch
(``chip_smoke.tri16_build``: designed on ``MockDevice``, moved onto
``AnalogDevice``'s calibrated layout) is one of the cases.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from torch_parity import assert_parity

torch.set_num_threads(1)


def facts(ns, seq) -> list:
    """What a switch must preserve: the device, ``str(seq)``, the
    declared channels and every channel's samples."""
    samples = ns.sample(seq)
    return [
        seq.device.name,
        str(seq),
        list(seq.declared_channels),
        {
            ch: [
                np.asarray(getattr(cs, f), dtype=float)
                for f in ("amp", "det", "phase")
            ]
            for ch, cs in samples.channel_samples.items()
        },
    ]


def _reg(P):
    return P.Register.square(2, spacing=6.0, prefix="q")


def _seq_with_pulse(P, device, ch="rydberg_global"):
    seq = P.Sequence(_reg(P), device)
    seq.declare_channel("ch0", ch)
    seq.add(P.Pulse.ConstantPulse(100, 2.0, -1.0, 0.0), "ch0")
    return seq


def same_device(ns):
    P = ns.pkg
    seq = _seq_with_pulse(P, P.DigitalAnalogDevice)
    return seq.with_new_device(P.DigitalAnalogDevice) is seq


def to_virtual_and_back(ns):
    P = ns.pkg
    seq = _seq_with_pulse(P, P.DigitalAnalogDevice)
    virt = seq.with_new_device(P.DigitalAnalogDevice.to_virtual())
    back = virt.with_new_device(P.DigitalAnalogDevice, strict=True)
    return [facts(ns, virt), facts(ns, back)]


def no_matching_channel_type(ns):
    P = ns.pkg
    seq = P.Sequence(_reg(P), P.MockDevice)
    seq.declare_channel("mw", "mw_global")
    return seq.with_new_device(P.DigitalAnalogDevice)


def second_local_channel_no_match(ns):
    P = ns.pkg
    virt = dataclasses.replace(
        P.DigitalAnalogDevice.to_virtual(), reusable_channels=True
    )
    seq = P.Sequence(_reg(P), virt)
    seq.declare_channel("raman", "raman_local", ["q0"])
    seq.declare_channel("raman_1", "raman_local", ["q0"])
    return seq.with_new_device(P.DigitalAnalogDevice)


def strict_clock_period_global(ns):
    P = ns.pkg
    base_ch = P.MockDevice.channels["rydberg_global"]
    dev_a, dev_b = (
        dataclasses.replace(
            P.MockDevice,
            name=name,
            channel_objects=(
                dataclasses.replace(base_ch, clock_period=clock),
            ),
            channel_ids=None,
        )
        for name, clock in (("MockDevice", 1), ("OtherClock", 4))
    )
    seq = _seq_with_pulse(P, dev_a)
    return facts(ns, seq.with_new_device(dev_b, strict=True))


def strict_renamed_bit_exact(ns):
    P = ns.pkg
    seq = _seq_with_pulse(P, P.DigitalAnalogDevice)
    renamed = dataclasses.replace(P.DigitalAnalogDevice, name="Renamed")
    return [facts(ns, seq), facts(ns, seq.with_new_device(renamed, True))]


def up_to_mock_device(ns):
    P = ns.pkg
    seq = _seq_with_pulse(P, P.AnalogDevice)
    return facts(ns, seq.with_new_device(P.MockDevice))


def _analog_eom_seq(P):
    reg = P.Register({"q0": (-3, 0), "q1": (3, 0)})
    seq = P.Sequence(reg, P.AnalogDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.enable_eom_mode("ryd", amp_on=2 * np.pi, detuning_on=0.0)
    seq.add_eom_pulse("ryd", duration=100, phase=0.0)
    seq.disable_eom_mode("ryd")
    return seq


def eom_to_device_without_eom(ns):
    P = ns.pkg
    no_eom = dataclasses.replace(
        P.AnalogDevice,
        name="NoEom",
        channel_objects=tuple(
            dataclasses.replace(ch, eom_config=None)
            for ch in P.AnalogDevice.channel_objects
        ),
        channel_ids=None,
    )
    return _analog_eom_seq(P).with_new_device(no_eom, strict=True)


def eom_to_renamed_device(ns):
    P = ns.pkg
    renamed = dataclasses.replace(P.AnalogDevice, name="Analog2")
    return facts(ns, _analog_eom_seq(P).with_new_device(renamed, True))


def parametrized_switch(ns):
    P = ns.pkg
    seq = P.Sequence(_reg(P), P.DigitalAnalogDevice)
    seq.declare_channel("ch0", "rydberg_global")
    amp = seq.declare_variable("amp", dtype=float)
    seq.add(P.Pulse.ConstantPulse(200, amp, 0.0, 0.0), "ch0")
    out = seq.with_new_device(
        dataclasses.replace(P.DigitalAnalogDevice, name="Renamed")
    )
    return [out.is_parametrized(), str(out), facts(ns, out.build(amp=1.5))]


def register_incompatible(ns):
    P = ns.pkg
    seq = _seq_with_pulse(P, P.MockDevice)
    tight = dataclasses.replace(
        P.DigitalAnalogDevice, max_radial_distance=1
    )
    return seq.with_new_device(tight)


def _phys_device(P):
    return dataclasses.replace(
        P.DigitalAnalogDevice,
        dmm_objects=(
            dataclasses.replace(
                P.DigitalAnalogDevice.dmm_objects[0],
                total_bottom_detuning=-2000,
            ),
        ),
    )


def _seq_two_dmms(P, parametrized):
    reg = _reg(P)
    det_map = reg.define_detuning_map({q: 1.0 for q in reg.qubit_ids})
    device = dataclasses.replace(
        _phys_device(P).to_virtual(), reusable_channels=True
    )
    seq = P.Sequence(reg, device)
    seq.declare_channel("global", "rydberg_global")
    if parametrized:
        t = seq.declare_variable("t", dtype=int)
        seq.delay(t, "global")
    seq.config_detuning_map(det_map, dmm_id="dmm_0")
    seq.config_detuning_map(det_map, dmm_id="dmm_0")
    return seq


def dmm_cases(which, parametrized):
    def case(ns):
        P = ns.pkg
        seq = _seq_two_dmms(P, parametrized)
        phys = _phys_device(P)
        down = dataclasses.replace(
            phys.dmm_channels["dmm_0"], bottom_detuning=-10
        )
        if which == "needs_a_slot":
            return seq.with_new_device(phys)
        if which == "bottom_detuning_not_strict":
            out = seq.with_new_device(
                dataclasses.replace(phys, dmm_objects=(down, down)),
                strict=True,
            )
            return [list(out.declared_channels), str(out)]
        seq.add_dmm_detuning(P.ConstantWaveform(100, -20), "dmm_0_1")
        if which == "deep_virtual":
            dev = dataclasses.replace(
                phys.to_virtual(),
                reusable_channels=True,
                dmm_objects=(
                    dataclasses.replace(down, bottom_detuning=-20),
                ),
            )
        elif which == "deep_and_shallow":
            dev = dataclasses.replace(
                phys, dmm_objects=(phys.dmm_channels["dmm_0"], down)
            )
        else:  # two shallow DMMs: no matching, the error lists them
            dev = dataclasses.replace(phys, dmm_objects=(down, down))
        out = seq.with_new_device(dev, strict=True)
        return [list(out.declared_channels), str(out)]

    return case


def interaction_mismatch(channel_id, strict, parametrized):
    def case(ns):
        P = ns.pkg
        seq = P.Sequence(_reg(P), P.MockDevice)
        seq.declare_channel("ch0", channel_id)
        if parametrized:
            t = seq.declare_variable("t", dtype=int)
            seq.delay(t, "ch0")
        mod_mock = dataclasses.replace(P.MockDevice, rydberg_level=50)
        return str(seq.with_new_device(mod_mock, strict=strict))

    return case


def _local_device(P, name="Dev", **raman_kwargs):
    from importlib import import_module

    channels = import_module(f"{P.__name__}.channels")
    kwargs = dict(
        max_abs_detuning=2 * np.pi * 20,
        max_amp=2 * np.pi * 10,
        max_targets=2,
        fixed_retarget_t=0,
        min_retarget_interval=220,
        clock_period=1,
        mod_bandwidth=None,
    )
    kwargs.update(raman_kwargs)
    return dataclasses.replace(
        P.MockDevice,
        name=name,
        channel_objects=(
            channels.Rydberg.Global(None, None),
            channels.Raman.Local(**kwargs),
        ),
        channel_ids=("rydberg_global", "rmn_local"),
    )


def timing_mismatch(new_kwargs, parametrized):
    def case(ns):
        P = ns.pkg
        seq = P.Sequence(_reg(P), _local_device(P))
        seq.declare_channel("digital", "rmn_local", initial_target=["q0"])
        if parametrized:
            t = seq.declare_variable("t", dtype=int)
            seq.delay(t, "digital")
        out = seq.with_new_device(
            _local_device(P, "Dev2", **new_kwargs), strict=True
        )
        return [out.device.name, str(out)]

    return case


def _eom_seq(P, parametrized=False):
    seq = P.Sequence(
        P.Register({"q0": (-3.0, 0.0), "q1": (3.0, 0.0)}), P.AnalogDevice
    )
    seq.declare_channel("rydberg", "rydberg_global")
    if parametrized:
        t = seq.declare_variable("t", dtype=int)
        seq.delay(t, "rydberg")
    seq.enable_eom_mode(
        "rydberg", amp_on=2.0, detuning_on=0.0, optimal_detuning_off=0.0
    )
    seq.add_eom_pulse("rydberg", 100, 0.0)
    seq.add_eom_pulse("rydberg", 100, 1.0)
    return seq


def _analog_with_eom(P, eom_config, name="ModAnalog"):
    ch = dataclasses.replace(
        P.AnalogDevice.channels["rydberg_global"], eom_config=eom_config
    )
    return dataclasses.replace(
        P.AnalogDevice, name=name, channel_objects=(ch,), channel_ids=None
    )


def eom_cases(which):
    def case(ns):
        P = ns.pkg
        seq = _eom_seq(P, parametrized=which == "parametrized_config")
        good = P.AnalogDevice.channels["rydberg_global"]
        base_eom = good.eom_config
        if which == "needs_eom_channel":
            return seq.with_new_device(P.DigitalAnalogDevice)
        if which in ("mod_bandwidth", "parametrized_config"):
            wrong = _analog_with_eom(
                P, dataclasses.replace(base_eom, mod_bandwidth=20)
            )
            return seq.with_new_device(wrong, strict=True)
        if which == "picks_the_good_channel":
            wrong_ch = dataclasses.replace(
                good,
                eom_config=dataclasses.replace(base_eom, mod_bandwidth=20),
            )
            two = dataclasses.replace(
                P.AnalogDevice,
                name="TwoEom",
                channel_objects=(wrong_ch, good),
                channel_ids=("wrong_eom", "good_eom"),
            )
            return facts(ns, seq.with_new_device(two, strict=True))
        limited = _analog_with_eom(
            P, dataclasses.replace(base_eom, max_limiting_amp=5 * 2 * np.pi)
        )
        if which == "limiting_amp_strict":
            return seq.with_new_device(limited, strict=True)
        # Lax: the re-derived detuning_off moves; an extended limiting
        # amplitude keeps the whole setpoint under a strict switch
        up = _analog_with_eom(
            P,
            dataclasses.replace(base_eom, max_limiting_amp=40 * 2 * np.pi),
            name="UpAnalog",
        )
        blocks = [
            s._schedule["rydberg"].eom_blocks[0]
            for s in (
                seq,
                seq.with_new_device(limited),
                seq.with_new_device(up, strict=True),
            )
        ]
        return [
            [float(b.detuning_on), float(b.rabi_freq), float(b.detuning_off)]
            for b in blocks
        ]

    return case


def _one_channel_device(P, base, **ch_changes):
    return dataclasses.replace(
        base,
        channel_objects=(
            dataclasses.replace(
                base.channels["rydberg_global"], **ch_changes
            ),
        ),
        channel_ids=("rydberg_global",),
    )


def slot_cases(which):
    def case(ns):
        P = ns.pkg
        dad = P.DigitalAnalogDevice
        reg = _reg(P)
        seq = P.Sequence(reg, dad)
        seq.declare_channel("ryd", "rydberg_global")
        if which == "time_slots":
            seq.add(P.Pulse.ConstantPulse(103, 1.0, -1.0, 0.0), "ryd")
            dev = _one_channel_device(P, dad, clock_period=5)
        elif which == "parametrized_clock":
            seq.delay(seq.declare_variable("delay", dtype=int), "ryd")
            dev = _one_channel_device(P, dad, clock_period=5)
        elif which == "identical_keeps_slots":
            seq.add(P.Pulse.ConstantPulse(100, 1.0, -1.0, 0.0), "ryd")
            out = seq.with_new_device(
                _one_channel_device(P, dad), strict=True
            )
            return [
                out._schedule["ryd"].slots == seq._schedule["ryd"].slots,
                facts(ns, out),
            ]
        elif which == "phase_jump_time":
            phase = seq.declare_variable("phase", dtype=float)
            pulse = P.Pulse.ConstantPulse(100, 1.0, -1.0, 0.0)
            seq.add(pulse, "ryd")
            seq.phase_shift(phase, basis="ground-rydberg")
            seq.add(pulse, "ryd")
            dev = _one_channel_device(P, dad, custom_phase_jump_time=200)
        else:  # the DMM's slots are checked too
            seq.add(P.Pulse.ConstantPulse(103, 1.0, -1.0, 0.0), "ryd")
            det_map = reg.define_detuning_map(
                {q: (1.0 if i < 3 else 0) for i, q in enumerate(reg.qubit_ids)}
            )
            seq.config_detuning_map(det_map, "dmm_0")
            seq.add_dmm_detuning(P.ConstantWaveform(107, -5), "dmm_0")
            dev = dataclasses.replace(
                dad,
                dmm_objects=(
                    dataclasses.replace(
                        dad.dmm_channels["dmm_0"], clock_period=5
                    ),
                ),
            )
        return seq.with_new_device(dev, strict=True)

    return case


def tri16_onto_analog_device(ns):
    """TRI16: designed on MockDevice, moved onto AnalogDevice, whose
    register must come from a layout; the switched sequence equals the
    one built on AnalogDevice directly, and its layout is calibrated."""
    P = ns.pkg
    moved = chip_smoke.tri16_build(P, direct=False)
    direct = chip_smoke.tri16_build(P, direct=True)
    return [
        facts(ns, moved),
        facts(ns, direct),
        P.AnalogDevice.register_is_from_calibrated_layout(moved.register),
    ]


def layoutless_register_onto_analog_device(ns):
    """A register made without a layout moves onto AnalogDevice too: the
    device's ``requires_layout`` is enforced when a sequence is sent to
    a QPU, not when it is switched."""
    P = ns.pkg
    reg = P.Register.hexagon(1, spacing=5.0, prefix="q")
    seq = P.Sequence(reg, P.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(P.Pulse.ConstantPulse(100, 1.0, 0.0, 0.0), "ryd")
    moved = seq.with_new_device(P.AnalogDevice)
    return [facts(ns, moved), moved.register.layout is None]


def switch_device_alias(ns):
    """The deprecated alias warns and switches alike."""
    P = ns.pkg
    seq = _seq_with_pulse(P, P.DigitalAnalogDevice)
    return facts(ns, seq.switch_device(P.MockDevice))


SCENARIOS = {
    "same_device": same_device,
    "to_virtual_and_back": to_virtual_and_back,
    "no_matching_channel_type": no_matching_channel_type,
    "second_local_channel_no_match": second_local_channel_no_match,
    "strict_clock_period_global": strict_clock_period_global,
    "strict_renamed_bit_exact": strict_renamed_bit_exact,
    "up_to_mock_device": up_to_mock_device,
    "eom_to_device_without_eom": eom_to_device_without_eom,
    "eom_to_renamed_device": eom_to_renamed_device,
    "parametrized_switch": parametrized_switch,
    "register_incompatible": register_incompatible,
    **{
        f"dmm_{which}-{par}": dmm_cases(which, par)
        for which in (
            "needs_a_slot", "bottom_detuning_not_strict", "deep_virtual",
            "deep_and_shallow", "two_shallow",
        )
        for par in (False, True)
    },
    **{
        f"interaction_{ch}-strict_{strict}-{par}": interaction_mismatch(
            ch, strict, par
        )
        for ch in ("rydberg_global", "mw_global")
        for strict in (True, False)
        for par in (False, True)
    },
    **{
        f"timing_{name}-{par}": timing_mismatch(kw, par)
        for name, kw in (
            ("clock_period", {"clock_period": 4}),
            ("mod_bandwidth", {"mod_bandwidth": 5.0}),
            ("fixed_retarget_t", {"fixed_retarget_t": 100}),
            ("min_retarget_interval", {"min_retarget_interval": 500}),
        )
        for par in (False, True)
    },
    **{
        f"eom_{which}": eom_cases(which)
        for which in (
            "needs_eom_channel", "mod_bandwidth", "parametrized_config",
            "picks_the_good_channel", "limiting_amp_strict",
            "limiting_amp_lax",
        )
    },
    **{
        f"slots_{which}": slot_cases(which)
        for which in (
            "time_slots", "parametrized_clock", "identical_keeps_slots",
            "phase_jump_time", "dmm_slots",
        )
    },
    "tri16_onto_analog_device": tri16_onto_analog_device,
    "layoutless_register_onto_analog_device": (
        layoutless_register_onto_analog_device
    ),
    "switch_device_alias": switch_device_alias,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_switch_matches_pulser_tpu(name):
    assert_parity(SCENARIOS[name], tol=0.0)
