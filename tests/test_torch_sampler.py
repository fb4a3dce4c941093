"""``sample(seq)``: the port against pulser_tpu, and against hand-built arrays.

The scenarios of ``test_torch_sequence.py`` are sampled with both
packages, plain, with ``modulation=True``, with ``extended_duration``
and with both. Sampling is numpy (and scipy's FFT for the modulation) on
the same values in the same order in both packages, so every array must
be equal bit for bit (``==``, no tolerance), and every slot, EOM block
and buffer equal.

The last tests hold the samples of ``chip_smoke.py``'s sequences against
arrays built from the waveform formulas directly: equal bit for bit.
"""

from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch
from test_torch_sequence import (
    SCENARIOS,
    UNMODULATED,
    _arr,
    _slot_type,
    assert_same,
    both,
)

import pulser_tpu.sampler
import pulser_tpu_torch.sampler

torch.set_num_threads(1)

SAMPLERS = (pulser_tpu.sampler.sample, pulser_tpu_torch.sampler.sample)


def channel_facts(ch) -> dict:
    facts = {
        "amp": _arr(ch.amp),
        "det": _arr(ch.det),
        "phase": _arr(ch.phase),
        "centered_phase": _arr(ch.centered_phase),
        "phase_modulation": _arr(ch.phase_modulation),
        "duration": ch.duration,
        "initial_targets": sorted(ch.initial_targets),
        "is_empty": ch.is_empty(),
        "slots": [(s.ti, s.tf, sorted(s.targets)) for s in ch.slots],
        "eom_blocks": [
            (
                _arr(b.rabi_freq),
                _arr(b.detuning_on),
                _arr(b.detuning_off),
                b.ti,
                b.tf,
                [beam.name for beam in b.switching_beams],
            )
            for b in ch.eom_blocks
        ],
        "eom_start_buffers": list(ch.eom_start_buffers),
        "eom_end_buffers": list(ch.eom_end_buffers),
        "target_time_slots": [
            (_slot_type(s.type), s.ti, s.tf, sorted(s.targets))
            for s in ch.target_time_slots
        ],
    }
    if hasattr(ch, "detuning_map"):
        facts["dmm"] = (
            np.asarray(ch.detuning_map.trap_coordinates),
            list(ch.detuning_map.weights),
            {q: _arr(pos) for q, pos in ch.qubits.items()},
        )
    return facts


def samples_facts(samples) -> dict:
    return {
        "channels": list(samples.channels),
        "per_channel": {
            name: channel_facts(ch)
            for name, ch in samples.channel_samples.items()
        },
        "max_duration": samples.max_duration,
        "used_bases": sorted(samples.used_bases),
        "eigenbasis": list(samples.eigenbasis),
        "in_xy": samples._in_xy,
        "slm": (sorted(samples._slm_mask.targets), samples._slm_mask.end),
        "field": (
            None
            if samples._magnetic_field is None
            else np.asarray(samples._magnetic_field)
        ),
        "measurement": samples._measurement,
        "phase_refs": {
            basis: {q: list(ref.phase._steps) for q, ref in refs.items()}
            for basis, refs in samples._basis_ref.items()
        },
        "nested": _np_tree(samples.to_nested_dict()),
        "nested_local": _np_tree(samples.to_nested_dict(all_local=True)),
    }


def _np_tree(tree):
    """A nested dict of sample series with numpy arrays at its leaves."""
    if isinstance(tree, dict):
        return {key: _np_tree(val) for key, val in tree.items()}
    return np.asarray(tree)


def _sample_kwargs(seq, name: str) -> list[dict]:
    longer = seq.get_duration(include_fall_time=True) + 37
    kwargs = [{}, {"extended_duration": longer}]
    if name not in UNMODULATED:
        kwargs += [
            {"modulation": True},
            {"modulation": True, "extended_duration": longer},
        ]
    return kwargs


@pytest.mark.parametrize("seed", [31, 32])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_samples_bit_exact(name, seed):
    """amp, det, phase, slots, EOM blocks and buffers of every channel,
    plain, modulated and extended: ``==`` between the packages."""
    seqs = both(name, seed)
    for kwargs in _sample_kwargs(seqs[0], name):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jax_facts, port_facts = (
                samples_facts(sample(seq, **kwargs))
                for sample, seq in zip(SAMPLERS, seqs)
            )
        assert_same(jax_facts, port_facts, f"{name}{kwargs}")
    assert type(port_facts["per_channel"]) is dict


def test_modulated_samples_differ_from_the_input():
    """The modulation is really applied (guards against a comparison of
    two unmodulated outputs)."""
    _, seq = both("eom_mode", 5)
    plain = pulser_tpu_torch.sampler.sample(seq).channel_samples["ryd"]
    mod = pulser_tpu_torch.sampler.sample(
        seq, modulation=True
    ).channel_samples["ryd"]
    assert mod.duration >= plain.duration
    assert not np.array_equal(
        _arr(mod.amp)[: plain.duration], _arr(plain.amp)
    )


# --- chip_smoke's inputs against hand-built arrays ------------------------


def _ramp(duration: int, start: float, stop: float) -> np.ndarray:
    """``RampWaveform(duration, start, stop)`` samples."""
    slope = (stop - start) / (duration - 1)
    ramp = slope * np.arange(duration, dtype=float) + start
    return np.clip(ramp, *sorted([float(start), float(stop)]))


def _const(duration: int, value: float) -> np.ndarray:
    """``ConstantWaveform(duration, value)`` samples."""
    return value * np.ones(duration)


def _sweep_arrays(
    omega: float, delta_0: float, delta_f: float,
    t_rise: int, t_sweep: int, t_fall: int,
) -> tuple:
    """``(amp, det, slot edges)`` of a ramp-sweep-ramp, built from the
    waveform formulas directly: an amplitude rise to ``omega`` at
    ``delta_0``, a detuning sweep to ``delta_f`` at ``omega``, an
    amplitude fall at ``delta_f``."""
    amp = np.concatenate(
        [
            _ramp(t_rise, 0.0, omega),
            _const(t_sweep, omega),
            _ramp(t_fall, omega, 0.0),
        ]
    )
    det = np.concatenate(
        [
            _const(t_rise, delta_0),
            _ramp(t_sweep, delta_0, delta_f),
            _const(t_fall, delta_f),
        ]
    )
    return amp, det, np.cumsum([0, t_rise, t_sweep, t_fall])


HAND_BUILT = {
    "afm16_inputs": (
        2.0 * 2 * np.pi, -6 * 2 * np.pi, 2 * 2 * np.pi, 252, 2700, 252,
    ),
    "noisy10_inputs": (
        2 * np.pi * 1.5, -2 * np.pi * 4, 2 * np.pi * 2, 400, 1200, 400,
    ),
    "spd10_inputs": (
        2 * np.pi * 1.5, -2 * np.pi * 4, 2 * np.pi * 2, 400, 1200, 400,
    ),
    "pauli10_inputs": (
        2 * np.pi * 1.5, -2 * np.pi * 4, 2 * np.pi * 2, 400, 1200, 400,
    ),
}


@pytest.mark.parametrize("inputs", list(HAND_BUILT))
def test_chip_smoke_inputs_equal_hand_built_arrays(inputs):
    """The samples of each main path's sequence in ``chip_smoke.py`` equal
    the hand-built arrays bit for bit, with the same slots, targets,
    channel object and phase references."""
    import chip_smoke

    samples, register, device = getattr(chip_smoke, inputs)()[:3]
    amp, det, edges = _sweep_arrays(*HAND_BUILT[inputs])
    assert samples.channels == ["ryd"]
    (got,) = samples.samples_list
    assert np.array_equal(_arr(got.amp), amp)
    assert np.array_equal(_arr(got.det), det)
    assert np.array_equal(_arr(got.phase), np.zeros(len(amp)))
    qids = set(register.qubit_ids)
    assert [(s.ti, s.tf, s.targets) for s in got.slots] == [
        (int(ti), int(tf), qids) for ti, tf in zip(edges[:-1], edges[1:])
    ]
    assert [
        (s.type, s.ti, s.tf, s.targets) for s in got.target_time_slots
    ] == [("target", -1, 0, qids)]
    assert got.eom_blocks == []
    assert samples._ch_objs == {"ryd": device.channels["rydberg_global"]}
    assert {
        basis: {q: ref.phase._steps for q, ref in refs.items()}
        for basis, refs in samples._basis_ref.items()
    } == {"ground-rydberg": {q: [(0, 0.0)] for q in qids}}
    assert device.name == "MockDevice"
