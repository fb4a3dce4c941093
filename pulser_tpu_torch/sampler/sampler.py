"""Lowering a built Sequence into dense per-channel time series.

Behavioral parity with reference
``pulser-core/pulser/sampler/sampler.py:15``.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

from pulser_tpu_torch.sampler.samples import (
    ChannelSamples,
    SequenceSamples,
    _SlmMask,
)

if TYPE_CHECKING:
    from pulser_tpu_torch import Sequence

IGNORE_DETUNED_DELAY_PHASE = True


def _lower_channel(
    seq: Sequence,
    ch_schedule,
    modulation: bool,
    extended_duration: Optional[int],
) -> ChannelSamples:
    """Samples one channel schedule, with optional padding/modulation."""
    kwargs = dict(ignore_detuned_delay_phase=IGNORE_DETUNED_DELAY_PHASE)
    if hasattr(ch_schedule, "detuning_map"):
        # DMM samples need the qubit positions to resolve weights.
        if seq.is_register_mappable():
            raise NotImplementedError(
                "Sequences with a DMM channel can't be sampled while "
                "their register is mappable."
            )
        kwargs["qubits"] = seq.register.qubits
    out = ch_schedule.get_samples(**kwargs)
    if extended_duration:
        out = out.extend_duration(extended_duration)
    if modulation:
        out = out.modulate(
            ch_schedule.channel_obj,
            max_duration=extended_duration
            or ch_schedule.get_duration(include_fall_time=True),
        )
    return out


def sample(
    seq: Sequence,
    modulation: bool = False,
    extended_duration: Optional[int] = None,
) -> SequenceSamples:
    """Construct samples of a Sequence.

    Args:
        seq: The sequence to sample.
        modulation: Whether to modulate the samples.
        extended_duration: If defined, extends the samples' duration to
            the desired value.
    """
    if seq.is_parametrized():
        raise NotImplementedError(
            "Parametrized sequences can't be sampled."
        )

    per_channel = [
        _lower_channel(seq, sched, modulation, extended_duration)
        for sched in seq._schedule.values()
    ]

    extras: dict = dict()
    if seq._slm_mask_targets and seq._slm_mask_time:
        extras["_slm_mask"] = _SlmMask(
            seq._slm_mask_targets, seq._slm_mask_time[1]
        )
    if seq._in_xy:
        extras["_magnetic_field"] = seq.magnetic_field
    if hasattr(seq, "_measurement"):
        extras["_measurement"] = seq._measurement

    return SequenceSamples(
        list(seq.declared_channels.keys()),
        per_channel,
        seq.declared_channels,
        seq._basis_ref,
        **extras,
    )
