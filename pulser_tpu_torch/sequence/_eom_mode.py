"""The EOM-mode transition engine behind ``Sequence``.

Semantics follow the reference's EOM operations
(``pulser-core/pulser/sequence/sequence.py:1006-1338,2485-2530``) but
the organization differs: ``enable_eom_mode`` and
``modify_eom_setpoint`` — near-duplicate method bodies in the
reference — here share one :func:`begin_block` engine whose ``modify``
flag selects the three points where they genuinely diverge (closing
the previous block, the fall-time reference point, and which drift
terms the phase correction sums).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Union, cast

import torch

import pulser_tpu_torch.math as pm
from pulser_tpu_torch.channels.base_channel import Channel
from pulser_tpu_torch.channels.eom import RydbergBeam, RydbergEOM
from pulser_tpu_torch.parametrized import Parametrized
from pulser_tpu_torch.pulse import Pulse
from pulser_tpu_torch.sequence._call import _Call
from pulser_tpu_torch.sequence._schedule import _PhaseDriftParams

if TYPE_CHECKING:
    from pulser_tpu_torch.sequence.sequence import Sequence

EomValue = Union[float, "pm.TensorLike", Parametrized]
ResolvedOff = Union[float, pm.AbstractArray, Parametrized]


def _any_traced(*values: object) -> bool:
    """Whether any value is (or wraps) a tensor that requires grad.

    For live setpoint values the host-side parts of the EOM physics
    (beam-switching metadata, range asserts) are skipped — the
    differentiable detuning selection itself stays in the graph.
    """
    for v in values:
        if isinstance(v, torch.Tensor) and v.requires_grad:
            return True
        if isinstance(v, pm.AbstractArray) and v.requires_grad:
            return True
    return False


def resolve_setpoint(
    seq: Sequence,
    channel_obj: Channel,
    amp_on: EomValue,
    detuning_on: EomValue,
    optimal_detuning_off: Union[float, Parametrized],
) -> tuple[ResolvedOff, tuple[RydbergBeam, ...]]:
    """Validates an EOM setpoint and picks the idle detuning.

    When every value is concrete, the channel's EOM physics selects
    the ``detuning_off`` option closest to the requested optimum and
    reports which beams switch (reference ``sequence.py:2485-2530``).
    Parametrized inputs defer everything to build time.
    """
    on_pulse = Pulse.ConstantPulse(
        channel_obj.min_duration, amp_on, detuning_on, 0.0
    )
    resolved: ResolvedOff = optimal_detuning_off
    switching_beams: tuple[RydbergBeam, ...] = ()
    if isinstance(on_pulse, Parametrized):
        return resolved, switching_beams
    channel_obj.validate_pulse(on_pulse)
    assert not isinstance(amp_on, Parametrized)
    assert not isinstance(detuning_on, Parametrized)
    if isinstance(optimal_detuning_off, Parametrized):
        return resolved, switching_beams

    eom_config = cast(RydbergEOM, channel_obj.eom_config)
    if _any_traced(amp_on, detuning_on, optimal_detuning_off):
        # Differentiable selection only: the argmin stays in the autograd
        # graph, while beam metadata and range asserts (host-side,
        # data-dependent) are deferred exactly as for Parametrized
        # inputs.
        detuning_off = eom_config.calculate_detuning_off(
            amp_on,
            detuning_on,
            optimal_detuning_off,
            return_switching_beams=False,
        )
        return detuning_off, switching_beams
    detuning_off, switching_beams = eom_config.calculate_detuning_off(
        amp_on,
        detuning_on,
        float(optimal_detuning_off),
        return_switching_beams=True,
    )
    # The detuning from the laser is constant (detuning_on)
    lightshift = eom_config._lightshift(
        pm.AbstractArray(amp_on), *switching_beams
    )
    if channel_obj.max_abs_detuning is not None:
        assert (
            detuning_off - lightshift >= -channel_obj.max_abs_detuning
            if lightshift < 0
            else detuning_off - lightshift
            <= channel_obj.max_abs_detuning
        )
    # The chosen detuning_off replaces the requested optimum
    # (minimizes changes when the device is switched)
    return detuning_off, switching_beams


def last_pulse_phase_drift(
    seq: Sequence, channel: str
) -> _PhaseDriftParams:
    """Drift accumulated at ``detuning_off`` since the last pulse.

    Starts counting at the later of the block start and the last real
    pulse's end (detuned delays don't reset the clock).
    """
    ch_schedule = seq._schedule[channel]
    eom_settings = ch_schedule.eom_blocks[-1]
    try:
        last_pulse_tf = ch_schedule.last_pulse_slot(
            ignore_detuned_delay=True
        ).tf
    except RuntimeError:
        last_pulse_tf = 0  # There is no previous pulse
    return _PhaseDriftParams(
        drift_rate=-eom_settings.detuning_off,
        ti=max(eom_settings.ti, last_pulse_tf),
    )


def _as_arrays(
    *values: EomValue | ResolvedOff,
) -> tuple[pm.AbstractArray, ...]:
    """Wraps resolved (non-parametrized) EOM values as arrays."""
    assert not any(isinstance(v, Parametrized) for v in values)
    return tuple(pm.AbstractArray(v) for v in values)


def begin_block(
    seq: Sequence,
    method_name: str,
    channel: str,
    amp_on: EomValue,
    detuning_on: EomValue,
    optimal_detuning_off: Union[float, Parametrized],
    correct_phase_drift: bool,
) -> None:
    """Opens an EOM block — behind both enable and modify-setpoint.

    ``method_name`` distinguishes the two public entry points: a
    setpoint change ("modify_eom_setpoint") first closes the running
    block without a buffer, and its drift correction also covers the
    closed block's tail.
    """
    modify = method_name == "modify_eom_setpoint"
    channel_obj = seq.declared_channels[channel]
    detuning_off, switching_beams = resolve_setpoint(
        seq, channel_obj, amp_on, detuning_on, optimal_detuning_off
    )
    if not seq.is_parametrized():
        amp_on_, detuning_on_, detuning_off_ = _as_arrays(
            amp_on, detuning_on, detuning_off
        )
        drift_terms: list[tuple[_PhaseDriftParams, str]] = []
        if modify:
            seq._schedule.disable_eom(channel, _skip_buffer=True)
            # The old block keeps drifting until the buffer starts
            drift_terms.append(
                (last_pulse_phase_drift(seq, channel), "ti")
            )
        new_params = _PhaseDriftParams(
            drift_rate=-detuning_off_,
            # A fresh enable waits for fall, so its block only starts
            # after fall time; a setpoint change does not
            ti=seq.get_duration(
                channel, include_fall_time=not modify
            ),
        )
        drift_terms.append((new_params, "tf"))
        seq._schedule.enable_eom(
            channel,
            amp_on_,
            detuning_on_,
            detuning_off_,
            switching_beams,
            _skip_wait_for_fall=modify,
        )
        if correct_phase_drift:
            buffer_slot = seq._last(channel)
            drift = sum(
                params.calc_phase_drift(getattr(buffer_slot, endpoint))
                for params, endpoint in drift_terms
            )
            seq._shift_away_drift(
                float(drift), buffer_slot.targets, channel_obj.basis
            )

    # Stored by hand so that the resolved 'detuning_off' replaces the
    # requested 'optimal_detuning_off'
    record_settings_call(
        seq,
        method_name,
        channel,
        amp_on,
        detuning_on,
        detuning_off,
        correct_phase_drift,
    )


def end_block(
    seq: Sequence, channel: str, correct_phase_drift: bool
) -> None:
    """Closes the running EOM block (behind ``disable_eom_mode``)."""
    if seq.is_parametrized():
        return
    seq._schedule.disable_eom(channel)
    if not correct_phase_drift:
        return
    ch_schedule = seq._schedule[channel]
    # EOM mode has just been disabled, so tf is defined
    last_eom_block_tf = cast(int, ch_schedule.eom_blocks[-1].tf)
    drift_params = last_pulse_phase_drift(seq, channel)
    seq._shift_away_drift(
        float(drift_params.calc_phase_drift(last_eom_block_tf)),
        ch_schedule[-1].targets,
        ch_schedule.channel_obj.basis,
    )


def make_block_pulse(
    seq: Sequence,
    channel: str,
    duration: Union[int, Parametrized],
    phase: EomValue,
    post_phase_shift: Union[float, Parametrized],
) -> tuple[Pulse, _PhaseDriftParams | None]:
    """A square pulse at the running block's setpoint, plus the drift
    params needed to phase-correct it (behind ``add_eom_pulse``)."""
    eom_settings = seq._schedule[channel].eom_blocks[-1]
    pulse = Pulse.ConstantPulse(
        duration,
        eom_settings.rabi_freq,
        eom_settings.detuning_on,
        phase,
        post_phase_shift=post_phase_shift,
    )
    return pulse, last_pulse_phase_drift(seq, channel)


def record_settings_call(
    seq: Sequence,
    method_name: str,
    channel: str,
    amp_on: EomValue,
    detuning_on: EomValue,
    detuning_off: ResolvedOff,
    correct_phase_drift: bool,
) -> None:
    """Records an EOM settings call with the resolved detuning_off."""
    call_container = (
        seq._to_build_calls if seq.is_parametrized() else seq._calls
    )
    call_container.append(
        _Call(
            method_name,
            (),
            dict(
                channel=channel,
                amp_on=amp_on,
                detuning_on=detuning_on,
                optimal_detuning_off=(
                    detuning_off
                    if isinstance(detuning_off, Parametrized)
                    or _any_traced(detuning_off)
                    else float(detuning_off)
                ),
                correct_phase_drift=correct_phase_drift,
            ),
        )
    )
