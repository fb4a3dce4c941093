"""Per-channel instruction timelines backing ``Sequence``.

Re-implements the scheduling semantics of reference
``pulser-core/pulser/sequence/_schedule.py:35-721``: conflict-protocol
delays, phase-jump buffers, modulation fall times, EOM enable/disable
buffers, detuned delays and slot-level truncation. The timings here are
an exact behavioral contract — the parity tests compare them to the
reference at nanosecond resolution.
"""

from __future__ import annotations

import warnings
from collections.abc import Iterator
from dataclasses import dataclass, fields, replace
from typing import Dict, NamedTuple, Optional, Union, cast, overload

import numpy as np

import pulser_tpu_torch.math as pm
from pulser_tpu_torch.channels.base_channel import Channel
from pulser_tpu_torch.channels.dmm import DMM
from pulser_tpu_torch.channels.eom import RydbergBeam
from pulser_tpu_torch.pulse import Pulse
from pulser_tpu_torch.register.base_register import QubitId
from pulser_tpu_torch.register.weight_maps import DetuningMap
from pulser_tpu_torch.sampler.samples import (
    ChannelSamples,
    DMMSamples,
    _PulseTargetSlot,
)
from pulser_tpu_torch.waveforms import ConstantWaveform


class _TimeSlot(NamedTuple):
    """One timeline entry: a pulse, "delay" or "target" with its span."""

    type: Union[Pulse, str]
    ti: int
    tf: int
    targets: set[QubitId]


@dataclass
class _EOMSettings:
    """An (open or closed) EOM-mode block on a channel timeline."""

    rabi_freq: pm.AbstractArray
    detuning_on: pm.AbstractArray
    detuning_off: pm.AbstractArray
    ti: int
    tf: int | None = None
    switching_beams: tuple[RydbergBeam, ...] = ()


@dataclass
class _PhaseDriftParams:
    """Accumulated detuning-off phase drift bookkeeping (EOM mode)."""

    drift_rate: pm.AbstractArray  # rad/µs
    ti: int  # ns

    def calc_phase_drift(self, tf: int) -> pm.AbstractArray:
        """Phase accumulated between ``self.ti`` and ``tf``."""
        return self.drift_rate * (tf - self.ti) * 1e-3


@dataclass
class _ChannelSchedule:
    """The ordered slot timeline of a single declared channel."""

    channel_id: str
    channel_obj: Channel

    def __post_init__(self) -> None:
        self.slots: list[_TimeSlot] = []
        self.eom_blocks: list[_EOMSettings] = []

    def last_target(self) -> int:
        """When the channel was last retargeted (0 if never)."""
        return next(
            (s.tf for s in reversed(self.slots) if s.type == "target"),
            0,
        )

    def last_pulse_slot(
        self, ignore_detuned_delay: bool = False
    ) -> _TimeSlot:
        """The most recent slot holding an actual pulse."""
        for slot in reversed(self.slots):
            if not isinstance(slot.type, Pulse):
                continue
            if ignore_detuned_delay and self.is_detuned_delay(
                slot.type
            ):
                continue
            return slot
        raise RuntimeError("There is no slot with a pulse.")

    def in_eom_mode(self, time_slot: Optional[_TimeSlot] = None) -> bool:
        """Whether the channel (or a given slot) is inside EOM mode."""
        if time_slot is None:
            # "Currently" in EOM mode == last block is still open
            return bool(self.eom_blocks) and (
                self.eom_blocks[-1].tf is None
            )
        return any(
            start <= time_slot.ti < end
            for start, end in self.get_eom_mode_intervals()
        )

    @staticmethod
    def is_detuned_delay(pulse: Pulse) -> bool:
        """Whether a pulse is a zero-amplitude constant-detuning hold."""
        if not isinstance(pulse, Pulse):
            return False
        amp_wf = pulse.amplitude
        return bool(
            isinstance(amp_wf, ConstantWaveform)
            and amp_wf[0] == 0.0
            and isinstance(pulse.detuning, ConstantWaveform)
        )

    def get_eom_mode_intervals(self) -> list[tuple[int, int]]:
        """The [start, end) span of every EOM block (open -> now)."""
        out = []
        for block in self.eom_blocks:
            end = block.tf if block.tf is not None else self.get_duration()
            out.append((block.ti, end))
        return out

    def get_duration(self, include_fall_time: bool = False) -> int:
        """The channel duration, optionally extended by fall times."""
        end = 0
        for i, op in enumerate(reversed(self.slots)):
            if i == 0:
                end = op.tf
                if not include_fall_time:
                    return end
            if isinstance(op.type, Pulse):
                fall = op.type.fall_time(
                    self.channel_obj, in_eom_mode=self.in_eom_mode()
                )
                return max(end, op.tf + fall)
            if end - op.tf >= 2 * self.channel_obj.rise_time:
                # Anything further back has fully rung down by `end`
                return end
        return end

    def adjust_duration(self, duration: int) -> int:
        """Rounds a duration up to the channel's valid grid."""
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return self.channel_obj.validate_duration(
                max(duration, self.channel_obj.min_duration)
            )

    def _extended_slot_end(
        self, ind: int, pulse_slots: list[_TimeSlot]
    ) -> int:
        """A pulse slot's end including its (clipped) modulation tail."""
        s = pulse_slots[ind]
        fall = cast(Pulse, s.type).fall_time(
            self.channel_obj,
            in_eom_mode=self.in_eom_mode(time_slot=s),
        )
        if ind + 1 < len(pulse_slots):
            fall = min(fall, pulse_slots[ind + 1].ti - s.tf)
        return s.tf + fall

    def _phase_start(
        self,
        ind: int,
        pulse_slots: list[_TimeSlot],
        ignore_detuned_delay_phase: bool,
    ) -> int:
        """Where this pulse's phase takes over in the phase track.

        The takeover point is ``phase_jump_time`` before the pulse,
        clamped so it never reaches back into the previous real pulse
        ("no-delay" additions can shrink the buffer to zero).
        """
        ph_jump_t = self.channel_obj.phase_jump_time
        ti = pulse_slots[ind].ti
        for prev in range(ind - 1, -1, -1):
            prev_slot = pulse_slots[prev]
            if ignore_detuned_delay_phase and self.is_detuned_delay(
                cast(Pulse, prev_slot.type)
            ):
                continue
            return max(ti - ph_jump_t, prev_slot.tf)
        return 0

    def _collect_eom_buffers(
        self, amp: pm.AbstractArray, det: pm.AbstractArray
    ) -> tuple[list[tuple[int, int]], list[tuple[int, int]]]:
        """Finds the zero-amplitude buffers around every EOM block."""
        block_starts = [block.ti for block in self.eom_blocks]
        n_blocks = len(block_starts)
        starts = [(0, 0)] * n_blocks
        ends = [(0, 0)] * n_blocks
        inside = False
        block_n = -1
        for s in self.slots:
            if s.ti == -1:
                continue
            if self.in_eom_mode(s):
                if not inside:
                    inside = True
                    block_n += 1
            elif inside:
                inside = False
                # End buffer: the slot right after disabling, if the
                # amplitude is back at zero
                if amp[s.ti] == 0:
                    ends[block_n] = (s.ti, s.tf)
            if (
                block_n + 1 < n_blocks
                and s.tf == block_starts[block_n + 1]
                and det[s.tf - 1]
                == self.eom_blocks[block_n + 1].detuning_off
            ):
                # Start buffer: final detuning already sits at the
                # upcoming block's detuning_off
                starts[block_n + 1] = (s.ti, s.tf)
        return starts, ends

    def get_samples(
        self, ignore_detuned_delay_phase: bool = True
    ) -> ChannelSamples:
        """Lowers the timeline to dense amp/det/phase sample arrays."""
        pulse_slots = [
            s for s in self.slots if isinstance(s.type, Pulse)
        ]
        dt = self.get_duration()
        amp = pm.AbstractArray(np.zeros(dt))
        det = pm.AbstractArray(np.zeros(dt))
        phase = pm.AbstractArray(np.zeros(dt))
        slots: list[_PulseTargetSlot] = []

        for ind, s in enumerate(pulse_slots):
            pulse = cast(Pulse, s.type)
            amp[s.ti: s.tf] += pulse.amplitude.samples
            det[s.ti: s.tf] += pulse.detuning.samples
            slots.append(
                _PulseTargetSlot(
                    s.ti,
                    self._extended_slot_end(ind, pulse_slots),
                    s.targets,
                )
            )
            if ignore_detuned_delay_phase and self.is_detuned_delay(
                pulse
            ):
                continue
            # Overwrite from the takeover point to the end; later
            # pulses overwrite their own suffix, so the final phase
            # naturally persists
            t_start = self._phase_start(
                ind, pulse_slots, ignore_detuned_delay_phase
            )
            phase[t_start:] = pulse.phase

        eom_start_buffers, eom_end_buffers = self._collect_eom_buffers(
            amp, det
        )
        target_slots = [s for s in self.slots if s.type == "target"]

        return ChannelSamples(
            amp,
            det,
            phase,
            slots,
            self.eom_blocks,
            eom_start_buffers,
            eom_end_buffers,
            target_slots,
        )

    @overload
    def __getitem__(self, key: int) -> _TimeSlot: ...

    @overload
    def __getitem__(self, key: slice) -> list[_TimeSlot]: ...

    def __getitem__(
        self, key: Union[int, slice]
    ) -> Union[_TimeSlot, list[_TimeSlot]]:
        if key == -1 and not self.slots:
            raise ValueError("The chosen channel has no target.")
        return self.slots[key]

    def __iter__(self) -> Iterator[_TimeSlot]:
        yield from self.slots


@dataclass
class _DMMSchedule(_ChannelSchedule):
    """A channel schedule bound to a detuning map."""

    detuning_map: DetuningMap

    def __post_init__(self) -> None:
        super().__post_init__()
        self._waiting_for_first_pulse: bool = False

    def get_samples(
        self,
        ignore_detuned_delay_phase: bool = True,
        qubits: dict[QubitId, pm.AbstractArray] | None = None,
    ) -> DMMSamples:
        if qubits is None:
            raise ValueError(
                "'qubits' must be defined when extracting the samples of a"
                " DMM channel."
            )
        base = super().get_samples(
            ignore_detuned_delay_phase=ignore_detuned_delay_phase
        )
        kwargs = {
            f.name: getattr(base, f.name)
            for f in fields(base)
            if f.init
        }
        return DMMSamples(
            **kwargs, detuning_map=self.detuning_map, qubits=qubits
        )


class _Schedule(Dict[str, _ChannelSchedule]):
    """All channel timelines plus the cross-channel scheduling logic."""

    def __init__(self, max_duration: int | None = None):
        self.max_duration = max_duration
        super().__init__()

    def get_duration(
        self,
        channel: Optional[str] = None,
        include_fall_time: bool = False,
    ) -> int:
        """The longest channel duration (or one channel's)."""
        names = (channel,) if channel is not None else tuple(self)
        if not names:
            return 0
        return max(
            self[name].get_duration(include_fall_time)
            for name in names
        )

    def find_slm_mask_times(self) -> list[int]:
        """Tentative [ti, tf] of the SLM mask: the earliest real pulse.

        Only non-DMM Global channels can trigger the mask.
        """
        mask_time: list[int] = []
        for ch_schedule in self.values():
            ch_obj = ch_schedule.channel_obj
            if ch_obj.addressing != "Global" or isinstance(ch_obj, DMM):
                continue
            for slot in ch_schedule:
                if not isinstance(
                    slot.type, Pulse
                ) or ch_schedule.is_detuned_delay(slot.type):
                    continue
                if not mask_time or slot.ti < mask_time[0]:
                    mask_time = [slot.ti, slot.tf]
                break
        return mask_time

    def enable_eom(
        self,
        channel_id: str,
        amp_on: pm.AbstractArray,
        detuning_on: pm.AbstractArray,
        detuning_off: pm.AbstractArray,
        switching_beams: tuple[RydbergBeam, ...] = (),
        _skip_buffer: bool = False,
        _skip_wait_for_fall: bool = False,
    ) -> None:
        """Opens an EOM block, inserting the enable buffer if needed."""
        channel_obj = self[channel_id].channel_obj
        if not _skip_buffer and self.get_duration(channel_id):
            if not _skip_wait_for_fall:
                # The previous output must ring down first
                self.wait_for_fall(channel_id)
            buffer_ns = self[channel_id].adjust_duration(
                channel_obj._eom_buffer_time
            )
            if detuning_off != 0:
                # The buffer is a detuned hold at detuning_off
                self.add_pulse(
                    Pulse.ConstantPulse(
                        buffer_ns,
                        0.0,
                        detuning_off,
                        self._get_last_pulse_phase(channel_id),
                    ),
                    channel_id,
                    phase_barrier_ts=[0],
                    protocol="no-delay",
                )
            else:
                self.add_delay(buffer_ns, channel_id)

        self[channel_id].eom_blocks.append(
            _EOMSettings(
                rabi_freq=amp_on,
                detuning_on=detuning_on,
                detuning_off=detuning_off,
                ti=self[channel_id][-1].tf,
                switching_beams=switching_beams,
            )
        )

    def disable_eom(
        self, channel_id: str, _skip_buffer: bool = False
    ) -> None:
        """Closes the open EOM block, adding the disable buffer."""
        self[channel_id].eom_blocks[-1].tf = self[channel_id][-1].tf
        channel_obj = self[channel_id].channel_obj
        eom_config = channel_obj.eom_config
        if _skip_buffer:
            return
        if eom_config and eom_config.custom_buffer_time:
            self.add_delay(
                self[channel_id].adjust_duration(
                    channel_obj._eom_buffer_time
                ),
                channel_id,
            )
        else:
            self.wait_for_fall(channel_id)

    def make_next_pulse_slot(
        self,
        pulse: Pulse,
        channel: str,
        phase_barrier_ts: list[int],
        protocol: str,
        phase_drift_params: _PhaseDriftParams | None = None,
        block_over_max_duration: bool = False,
    ) -> _TimeSlot:
        """Computes where the next pulse lands, without committing it.

        Resolves the conflict protocol against other channels, inserts
        the phase-jump buffer when the phase changes, and (in EOM mode)
        corrects the phase for the accumulated detuning-off drift.
        """

        def corrected_phase(tf: int) -> pm.AbstractArray:
            drift = pm.AbstractArray(
                phase_drift_params.calc_phase_drift(tf)
                if phase_drift_params
                else 0
            )
            return pulse.phase - drift

        last = self[channel][-1]
        t0 = last.tf
        current_max_t = max(t0, *phase_barrier_ts)
        phase_jump_buffer = 0
        if protocol != "no-delay":
            current_max_t = self._find_add_delay(
                current_max_t, channel, protocol
            )
            try:
                last_pulse_slot = self[channel].last_pulse_slot(
                    ignore_detuned_delay=True
                )
            except RuntimeError:
                pass  # First pulse on this channel
            else:
                last_pulse = cast(Pulse, last_pulse_slot.type)
                if last_pulse.phase != corrected_phase(current_max_t):
                    # Deduct the time already elapsed since the last
                    # pulse, and let it ramp down first (EOM mode also
                    # enforces a 2*rise_time floor)
                    ch_obj = self[channel].channel_obj
                    in_eom_mode = self[channel].in_eom_mode()
                    wait = max(
                        ch_obj.phase_jump_time,
                        2 * ch_obj.rise_time * in_eom_mode,
                    )
                    phase_jump_buffer = (
                        wait
                        + last_pulse.fall_time(
                            ch_obj, in_eom_mode=in_eom_mode
                        )
                        - (t0 - last_pulse_slot.tf)
                    )

        delay_duration = max(current_max_t - t0, phase_jump_buffer)
        if delay_duration > 0:
            delay_duration = self[channel].adjust_duration(
                delay_duration
            )

        ti = t0 + delay_duration
        tf = ti + pulse.duration
        self._check_duration(tf, block_over_max_duration)
        if phase_drift_params is not None:
            # Rebuild rather than replace(): Pulse has init=False fields
            pulse = Pulse(
                amplitude=pulse.amplitude,
                detuning=pulse.detuning,
                phase=corrected_phase(ti),
                post_phase_shift=pulse.post_phase_shift,
            )
        return _TimeSlot(pulse, ti, tf, last.targets)

    def add_pulse(
        self,
        pulse: Pulse,
        channel: str,
        phase_barrier_ts: list[int],
        protocol: str,
        phase_drift_params: _PhaseDriftParams | None = None,
    ) -> None:
        """Schedules a pulse (with any implied delay before it)."""
        last = self[channel][-1]
        time_slot = self.make_next_pulse_slot(
            pulse,
            channel,
            phase_barrier_ts,
            protocol,
            phase_drift_params,
            True,
        )
        gap = time_slot.ti - last.tf
        if gap > 0:
            self.add_delay(gap, channel)
        self[channel].slots.append(time_slot)

    def add_delay(self, duration: int, channel: str) -> None:
        """Appends a delay slot (a detuned hold inside EOM mode)."""
        last = self[channel][-1]
        ti = last.tf
        tf = ti + self[channel].channel_obj.validate_duration(duration)
        self._check_duration(tf)
        eom_active = self[channel].in_eom_mode()
        if (
            eom_active
            and self[channel].eom_blocks[-1].detuning_off != 0
        ):
            hold = Pulse.ConstantPulse(
                tf - ti,
                0.0,
                self[channel].eom_blocks[-1].detuning_off,
                self._get_last_pulse_phase(channel),
            )
            self[channel].slots.append(
                _TimeSlot(hold, ti, tf, last.targets)
            )
        else:
            self[channel].slots.append(
                _TimeSlot("delay", ti, tf, last.targets)
            )

    def add_target(self, qubits_set: set[QubitId], channel: str) -> None:
        """Appends a retargeting slot, enforcing retarget timings."""
        channel_obj = self[channel].channel_obj
        if not self[channel].slots:
            self._check_duration(0)
            self[channel].slots.append(
                _TimeSlot("target", -1, 0, set(qubits_set))
            )
            return

        self.wait_for_fall(channel)
        last = self[channel][-1]
        if last.targets == qubits_set:
            return
        ti = last.tf
        retarget = cast(int, channel_obj.min_retarget_interval)
        elapsed = ti - self[channel].last_target()
        delta = cast(int, np.clip(retarget - elapsed, 0, retarget))
        if channel_obj.fixed_retarget_t:
            delta = max(delta, channel_obj.fixed_retarget_t)
        if delta != 0:
            delta = self[channel].adjust_duration(delta)
        tf = ti + delta
        self._check_duration(tf)
        self[channel].slots.append(
            _TimeSlot("target", ti, tf, set(qubits_set))
        )

    @staticmethod
    def _rewind_eom_blocks(
        threshold: int, ch_schedule: _ChannelSchedule
    ) -> None:
        """Drops/reopens EOM blocks cut by a truncation threshold."""
        for ind, block in enumerate(ch_schedule.eom_blocks):
            end = block.tf if block.tf is not None else threshold
            if block.ti < threshold <= end:
                # The cut lands inside this block: it stays, reopened
                ch_schedule.eom_blocks = ch_schedule.eom_blocks[
                    :ind
                ] + [replace(block, tf=None)]
                return
            if threshold < block.ti:
                # This block (and everything after) is gone
                ch_schedule.eom_blocks = ch_schedule.eom_blocks[:ind]
                return

    def truncate(self, duration: int) -> None:
        """Cuts every channel timeline at (a valid rounding of) t."""
        for ch_name, ch_schedule in self.items():
            self._truncate_channel(ch_name, ch_schedule, duration)

    def _truncate_channel(
        self,
        ch_name: str,
        ch_schedule: _ChannelSchedule,
        duration: int,
    ) -> None:
        all_slots = ch_schedule.slots.copy()
        if ch_schedule.get_duration() <= duration:
            return

        threshold = ch_schedule.adjust_duration(duration)
        if threshold > duration:
            # adjust_duration rounds up; truncation must round down
            threshold -= ch_schedule.channel_obj.clock_period
        # Guaranteed by the prior >= min_duration validation
        assert (
            ch_schedule.channel_obj.min_duration
            <= threshold
            <= duration
        )

        for slot_ind, slot in enumerate(all_slots):
            if slot.ti < threshold <= slot.tf:
                break

        if slot.tf == threshold:
            # Clean cut at a slot boundary
            self._rewind_eom_blocks(threshold, ch_schedule)
            ch_schedule.slots = ch_schedule.slots[: slot_ind + 1]
            return

        # Drop the cut slot; a shortened replacement may be re-added
        ch_schedule.slots = all_slots[:slot_ind]

        if (
            not ch_schedule.in_eom_mode(slot)
            and slot_ind < len(all_slots) - 1
            and ch_schedule.in_eom_mode(all_slots[slot_ind + 1])
        ):
            warnings.warn(
                f"'enable_eom_mode()' instruction on channel"
                f" {ch_name!r} at t = {threshold} ns was removed by a "
                "'truncate()' call.",
                stacklevel=3,
            )
            # The cut slot was the EOM start buffer; its block goes too
            self._rewind_eom_blocks(threshold, ch_schedule)
            return

        if not ch_schedule.in_eom_mode(
            slot
        ) and ch_schedule.in_eom_mode(all_slots[slot_ind - 1]):
            warnings.warn(
                f"'disable_eom_mode()' instruction on channel"
                f" {ch_name!r} at t = {threshold} ns was removed by a "
                "'truncate()' call.",
                stacklevel=3,
            )
            self._rewind_eom_blocks(threshold, ch_schedule)
            # The cut slot was the EOM end buffer: reopen the block
            ch_schedule.eom_blocks[-1] = replace(
                ch_schedule.eom_blocks[-1], tf=None
            )
            return

        self._rewind_eom_blocks(threshold, ch_schedule)

        if slot.type == "target":
            warnings.warn(
                f"'target()' instruction on channel {ch_name!r} at "
                f"t = {threshold} ns was removed by a "
                "'truncate()' call.",
                stacklevel=3,
            )
            return

        new_duration = threshold - slot.ti
        if new_duration < ch_schedule.channel_obj.min_duration:
            # Too short to keep in any form
            return

        if slot.type == "delay":
            self.add_delay(new_duration, ch_name)
            return

        assert isinstance(pulse := slot.type, Pulse)
        shortened = Pulse(
            amplitude=pulse.amplitude.truncated(new_duration),
            detuning=pulse.detuning.truncated(new_duration),
            phase=pulse.phase,
            # An interrupted pulse never applies its post_phase_shift
            # (documented in Sequence.truncate())
            post_phase_shift=0,
        )
        ch_schedule.slots = ch_schedule.slots[:slot_ind]
        self.add_pulse(
            shortened,
            ch_name,
            phase_barrier_ts=[0],
            protocol="no-delay",
        )

    def wait_for_fall(self, channel: str) -> None:
        """Delays until the channel's modulated output rings down."""
        fall_time = (
            self[channel].get_duration(include_fall_time=True)
            - self[channel].get_duration()
        )
        if fall_time > 0:
            self.add_delay(
                self[channel].adjust_duration(fall_time), channel
            )

    def _find_add_delay(
        self, t0: int, channel: str, protocol: str
    ) -> int:
        """Resolves the conflict protocol against the other channels.

        "min-delay" waits only on slots sharing targets; "wait-for-all"
        waits on every channel's (fall-time-extended) activity.
        """
        current_max_t = t0
        own_targets = self[channel][-1].targets
        for ch, ch_schedule in self.items():
            if ch == channel:
                continue
            ch_obj = ch_schedule.channel_obj
            in_eom_mode = ch_schedule.in_eom_mode()
            for op in ch_schedule[::-1]:
                if not isinstance(op.type, Pulse):
                    if op.tf + 2 * ch_obj.rise_time <= current_max_t:
                        # Nothing older can still be ringing
                        break
                    continue
                extended_tf = op.tf + op.type.fall_time(
                    ch_obj, in_eom_mode=in_eom_mode
                )
                if extended_tf <= current_max_t:
                    break
                if (
                    op.targets & own_targets
                    or protocol == "wait-for-all"
                ):
                    current_max_t = extended_tf
                    break
        return current_max_t

    def _get_last_pulse_phase(self, channel: str) -> pm.AbstractArray:
        try:
            last_pulse = cast(
                Pulse, self[channel].last_pulse_slot().type
            )
        except RuntimeError:
            return pm.AbstractArray(0.0)
        return last_pulse.phase

    def _check_duration(
        self, t: int, block_over_max_duration: bool = True
    ) -> None:
        if self.max_duration is None or t <= self.max_duration:
            return
        msg = (
            "The sequence's duration exceeded the maximum duration"
            f" allowed by the device ({self.max_duration} ns)."
        )
        if block_over_max_duration:
            raise RuntimeError(msg)
        warnings.warn(msg, UserWarning)
