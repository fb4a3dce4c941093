"""Dense per-channel sample containers and their lowering passes.

Behavioral parity with reference
``pulser-core/pulser/sampler/samples.py``: amp/det/phase series per
channel, the EOM-aware output-modulation pipeline and the
``to_nested_dict`` layout consumed by the emulator.
"""

from __future__ import annotations

import itertools
from collections import defaultdict
from dataclasses import dataclass, field, replace
from typing import TYPE_CHECKING, Literal, Optional, cast, get_args

import numpy as np

import pulser_tpu_torch.math as pm
from pulser_tpu_torch.channels.base_channel import (
    EIGENSTATES,
    Channel,
    States,
    get_states_from_bases,
)
from pulser_tpu_torch.channels.eom import BaseEOM
from pulser_tpu_torch.register import QubitId
from pulser_tpu_torch.register.weight_maps import DetuningMap

if TYPE_CHECKING:
    from pulser_tpu_torch.sequence._basis_ref import _QubitRef
    from pulser_tpu_torch.sequence._schedule import _EOMSettings, _TimeSlot

# Keys of the nested sample dictionary
_GLOBAL = "Global"
_LOCAL = "Local"
_AMP = "amp"
_DET = "det"
_PHASE = "phase"


def _prepare_dict(N: int, in_xy: bool = False) -> dict:
    """An empty nested sample dictionary spanning N nanoseconds."""

    def zeros_triple() -> dict:
        return {
            q: pm.AbstractArray(np.zeros(N))
            for q in (_AMP, _DET, _PHASE)
        }

    def per_qubit() -> dict:
        return defaultdict(zeros_triple)

    if in_xy:
        return {
            _GLOBAL: {"XY": zeros_triple()},
            _LOCAL: {"XY": per_qubit()},
        }
    return {
        _GLOBAL: defaultdict(zeros_triple),
        _LOCAL: defaultdict(per_qubit),
    }


def _default_to_regular(d: dict | defaultdict) -> dict:
    """Recursively downgrades defaultdicts to plain dicts."""
    if isinstance(d, dict):
        return {k: _default_to_regular(v) for k, v in d.items()}
    return d


@dataclass
class _PulseTargetSlot:
    """A sample-level slot: a time span and the qubits it addresses.

    The stored targets alone do not determine the addressing; that
    requires the channel (or register) the slot came from.
    """

    ti: int
    tf: int
    targets: set[QubitId]


@dataclass
class _SlmMask:
    """SLM mask state: masked qubits and when the mask lifts."""

    targets: set[QubitId] = field(default_factory=set)
    end: int = 0


@dataclass
class ChannelSamples:
    """The dense sample record of one channel."""

    amp: pm.AbstractArray
    det: pm.AbstractArray
    phase: pm.AbstractArray
    slots: list[_PulseTargetSlot] = field(default_factory=list)
    eom_blocks: list[_EOMSettings] = field(default_factory=list)
    eom_start_buffers: list[tuple[int, int]] = field(default_factory=list)
    eom_end_buffers: list[tuple[int, int]] = field(default_factory=list)
    target_time_slots: list[_TimeSlot] = field(default_factory=list)
    _centered_phase: pm.AbstractArray | None = None

    def __post_init__(self) -> None:
        assert (
            len(self.amp)
            == len(self.det)
            == len(self.phase)
            == len(self.centered_phase)
        )
        self.duration = len(self.amp)
        # Slots must be well-ordered and non-overlapping
        for t in self.slots:
            assert t.ti < t.tf
        for t1, t2 in zip(self.slots, self.slots[1:]):
            assert t1.tf <= t2.ti

    @property
    def initial_targets(self) -> set[QubitId]:
        """The targets of the first retargeting (empty if none)."""
        if not self.target_time_slots:
            return set()
        return self.target_time_slots[0].targets

    @property
    def centered_phase(self) -> pm.AbstractArray:
        """The phase samples wrapped into ]-π, π]."""
        if self._centered_phase is not None:
            return self._centered_phase
        wrapped = self.phase.copy() % (2 * np.pi)
        wrapped[wrapped > np.pi] -= 2 * np.pi
        return wrapped

    @property
    def phase_modulation(self) -> pm.AbstractArray:
        r"""The equivalent phase-modulation samples (rad).

        ``φ(t) = φ_c(t) − Σ_{k≤t} δ(k)``: the running detuning
        integral folded into the (centered) phase offsets.
        """
        return self.centered_phase - pm.cumsum(self.det * 1e-3)

    def extend_duration(self, new_duration: int) -> ChannelSamples:
        """Pads the samples out to a longer duration.

        Amplitude pads with zeros; detuning pads with zero unless an
        EOM block is still open (then with its detuning_off); phase
        holds its final value.

        Args:
            new_duration: Target duration (ns), at least the current
                one.
        """
        extension = new_duration - self.duration
        if extension < 0:
            raise ValueError("Can't extend samples to a lower duration.")

        open_eom = bool(self.eom_blocks) and self.eom_blocks[-1].tf is None
        det_fill = (
            float(self.eom_blocks[-1].detuning_off) if open_eom else 0.0
        )
        padded_centered = None
        if self._centered_phase is not None:
            padded_centered = pm.pad(
                self._centered_phase,
                (0, extension),
                mode=(
                    "edge"
                    if self._centered_phase.size > 0
                    else "constant"
                ),
            )
        return replace(
            self,
            amp=pm.pad(self.amp, (0, extension)),
            det=pm.pad(
                self.det,
                (0, extension),
                mode="constant",
                constant_values=det_fill,
            ),
            phase=pm.pad(
                self.phase,
                (0, extension),
                mode="edge" if self.phase.size > 0 else "constant",
            ),
            _centered_phase=padded_centered,
        )

    def is_empty(self) -> bool:
        """True when no amplitude or detuning sample is nonzero."""
        nonzero = np.count_nonzero(
            self.amp.as_array(detach=True)
        ) + np.count_nonzero(self.det.as_array(detach=True))
        return bool(nonzero == 0)

    def _generate_std_samples(self) -> ChannelSamples:
        """The non-EOM ("standard") view of the samples.

        EOM regions are blanked: amplitude to zero and detuning to the
        block's detuning_off, so the standard modulation transitions
        smoothly into and out of the EOM-modulated regions.
        """
        std = {
            key: getattr(self, key).copy() for key in ("amp", "det")
        }
        for block in self.eom_blocks:
            span = slice(block.ti, block.tf)
            std["amp"][span] = 0
            std["det"][span] = block.detuning_off
        return replace(self, **std)

    def get_eom_mode_intervals(self) -> list[tuple[int, int]]:
        """The [start, end) spans of the EOM blocks."""
        out = []
        for block in self.eom_blocks:
            end = block.tf if block.tf is not None else self.duration
            out.append((block.ti, end))
        return out

    def in_eom_mode(self, slot: _TimeSlot | _PulseTargetSlot) -> bool:
        """Whether the given slot starts inside an EOM block."""
        return any(
            start <= slot.ti < end
            for start, end in self.get_eom_mode_intervals()
        )

    @staticmethod
    def _masked(
        samples: pm.AbstractArray,
        mask: np.ndarray,
        keep_end_values: bool = False,
    ) -> pm.AbstractArray:
        """Blanks samples outside ``mask``.

        With ``keep_end_values``, each blanked region instead holds the
        boundary sample values (last value everywhere, first value in
        the leading half for interior regions) so a follow-up
        modulation transitions smoothly.
        """
        out = samples.copy()
        mask = np.pad(mask, (0, len(out) - len(mask)), mode="edge")
        if not keep_end_values:
            out[~mask] = 0
            return out
        # Contiguous blanked regions as (start, stop) pairs
        edges = np.flatnonzero(
            np.diff(
                np.r_[np.int8(0), (~mask).view(np.int8), np.int8(0)]
            )
        )
        for start, stop in edges.reshape(-1, 2).tolist():
            width = stop - start
            if not width:
                continue  # pragma: no cover
            out[start:stop] = samples[stop - 1]
            if start > 0:
                out[start: start + width // 2] = samples[start]
        return out

    def _modulate_with_eom(
        self, channel_obj: Channel
    ) -> dict[str, pm.AbstractArray]:
        """Output modulation when EOM blocks are present.

        Standard and EOM-modulated signals are synthesized separately,
        masked to their regions (with fall-time extensions and the
        reduced-bandwidth buffer treatment for the detuning) and
        summed.
        """
        eom_samples = {
            key: getattr(self, key).copy() for key in ("amp", "det")
        }
        std_samples = self._generate_std_samples()

        # Region masks (self.duration already includes fall time)
        eom_mask = np.zeros(self.duration, dtype=bool)
        eom_mask_ext = eom_mask.copy()  # fall-time extensions only
        eom_fall_time = 2 * cast(
            BaseEOM, channel_obj.eom_config
        ).rise_time
        for block in self.eom_blocks:
            end = block.tf or self.duration
            eom_mask[block.ti: end] = True
            eom_mask_ext[end: end + eom_fall_time] = True
        eom_mask = eom_mask + eom_mask_ext

        buffers_mask = np.zeros_like(eom_mask, dtype=bool)
        for start, end in itertools.chain(
            self.eom_start_buffers, self.eom_end_buffers
        ):
            buffers_mask[start:end] = True
        buffers_mask = buffers_mask & ~eom_mask_ext
        buffer_ch_obj = replace(
            channel_obj,
            mod_bandwidth=channel_obj._eom_buffer_mod_bandwidth,
        )

        if block.tf is None:
            # Ends while still in EOM mode: the trailing fall time must
            # keep the detuning at detuning_off for modulation
            eom_samples["det"][-eom_fall_time:] = block.detuning_off

        out: dict[str, pm.AbstractArray] = {}
        for key in ("amp", "det"):
            key_samples = getattr(std_samples, key)
            modulated_std = channel_obj.modulate(
                key_samples, keep_ends=key == "det"
            )
            if key == "det":
                std_mask = ~(eom_mask + buffers_mask)
                # The buffers see a reduced modulation bandwidth; hold
                # the boundary values so the transition is flat
                modulated_buffer = buffer_ch_obj.modulate(
                    self._masked(
                        key_samples, ~std_mask, keep_end_values=True
                    ),
                    keep_ends=True,
                )
            else:
                std_mask = ~eom_mask
                modulated_buffer = (
                    pm.AbstractArray(modulated_std) * 0.0
                )

            std = self._masked(modulated_std, std_mask)
            buffers = self._masked(
                modulated_buffer[: len(std)], buffers_mask
            )

            if key == "det":
                # When an EOM block ends, the effective detuning ramps
                # back at the STANDARD bandwidth (the lightshift decays
                # together with it): substitute the standard modulation
                # into the fall-time extension
                samples_ = eom_samples[key]
                samples_[eom_mask_ext] = modulated_std[
                    : len(eom_mask_ext)
                ][eom_mask_ext]
                if eom_mask[0]:
                    # Starts in EOM mode: seed the modulation with
                    # detuning_off, dropped again afterwards
                    samples_ = pm.pad(
                        samples_,
                        (1, 0),
                        "constant",
                        constant_values=float(
                            self.eom_blocks[0].detuning_off
                        ),
                    )
                modulated_eom = channel_obj.modulate(
                    samples_, eom=True, keep_ends=True
                )[(1 if eom_mask[0] else 0):]
            else:
                modulated_eom = channel_obj.modulate(
                    eom_samples[key], eom=True
                )

            eom = self._masked(modulated_eom, eom_mask)

            # Sum std + eom + buffers, padding to the longest
            pieces = sorted([std, eom, buffers], key=len)
            total = pieces[-1]
            for arr in pieces[:-1]:
                total = total + pm.pad(
                    arr, (0, pieces[-1].size - arr.size)
                )
            out[key] = total
        return out

    def modulate(
        self, channel_obj: Channel, max_duration: Optional[int] = None
    ) -> ChannelSamples:
        """Applies the channel's output modulation to the samples.

        Detuning and phase are treated as starting at their initial
        values and holding their final ones.

        Args:
            channel_obj: The channel whose modulation model to apply.
            max_duration: Optional cap on the modulated duration (ns).
        """
        if self.eom_blocks:
            new_samples = self._modulate_with_eom(channel_obj)
        else:
            new_samples = {
                "amp": channel_obj.modulate(self.amp),
                "det": channel_obj.modulate(self.det, keep_ends=True),
            }

        new_len = len(new_samples["amp"])
        new_samples["phase"] = pm.pad(
            self.phase, (0, new_len - len(self.phase)), mode="edge"
        )
        new_samples["_centered_phase"] = pm.pad(
            self.centered_phase,
            (0, new_len - len(self.centered_phase)),
            mode="edge",
        )
        clipped = {
            key: arr.astype(float)[slice(0, max_duration)]
            for key, arr in new_samples.items()
        }
        return replace(self, **clipped)  # type: ignore[arg-type]


@dataclass
class DMMSamples(ChannelSamples):
    """Samples of a DMM channel (detuning weighted per qubit)."""

    # Defaults forced by dataclass subclassing (pre-KW_ONLY layout);
    # they are always provided in practice
    detuning_map: DetuningMap | None = None
    spot_waist: float | None = None
    qubits: dict[QubitId, pm.AbstractArray] = field(default_factory=dict)


_SamplesType = Literal["abstract", "array", "tensor"]


@dataclass
class SequenceSamples:
    """All channel samples of a sequence plus sequence-level context."""

    channels: list[str]
    samples_list: list[ChannelSamples]
    _ch_objs: dict[str, Channel]
    _basis_ref: dict[str, dict[QubitId, _QubitRef]] = field(
        default_factory=dict
    )
    _slm_mask: _SlmMask = field(default_factory=_SlmMask)
    _magnetic_field: np.ndarray | None = None
    _measurement: str | None = None

    @property
    def channel_samples(self) -> dict[str, ChannelSamples]:
        """Per-channel-name access to the samples."""
        return dict(zip(self.channels, self.samples_list))

    @property
    def max_duration(self) -> int:
        """The longest duration among the channels."""
        return max(samples.duration for samples in self.samples_list)

    @property
    def used_bases(self) -> set[str]:
        """The bases actually driven by nonzero samples."""
        return {
            ch_obj.basis
            for ch_obj, ch_samples in zip(
                self._ch_objs.values(), self.samples_list
            )
            if not ch_samples.is_empty()
        }

    @property
    def eigenbasis(self) -> list[States]:
        """The eigenstate basis an emulation of these samples needs."""
        if not self.used_bases:
            return EIGENSTATES["XY" if self._in_xy else "ground-rydberg"]
        return get_states_from_bases(self.used_bases)

    @property
    def _in_xy(self) -> bool:
        """Whether these samples live in XY mode (exclusive)."""
        bases = {ch_obj.basis for ch_obj in self._ch_objs.values()}
        if "XY" not in bases:
            return False
        assert bases == {"XY"}
        return True

    def extend_duration(self, new_duration: int) -> SequenceSamples:
        """Pads every channel's samples to a common new duration."""
        return replace(
            self,
            samples_list=[
                sample.extend_duration(new_duration)
                for sample in self.samples_list
            ],
        )

    def _emit_global(
        self, d: dict, basis: str, cs: ChannelSamples
    ) -> None:
        """Adds a Global channel's samples into the nested dict.

        In XY mode with an SLM mask, the masked window is instead
        distributed locally to the unmasked qubits.
        """
        start_t = self._slm_mask.end if basis == "XY" else 0
        d[_GLOBAL][basis][_AMP][start_t:] += cs.amp[start_t:]
        d[_GLOBAL][basis][_DET][start_t:] += cs.det[start_t:]
        d[_GLOBAL][basis][_PHASE][start_t:] += cs.phase[start_t:]
        if start_t == 0:
            return
        unmasked = cs.slots[0].targets - self._slm_mask.targets
        for t in unmasked:
            d[_LOCAL][basis][t][_AMP][:start_t] += cs.amp[:start_t]
            d[_LOCAL][basis][t][_DET][:start_t] += cs.det[:start_t]
            d[_LOCAL][basis][t][_PHASE][:start_t] += cs.phase[:start_t]

    def _emit_local(
        self,
        d: dict,
        basis: str,
        cs: ChannelSamples,
        det_weight_map: dict,
        in_xy: bool,
    ) -> None:
        """Distributes a channel's samples per targeted qubit."""
        if not cs.slots:
            # Touch the defaultdict so empty channels still register
            for t in cs.initial_targets:
                d[_LOCAL][basis][t]
        for s in cs.slots:
            for t in s.targets:
                ti = s.ti
                if in_xy and t in self._slm_mask.targets:
                    ti = max(ti, self._slm_mask.end)
                span = slice(ti, s.tf)
                d[_LOCAL][basis][t][_AMP][span] += cs.amp[span]
                d[_LOCAL][basis][t][_DET][span] += (
                    cs.det[span] * det_weight_map[t]
                )
                d[_LOCAL][basis][t][_PHASE][span] += cs.phase[span]

    def to_nested_dict(
        self,
        all_local: bool = False,
        samples_type: _SamplesType = "array",
    ) -> dict:
        """Lowers the samples into the emulator's nested-dict layout.

        Args:
            all_local: Distribute even globally-applied samples per
                individual target.
            samples_type: "array" (numpy, default), "tensor" (torch) or
                "abstract".

        Returns:
            ``{"Global"|"Local"} -> basis -> [qubit ->] quantity``
            mapping of sample arrays.
        """
        allowed = get_args(_SamplesType)
        if samples_type not in allowed:
            raise ValueError(
                f"'samples_type' must be one of {allowed!r},"
                f" not {samples_type!r}."
            )

        d = _prepare_dict(self.max_duration, in_xy=self._in_xy)
        for chname, samples in zip(self.channels, self.samples_list):
            cs = (
                samples.extend_duration(self.max_duration)
                if samples.duration != self.max_duration
                else samples
            )
            ch_obj = self._ch_objs[chname]
            basis = ch_obj.basis
            is_dmm = isinstance(samples, DMMSamples)
            if is_dmm:
                dmm = cast(DMMSamples, samples)
                det_weight_map: dict = defaultdict(
                    int,
                    cast(
                        DetuningMap, dmm.detuning_map
                    ).get_qubit_weight_map(dmm.qubits, dmm.spot_waist),
                )
            else:
                det_weight_map = defaultdict(lambda: 1.0)
            if (
                ch_obj.addressing == _GLOBAL
                and not all_local
                and not is_dmm
            ):
                self._emit_global(d, basis, cs)
            else:
                self._emit_local(
                    d, basis, cs, det_weight_map, basis == "XY"
                )

        regular_dict = _default_to_regular(d)
        if samples_type == "abstract":
            return regular_dict

        def cast_arrays(arr_dict: dict) -> dict:
            for k, v in arr_dict.items():
                if isinstance(v, dict):
                    arr_dict[k] = cast_arrays(v)
                    continue
                assert isinstance(v, pm.AbstractArray)
                arr_dict[k] = (
                    v.as_tensor()
                    if samples_type == "tensor"
                    else v.as_array(detach=True)
                )
            return arr_dict

        return cast_arrays(regular_dict)

    def __repr__(self) -> str:
        return "\n\n".join(
            f"{chname}:\n{cs!r}"
            for chname, cs in zip(self.channels, self.samples_list)
        )


# Alias kept for symmetry with older payloads
_TargetSlot = _PulseTargetSlot
