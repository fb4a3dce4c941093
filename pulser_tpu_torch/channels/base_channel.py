"""The Channel ABC and the eigenstate registry.

Behavioral parity with reference
``pulser-core/pulser/channels/base_channel.py:49-703``: same eigenstate
ranking, rise/phase-jump times, duration & pulse validation and the
Gaussian low-pass output-modulation pipeline (fc = bw·1e-3/√(2ln2),
multiply by exp(−f²/fc²) in Fourier space).
"""

from __future__ import annotations

import warnings
from abc import ABC, abstractmethod
from collections.abc import Collection
from dataclasses import MISSING, dataclass, field, fields
from typing import Any, Literal, Optional, Type, TypeVar, cast, get_args

import numpy as np
from numpy.typing import ArrayLike

import pulser_tpu_torch.math as pm
from pulser_tpu_torch.channels.eom import BaseEOM
from pulser_tpu_torch.channels.modulation import (
    calculate_amplitude_rise_time,
    calculate_mod_bandwidth_from_amplitude_rise_time,
    validate_mod_bandwidth,
)
from pulser_tpu_torch.json.utils import get_dataclass_defaults, obj_to_dict
from pulser_tpu_torch.pulse import Pulse

# Emit duration-rounding warnings a single time only
warnings.filterwarnings("once", "A duration of")

ChannelType = TypeVar("ChannelType", bound="Channel")

OPTIONAL_ABSTR_CH_FIELDS = (
    "min_avg_amp",
    "custom_phase_jump_time",
    "propagation_dir",
)

# State labels, in the order used by the state-vector representation
States = Literal["u", "d", "r", "g", "h", "x"]

STATES_RANK = get_args(States)

EIGENSTATES: dict[str, list[States]] = {
    "ground-rydberg": ["r", "g"],
    "digital": ["g", "h"],
    "XY": ["u", "d"],  # u -> 0, d -> 1
}

# Validation groups for Channel.__post_init__. A parameter may appear
# in several groups; `local_only` ones are validated on Local channels
# and required to be None on Global ones.
_ALWAYS_CHECKED = (
    "max_amp",
    "max_abs_detuning",
    "clock_period",
    "min_duration",
    "max_duration",
    "mod_bandwidth",
    "min_avg_amp",
    "custom_phase_jump_time",
)
_LOCAL_ONLY = (
    "min_retarget_interval",
    "fixed_retarget_t",
    "max_targets",
)
_ALLOWS_ZERO = frozenset(
    (
        "max_amp",
        "max_abs_detuning",
        "min_retarget_interval",
        "fixed_retarget_t",
        "min_avg_amp",
        "custom_phase_jump_time",
    )
)
_ALLOWS_NONE = frozenset(
    (
        "max_amp",
        "max_abs_detuning",
        "max_duration",
        "mod_bandwidth",
        "max_targets",
        "custom_phase_jump_time",
    )
)


def get_states_from_bases(bases: Collection[str]) -> list[States]:
    """The states associated to a list of bases, ranked by energy."""
    all_states = set().union(*(set(EIGENSTATES[basis]) for basis in bases))
    return [state for state in STATES_RANK if state in all_states]


@dataclass(init=True, frozen=True)
class Channel(ABC):
    """Base class of a hardware channel.

    Not to be initialized itself, but rather through a child class and the
    ``Local`` or ``Global`` classmethods.

    Args:
        addressing: "Local" or "Global".
        max_abs_detuning: Maximum possible detuning (in rad/µs), in
            absolute value.
        max_amp: Maximum pulse amplitude (in rad/µs).
        min_retarget_interval: Minimum time required between the ends of
            two target instructions (in ns).
        fixed_retarget_t: Time taken to change the target (in ns).
        max_targets: How many qubits can be addressed at once by the same
            beam.
        clock_period: The duration of a clock cycle (in ns). The duration
            of a pulse or delay instruction is enforced to be a multiple
            of the clock cycle.
        min_duration: The shortest duration an instruction can take.
        max_duration: The longest duration an instruction can take.
        min_avg_amp: The minimum average amplitude of a pulse (when not
            zero).
        mod_bandwidth: The modulation bandwidth (in MHz), following
            Pulser's non-standard definition (2x the -3dB bandwidth).
        custom_phase_jump_time: An optional custom value for the phase
            jump time that overrides the default value estimated from the
            modulation bandwidth. Not enforced in EOM mode.
        propagation_dir: The propagation direction of the beam associated
            with the channel, as a vector in 3D space.
    """

    addressing: Literal["Global", "Local"]
    max_abs_detuning: Optional[float]
    max_amp: Optional[float]
    min_retarget_interval: Optional[int] = None
    fixed_retarget_t: Optional[int] = None
    max_targets: Optional[int] = None
    clock_period: int = 1  # ns
    min_duration: int = 1  # ns
    max_duration: Optional[int] = int(1e8)  # ns
    min_avg_amp: float = 0
    mod_bandwidth: Optional[float] = None  # MHz
    custom_phase_jump_time: int | None = None
    eom_config: Optional[BaseEOM] = field(init=False, default=None)
    propagation_dir: tuple[float, float, float] | None = None

    # ------------------------------------------------------------------
    # Construction & validation
    # ------------------------------------------------------------------

    @classmethod
    def _check_constructible(cls, method: str) -> None:
        """Blocks Local/Global on subclasses that pin 'addressing'."""
        addressing_field = next(
            f_ for f_ in fields(cls) if f_.name == "addressing"
        )
        if (
            not addressing_field.init
            and addressing_field.default is not MISSING
        ):
            raise NotImplementedError(
                f"{cls} cannot be initialized from `{method}` method."
            )

    @classmethod
    def Local(
        cls: Type[ChannelType],
        max_abs_detuning: Optional[float],
        max_amp: Optional[float],
        min_retarget_interval: int = 0,
        fixed_retarget_t: int = 0,
        max_targets: Optional[int] = None,
        **kwargs: Any,
    ) -> ChannelType:
        """Initializes the channel with local addressing.

        Args:
            max_abs_detuning: Maximum possible detuning (in rad/µs), in
                absolute value.
            max_amp: Maximum pulse amplitude (in rad/µs).
            min_retarget_interval: Minimum time required between two
                target instructions (in ns).
            fixed_retarget_t: Time taken to change the target (in ns).
            max_targets: Maximum number of atoms the channel can target
                simultaneously.
        """
        cls._check_constructible("Local")
        return cls(
            "Local",
            max_abs_detuning,
            max_amp,
            min_retarget_interval,
            fixed_retarget_t,
            max_targets,
            **kwargs,
        )

    @classmethod
    def Global(
        cls: Type[ChannelType],
        max_abs_detuning: Optional[float],
        max_amp: Optional[float],
        **kwargs: Any,
    ) -> ChannelType:
        """Initializes the channel with global addressing.

        Args:
            max_abs_detuning: Maximum possible detuning (in rad/µs), in
                absolute value.
            max_amp: Maximum pulse amplitude (in rad/µs).
        """
        cls._check_constructible("Global")
        return cls("Global", max_abs_detuning, max_amp, **kwargs)

    @property
    def _internal_param_valid_options(self) -> dict[str, tuple[str, ...]]:
        """Internal parameters and their valid options."""
        return dict(
            name=("Rydberg", "Raman", "Microwave", "DMM"),
            basis=tuple(EIGENSTATES.keys()),
            addressing=("Local", "Global"),
        )

    def _check_bound(self, param: str) -> None:
        """Checks one numeric parameter against its validation group."""
        value = getattr(self, param)
        if value is None:
            if param in _ALLOWS_NONE:
                return
            raise TypeError(
                f"'{param}' can't be None in a '{self.addressing}' "
                "channel."
            )
        prelude = "When defined, " if param in _ALLOWS_NONE else ""
        if param in _ALLOWS_ZERO:
            if value >= 0:
                return
            comp = "greater than or equal to zero"
        else:
            if value > 0:
                return
            comp = "greater than zero"
        raise ValueError(prelude + f"'{param}' must be {comp}, not {value}.")

    def __post_init__(self) -> None:
        """Validates the channel's parameters."""
        for param, options in self._internal_param_valid_options.items():
            value = getattr(self, param)
            assert (
                value in options
            ), f"The channel {param} must be one of {options}, not {value}."

        checked = list(_ALWAYS_CHECKED)
        if self.addressing == "Global":
            for p in _LOCAL_ONLY:
                assert (
                    getattr(self, p) is None
                ), f"'{p}' must be left as None in a Global channel."
        else:
            assert self.addressing == "Local"
            checked += _LOCAL_ONLY
            if self.propagation_dir is not None:
                raise NotImplementedError(
                    "'propagation_dir' must be left as None in Local"
                    " channels."
                )

        for param in checked:
            self._check_bound(param)

        if (
            self.max_duration is not None
            and self.max_duration < self.min_duration
        ):
            raise ValueError(
                f"When defined, 'max_duration'({self.max_duration}) must be"
                " greater than or equal to 'min_duration'"
                f"({self.min_duration})."
            )
        if self.mod_bandwidth is not None:
            validate_mod_bandwidth(self.mod_bandwidth)

        if self.eom_config is not None and self.mod_bandwidth is None:
            raise ValueError(
                "'eom_config' can't be defined in a Channel without a "
                "modulation bandwidth."
            )

        if self.propagation_dir is not None:
            dir_vector = np.array(self.propagation_dir, dtype=float)
            if dir_vector.size != 3 or np.sum(dir_vector) == 0.0:
                raise ValueError(
                    "'propagation_dir' must be given as a non-zero 3D"
                    f" vector; got {self.propagation_dir} instead."
                )
            object.__setattr__(
                self, "propagation_dir", tuple(self.propagation_dir)
            )

    # ------------------------------------------------------------------
    # Basic properties
    # ------------------------------------------------------------------

    @property
    def name(self) -> str:
        """The name of the channel."""
        return type(self).__name__

    @property
    @abstractmethod
    def basis(self) -> str:
        """The addressed basis name."""

    @property
    def eigenstates(self) -> list[States]:
        r"""The eigenstates associated with the basis.

        Labels ranked in decreasing order of their associated eigenenergy:
        "u" (up), "d" (down), "r" (rydberg), "g" (ground), "h" (hyperfine),
        "x" (error).
        """
        return EIGENSTATES[self.basis]

    @property
    def rise_time(self) -> int:
        """The amplitude rise time (in ns).

        The time taken to go from 10% to 90% output amplitude in response
        to a step change in the input.
        """
        if not self.mod_bandwidth:
            return 0
        return calculate_amplitude_rise_time(self.mod_bandwidth)

    @property
    def phase_jump_time(self) -> int:
        """Time to change the phase between consecutive pulses (in ns).

        Two times the rise time unless `custom_phase_jump_time` is set.
        """
        if self.custom_phase_jump_time is not None:
            return int(self.custom_phase_jump_time)
        return int(self.rise_time * 2)

    def _undefined_fields(self) -> list[str]:
        maybe_missing = ["max_amp", "max_abs_detuning", "max_duration"]
        if self.addressing == "Local":
            maybe_missing.append("max_targets")
        return [f_ for f_ in maybe_missing if getattr(self, f_) is None]

    def is_virtual(self) -> bool:
        """Whether the channel is virtual (i.e. partially defined)."""
        return bool(self._undefined_fields())

    def supports_eom(self) -> bool:
        """Whether the channel supports EOM mode operation."""
        return hasattr(self, "eom_config") and self.eom_config is not None

    # ------------------------------------------------------------------
    # Instruction validation
    # ------------------------------------------------------------------

    def validate_duration(self, duration: int, round_up: bool = True) -> int:
        """Validates and adapts the duration of an instruction.

        Args:
            duration: The duration to validate.
            round_up: Whether to round the duration up to the channel's
                clock period.

        Returns:
            The duration, potentially adapted to the channel's specs.
        """
        try:
            _duration = int(duration)
        except (TypeError, ValueError):
            raise TypeError(
                "duration needs to be castable to an int but "
                "type %s was provided" % type(duration)
            )

        if duration < self.min_duration:
            raise ValueError(
                "duration has to be at least " + f"{self.min_duration} ns."
            )

        if self.max_duration is not None and duration > self.max_duration:
            raise ValueError(
                "duration can be at most " + f"{self.max_duration} ns."
            )

        # Checked on the original value: a fractional duration on a
        # 1 ns clock must still round up, not silently truncate
        if round_up and duration % self.clock_period != 0:
            _duration += (
                self.clock_period - _duration % self.clock_period
            )
            warnings.warn(
                f"A duration of {duration} ns is not a multiple of "
                f"the channel's clock period ({self.clock_period} "
                f"ns). It was rounded up to {_duration} ns.",
                stacklevel=4,
            )
        return _duration

    def validate_pulse(self, pulse: Pulse) -> None:
        """Checks if a pulse can be executed on this channel.

        Args:
            pulse: The pulse to validate.
        """
        if not isinstance(pulse, Pulse):
            raise TypeError(
                f"'pulse' must be of type Pulse, not of type {type(pulse)}."
            )

        if (
            pulse.amplitude.samples.requires_grad
            or pulse.detuning.samples.requires_grad
        ):
            # Live values are not checked against the channel limits;
            # the checks run on the concrete build.
            return

        amp_samples_np = pulse.amplitude.samples.as_array(detach=True)
        if self.max_amp is not None and np.any(
            amp_samples_np > self.max_amp
        ):
            raise ValueError(
                "The pulse's amplitude goes over the maximum "
                "value allowed for the chosen channel."
            )
        det_abs = np.abs(pulse.detuning.samples.as_array(detach=True))
        if self.max_abs_detuning is not None and np.any(
            np.round(det_abs, decimals=6) > self.max_abs_detuning
        ):
            raise ValueError(
                "The pulse's detuning values go out of the range "
                "allowed for the chosen channel."
            )
        avg_amp = np.average(amp_samples_np)
        if 0 < avg_amp < self.min_avg_amp:
            raise ValueError(
                "The pulse's average amplitude is below the chosen "
                f"channel's limit ({self.min_avg_amp})."
            )

    # ------------------------------------------------------------------
    # Output modulation
    # ------------------------------------------------------------------

    @property
    def _modulation_padding(self) -> int:
        """Padding added to the input signals before modulation (samples)."""
        return self.rise_time

    @staticmethod
    def apply_modulation(
        input_samples: ArrayLike, mod_bandwidth: float
    ) -> pm.AbstractArray:
        """Applies the modulation transfer function to the input samples.

        This is strictly the application of the Gaussian low-pass transfer
        function; the samples should be padded beforehand.

        Args:
            input_samples: The samples to modulate.
            mod_bandwidth: The modulation bandwidth (in MHz), following
                Pulser's non-standard definition (2x the -3dB bandwidth).
        """
        input_samples = pm.AbstractArray(input_samples)
        fc = mod_bandwidth * 1e-3 / np.sqrt(2 * np.log(2))
        freqs = pm.fftfreq(input_samples.size)
        modulation = pm.exp(-(freqs**2) / fc**2)
        return pm.ifft(pm.fft(input_samples) * modulation).real

    def modulate(
        self,
        input_samples: ArrayLike,
        keep_ends: bool = False,
        eom: bool = False,
    ) -> pm.AbstractArray:
        """Modulates the input according to the channel's mod bandwidth.

        Args:
            input_samples: The samples to modulate.
            keep_ends: Assume the end values of the samples were kept
                constant (i.e. there is no ramp from zero on the ends).
            eom: Whether to calculate the modulation using the EOM
                bandwidth.

        Returns:
            The modulated output signal.
        """
        if eom:
            if not self.supports_eom():
                raise TypeError(f"The channel {self} does not have an EOM.")
            eom_config = cast(BaseEOM, self.eom_config)
            mod_bandwidth = eom_config.mod_bandwidth
            mod_padding = eom_config.rise_time

        elif not self.mod_bandwidth:
            warnings.warn(
                f"No modulation bandwidth defined for channel '{self}',"
                " 'Channel.modulate()' returns the 'input_samples'"
                " unchanged.",
                stacklevel=2,
            )
            return pm.AbstractArray(input_samples)
        else:
            mod_bandwidth = self.mod_bandwidth
            mod_padding = self._modulation_padding

        pad_width = mod_padding + (self.rise_time if keep_ends else 0)
        pad_mode = "edge" if keep_ends else "constant"
        samples = pm.pad(input_samples, pad_width, mode=pad_mode)
        mod_samples = self.apply_modulation(samples, mod_bandwidth)
        if keep_ends:
            # Trim the edge-extension back off
            return mod_samples[self.rise_time: -self.rise_time]
        return mod_samples

    def calc_modulation_buffer(
        self,
        input_samples: ArrayLike,
        mod_samples: ArrayLike,
        max_allowed_diff: float = 1e-2,
        eom: bool = False,
    ) -> tuple[int, int]:
        """Calculates the minimal buffers around a modulated waveform.

        Args:
            input_samples: The input samples.
            mod_samples: The modulated samples. Must be of size
                ``len(input_samples) + 2 * self.rise_time``.
            max_allowed_diff: The maximum allowed difference between the
                input and modulated samples at the end points.
            eom: Whether to calculate the buffers with the EOM bandwidth.

        Returns:
            The minimum buffer times at the start and end of the samples,
            in ns.
        """
        if eom:
            if not self.supports_eom():
                raise TypeError(f"The channel {self} does not have an EOM.")
            tr = cast(BaseEOM, self.eom_config).rise_time
        else:
            if not self.mod_bandwidth:
                raise TypeError(
                    f"The channel {self} doesn't have a modulation"
                    " bandwidth."
                )
            tr = self.rise_time
        samples = pm.pad(input_samples, tr)
        within_tol = (
            abs(samples - mod_samples).as_array(detach=True)
            <= max_allowed_diff
        )
        head_ok = np.argwhere(within_tol[:tr])
        # Last in-tolerance index of the start buffer sets 'start'
        start = tr if head_ok.size == 0 else tr - head_ok[-1][0] - 1
        tail_ok = np.argwhere(within_tol[-tr:])
        # First in-tolerance index of the end buffer sets 'end'
        end = tr if tail_ok.size == 0 else tail_ok[0][0]
        return start, end

    @property
    def _eom_buffer_time(self) -> int:
        # rise_time spans 10%→90%; twice that ≈ the full 0%→100% swing
        assert self.supports_eom(), "Can't define the EOM buffer time."
        custom = cast(BaseEOM, self.eom_config).custom_buffer_time
        return int(custom or 2 * self.rise_time)

    @property
    def _eom_buffer_mod_bandwidth(self) -> float:
        # Half the buffer time plays the role of the rise time
        return calculate_mod_bandwidth_from_amplitude_rise_time(
            self._eom_buffer_time // 2
        )

    # ------------------------------------------------------------------
    # Display & serialization
    # ------------------------------------------------------------------

    def __str__(self) -> str:
        parts = [
            f"{self.name}.{self.addressing}(",
            f"Max Absolute Detuning: {self.max_abs_detuning}",
            " rad/µs" if self.max_abs_detuning else "",
            f", Max Amplitude: {self.max_amp}",
            " rad/µs" if self.max_amp else "",
        ]
        if self.addressing == "Local":
            parts.append(
                f", Minimum retarget time: {self.min_retarget_interval} ns,"
                f" Fixed retarget time: {self.fixed_retarget_t} ns"
            )
            if self.max_targets is not None:
                parts.append(f", Max targets: {self.max_targets}")
        parts.append(
            f", Clock period: {self.clock_period} ns"
            f", Minimum pulse duration: {self.min_duration} ns"
        )
        if self.max_duration is not None:
            parts.append(f", Maximum pulse duration: {self.max_duration} ns")
        if self.mod_bandwidth:
            parts.append(f", Modulation Bandwidth: {self.mod_bandwidth} MHz")
        parts.append(f", Supports EOM: {self.supports_eom()}")
        parts.append(f", Basis: '{self.basis}')")
        return "".join(parts)

    def default_id(self) -> str:
        """Generates the default ID for indexing this channel in a Device."""
        return f"{self.name.lower()}_{self.addressing.lower()}"

    def _to_dict(
        self, _module: str = "pulser_tpu_torch.channels"
    ) -> dict[str, Any]:
        params = {
            f.name: getattr(self, f.name) for f in fields(self) if f.init
        }
        return obj_to_dict(self, _module=_module, **params)

    def _to_abstract_repr(self, id: str) -> dict[str, Any]:
        all_fields = fields(self)
        defaults = get_dataclass_defaults(all_fields)
        params = {f.name: getattr(self, f.name) for f in all_fields}
        for p in OPTIONAL_ABSTR_CH_FIELDS:
            if params[p] == defaults[p]:
                params.pop(p, None)
        return {"id": id, "basis": self.basis, **params}


def __getattr__(name: str) -> Any:
    if name == "MODBW_TO_TR":
        # Kept for backward compatibility with code that imported the
        # constant from here (reference pulser.channels.base_channel)
        from pulser_tpu_torch.channels import modulation

        warnings.warn(
            "Importing 'MODBW_TO_TR' from"
            " 'pulser_tpu_torch.channels.base_channel' is deprecated; use"
            " the conversion helpers in"
            " 'pulser_tpu_torch.channels.modulation' instead.",
            DeprecationWarning,
            stacklevel=2,
        )
        return modulation.MODBW_TO_TR
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}"
    )
