"""Configuration parameters for a channel's EOM.

Behavioral parity with reference
``pulser-core/pulser/channels/eom.py:40-334`` (detuning-off options math,
lightshift physics, beam switching combinations).
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from enum import Flag
from itertools import chain
from typing import Any, Literal, cast, overload

import numpy as np
import torch

import pulser_tpu_torch.math as pm
from pulser_tpu_torch.channels.modulation import (
    calculate_amplitude_rise_time,
    validate_mod_bandwidth,
)
from pulser_tpu_torch.json.utils import get_dataclass_defaults, obj_to_dict

OPTIONAL_ABSTR_EOM_FIELDS = (
    "multiple_beam_control",
    "custom_buffer_time",
    "blue_shift_coeff",
    "red_shift_coeff",
)

# RydbergEOM parameters that must be strictly positive
_STRICTLY_POSITIVE = (
    "max_limiting_amp",
    "intermediate_detuning",
    "blue_shift_coeff",
    "red_shift_coeff",
)


class RydbergBeam(Flag):
    """The beams that make up a Rydberg channel."""

    BLUE = 1
    RED = 2

    def _to_dict(self) -> dict[str, Any]:
        return obj_to_dict(self, self.value)

    def _to_abstract_repr(self) -> str:
        return cast(str, self.name)


# The fields are split into defaultless/defaulted base dataclasses so
# that inheritance composes without keyword-only fields (the reference
# predates KW_ONLY and we keep its positional signature).


@dataclass(frozen=True)
class _BaseEOM:
    mod_bandwidth: float  # MHz


@dataclass(frozen=True)
class _BaseEOMDefaults:
    custom_buffer_time: int | None = None  # ns


@dataclass(frozen=True)
class BaseEOM(_BaseEOMDefaults, _BaseEOM):
    """A base class for the EOM configuration.

    Args:
        mod_bandwidth: The EOM modulation bandwidth (in MHz), following
            Pulser's non-standard definition (2x the -3dB bandwidth).
        custom_buffer_time: A custom wait time to enforce during EOM
            buffers.
    """

    def __post_init__(self) -> None:
        validate_mod_bandwidth(self.mod_bandwidth)

        if (
            self.custom_buffer_time is not None
            and int(self.custom_buffer_time) <= 0
        ):
            raise ValueError(
                "'custom_buffer_time' must be greater than zero, not"
                f" {self.custom_buffer_time}."
            )

    @property
    def rise_time(self) -> int:
        """The EOM amplitude rise time (in ns)."""
        return calculate_amplitude_rise_time(self.mod_bandwidth)

    def _to_dict(self) -> dict[str, Any]:
        params = {
            f.name: getattr(self, f.name) for f in fields(self) if f.init
        }
        return obj_to_dict(self, **params)

    def _to_abstract_repr(self) -> dict[str, Any]:
        all_fields = fields(self)
        defaults = get_dataclass_defaults(all_fields)
        assert set(OPTIONAL_ABSTR_EOM_FIELDS) <= defaults.keys()
        skippable = set(OPTIONAL_ABSTR_EOM_FIELDS)
        params = {}
        for f in all_fields:
            value = getattr(self, f.name)
            if f.name in skippable and value == defaults[f.name]:
                continue
            params[f.name] = value
        return params


@dataclass(frozen=True)
class _RydbergEOM:
    limiting_beam: RydbergBeam
    max_limiting_amp: float  # rad/µs
    intermediate_detuning: float  # rad/µs
    controlled_beams: tuple[RydbergBeam, ...]


@dataclass(frozen=True)
class _RydbergEOMDefaults:
    multiple_beam_control: bool = True
    blue_shift_coeff: float = 1.0
    red_shift_coeff: float = 1.0


@dataclass(frozen=True)
class RydbergEOM(_RydbergEOMDefaults, BaseEOM, _RydbergEOM):
    """The EOM configuration for a Rydberg channel.

    Args:
        limiting_beam: The beam with the smallest amplitude range.
        max_limiting_amp: The maximum amplitude the limiting beam can
            reach, in rad/µs.
        intermediate_detuning: The detuning between the two beams, in
            rad/µs.
        controlled_beams: The beams that can be switched on/off with an
            EOM.
        mod_bandwidth: The EOM modulation bandwidth (in MHz).
        custom_buffer_time: A custom wait time to enforce during EOM
            buffers.
        multiple_beam_control: Whether both EOMs can be used
            simultaneously. Ignored when only one beam can be controlled.
        blue_shift_coeff: The weight coefficient of the blue beam's
            contribution to the lightshift.
        red_shift_coeff: The weight coefficient of the red beam's
            contribution to the lightshift.
    """

    def __post_init__(self) -> None:
        super().__post_init__()
        for param in _STRICTLY_POSITIVE:
            value = getattr(self, param)
            if value <= 0.0:
                raise ValueError(
                    f"'{param}' must be greater than zero, not {value}."
                )
        beams = self.controlled_beams
        if not isinstance(beams, tuple):
            if not isinstance(beams, list):
                raise TypeError(
                    "The 'controlled_beams' must be provided as a tuple "
                    "or list."
                )
            object.__setattr__(self, "controlled_beams", tuple(beams))
        if not self.controlled_beams:
            raise ValueError(
                "There must be at least one beam in 'controlled_beams'."
            )
        for beam in chain((self.limiting_beam,), self.controlled_beams):
            if not (
                isinstance(beam, RydbergBeam) and beam in tuple(RydbergBeam)
            ):
                raise TypeError(
                    "Every beam must be one of options of the `RydbergBeam`"
                    f" enumeration, not {self.limiting_beam}."
                )

    # -- Physics helpers -------------------------------------------------

    def _rabi_freq_per_beam(
        self, rabi_frequency: pm.AbstractArray
    ) -> dict[RydbergBeam, pm.AbstractArray]:
        """Splits an effective Rabi frequency into per-beam amplitudes.

        Uses rabi_eff = (rabi_red * rabi_blue) / (2 * int_detuning); below
        the limiting beam's ceiling the two beams are balanced so the
        lightshift vanishes, above it the limiting beam saturates.
        """
        if self.limiting_beam == RydbergBeam.RED:
            ratio = self.red_shift_coeff / self.blue_shift_coeff
        else:
            ratio = self.blue_shift_coeff / self.red_shift_coeff
        shift_factor = np.sqrt(ratio)
        limit_rabi_freq = (
            shift_factor
            * self.max_limiting_amp**2
            / (2 * self.intermediate_detuning)
        )
        other_beam = ~self.limiting_beam
        rabi = pm.AbstractArray(rabi_frequency)
        if rabi.is_tensor:
            # Branchless form: a tensor can't drive Python control
            # flow, and both branch expressions are smooth, so a
            # `where` keeps the whole path differentiable
            x = rabi.as_tensor()
            base_amp_squared = 2 * x * self.intermediate_detuning
            below = x <= limit_rabi_freq
            return {
                self.limiting_beam: pm.AbstractArray(
                    torch.where(
                        below,
                        torch.sqrt(base_amp_squared / shift_factor),
                        torch.as_tensor(
                            self.max_limiting_amp, dtype=x.dtype
                        ),
                    )
                ),
                other_beam: pm.AbstractArray(
                    torch.where(
                        below,
                        torch.sqrt(base_amp_squared * shift_factor),
                        2
                        * self.intermediate_detuning
                        * x
                        / self.max_limiting_amp,
                    )
                ),
            }
        if rabi_frequency <= limit_rabi_freq:
            # Zero-lightshift regime: balance the two beams
            base_amp_squared = (
                2 * rabi_frequency * self.intermediate_detuning
            )
            return {
                self.limiting_beam: pm.sqrt(base_amp_squared / shift_factor),
                other_beam: pm.sqrt(base_amp_squared * shift_factor),
            }
        # Saturated regime: the limiting beam is pinned at its maximum
        # and the other beam makes up the difference
        return {
            self.limiting_beam: pm.AbstractArray(self.max_limiting_amp),
            other_beam: 2
            * self.intermediate_detuning
            * rabi_frequency
            / self.max_limiting_amp,
        }

    def _lightshift(
        self, rabi_frequency: pm.AbstractArray, *beams_on: RydbergBeam
    ) -> pm.AbstractArray:
        # lightshift = (rabi_blue**2 - rabi_red**2) / 4 * int_detuning
        rabi_freqs = self._rabi_freq_per_beam(rabi_frequency)
        bias = {
            RydbergBeam.RED: -self.red_shift_coeff,
            RydbergBeam.BLUE: self.blue_shift_coeff,
        }
        # A beam that's off contributes rabi_freq = 0
        return pm.AbstractArray(
            sum(bias[beam] * rabi_freqs[beam] ** 2 for beam in beams_on)
            / (4 * self.intermediate_detuning)
        )

    @property
    def _switching_beams_combos(self) -> list[tuple[RydbergBeam, ...]]:
        combos: list[tuple[RydbergBeam, ...]] = [
            (beam,) for beam in self.controlled_beams
        ]
        if self.multiple_beam_control and len(self.controlled_beams) > 1:
            combos.append(tuple(RydbergBeam))
        return combos

    # -- Public API -------------------------------------------------------

    def detuning_off_options(
        self,
        rabi_frequency: float | pm.TensorLike,
        detuning_on: float | pm.TensorLike,
    ) -> pm.AbstractArray:
        """The possible detuning values when the amplitude is off.

        Args:
            rabi_frequency: The Rabi frequency when executing a pulse,
                in rad/µs.
            detuning_on: The detuning when executing a pulse, in rad/µs.

        Returns:
            The possible detuning values when in between pulses.
        """
        rabi_frequency = pm.AbstractArray(rabi_frequency)
        # detuning = offset + lightshift; the offset compensates the
        # both-beams-on lightshift, which is non-zero whenever the two
        # beams' Rabi frequencies differ.
        offset = pm.AbstractArray(detuning_on) - self._lightshift(
            rabi_frequency, *RydbergBeam
        )
        all_beams: set[RydbergBeam] = set(RydbergBeam)
        # Beams left on (not being switched off) set the lightshift
        lightshifts = [
            self._lightshift(rabi_frequency, *(all_beams - set(beams_off)))
            for beams_off in self._switching_beams_combos
        ]
        # Adding the offset yields the effective detuning of each option
        return pm.flatten(pm.vstack(lightshifts)) + offset

    @overload
    def calculate_detuning_off(
        self,
        amp_on: float | pm.TensorLike,
        detuning_on: float | pm.TensorLike,
        optimal_detuning_off: float,
        return_switching_beams: Literal[False],
    ) -> pm.AbstractArray: ...

    @overload
    def calculate_detuning_off(
        self,
        amp_on: float | pm.TensorLike,
        detuning_on: float | pm.TensorLike,
        optimal_detuning_off: float,
        return_switching_beams: Literal[True],
    ) -> tuple[pm.AbstractArray, tuple[RydbergBeam, ...]]: ...

    def calculate_detuning_off(
        self,
        amp_on: float | pm.TensorLike,
        detuning_on: float | pm.TensorLike,
        optimal_detuning_off: float,
        return_switching_beams: bool = False,
    ) -> Any:
        """Calculates the detuning when the amplitude is off in EOM mode.

        Args:
            amp_on: The amplitude of the EOM pulses (in rad/µs).
            detuning_on: The detuning of the EOM pulses (in rad/µs).
            optimal_detuning_off: The optimal detuning value (in rad/µs)
                when no pulse is being played. The closest value among the
                existing options is chosen.
            return_switching_beams: Whether to also return the beams that
                switch on and off.
        """
        off_options = self.detuning_off_options(amp_on, detuning_on)
        if off_options.is_tensor or isinstance(
            optimal_detuning_off, torch.Tensor
        ):
            # Keep the selection inside the autograd graph so gradients
            # flow through the chosen option (the index itself is
            # discrete and carries no gradient)
            opts = off_options.as_tensor()
            closest_option = torch.argmin(
                torch.abs(opts - optimal_detuning_off)
            )
            best_det_off = pm.AbstractArray(opts[closest_option])
        else:
            closest_option = np.abs(
                off_options.as_array() - optimal_detuning_off
            ).argmin()
            best_det_off = off_options[closest_option]
        if return_switching_beams:
            return best_det_off, self._switching_beams_combos[
                int(closest_option)
            ]
        return best_det_off


def __getattr__(name: str) -> Any:
    if name == "MODBW_TO_TR":
        # Kept for backward compatibility with code that imported the
        # constant from here (reference pulser.channels.eom)
        import warnings

        from pulser_tpu_torch.channels import modulation

        warnings.warn(
            "Importing 'MODBW_TO_TR' from 'pulser_tpu_torch.channels.eom' is"
            " deprecated; use the conversion helpers in"
            " 'pulser_tpu_torch.channels.modulation' instead.",
            DeprecationWarning,
            stacklevel=2,
        )
        return modulation.MODBW_TO_TR
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}"
    )
