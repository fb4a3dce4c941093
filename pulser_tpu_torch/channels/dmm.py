"""The detuning map modulator (DMM) channel.

Behavioral parity with reference
``pulser-core/pulser/channels/dmm.py:33-261``.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Any, Literal, Optional

import numpy as np

import pulser_tpu_torch.math as pm
from pulser_tpu_torch.channels.base_channel import Channel
from pulser_tpu_torch.json.utils import get_dataclass_defaults
from pulser_tpu_torch.pulse import Pulse
from pulser_tpu_torch.register.weight_maps import DetuningMap

OPTIONAL_ABSTR_DMM_FIELDS = ["total_bottom_detuning", "min_avg_abs_detuning"]


def _frozen(default: Any) -> Any:
    """A dataclass field pinned to its default (hidden from init/repr)."""
    return field(default=default, init=False, repr=False)


@dataclass(init=True, frozen=True)
class DMM(Channel):
    """Defines a Detuning Map Modulator (DMM) Channel.

    A DMM defines `Global` detuning pulses (of zero amplitude and phase)
    that are locally weighted by the weights of a `DetuningMap`. The
    detuning of DMM pulses must be negative, with each detuning map spot
    between 0 and `bottom_detuning` and the sum of all spots above
    `total_bottom_detuning`. Targets the 'ground-rydberg' basis.

    Note:
        The protocol to add pulses to the DMM Channel is by default
        "no-delay".

    Args:
        bottom_detuning: Minimum possible detuning per detuning map spot
            (in rad/µs); must be below zero.
        total_bottom_detuning: Minimum possible total detuning summed over
            all detuning map spots (in rad/µs); must be below zero.
        min_avg_abs_detuning: The minimum acceptable value for the average
            absolute detuning (in rad/µs) applied on any detuning map spot
            (when not 0). Defaults to 0.
        clock_period: The duration of a clock cycle (in ns).
        min_duration: The shortest duration an instruction can take.
        max_duration: The longest duration an instruction can take.
        mod_bandwidth: The modulation bandwidth (in MHz), Pulser
            convention.
    """

    bottom_detuning: float | None = None
    total_bottom_detuning: float | None = None
    min_avg_abs_detuning: float = 0.0
    # Everything below is fixed by the nature of a DMM
    addressing: Literal["Global"] = _frozen("Global")
    max_abs_detuning: Optional[float] = _frozen(None)
    max_amp: float = _frozen(0)
    min_retarget_interval: Optional[int] = _frozen(None)
    fixed_retarget_t: Optional[int] = _frozen(None)
    max_targets: Optional[int] = _frozen(None)
    propagation_dir: tuple[float, float, float] | None = _frozen(None)
    min_avg_amp: float = _frozen(0)
    custom_phase_jump_time: int | None = _frozen(None)

    def __post_init__(self) -> None:
        super().__post_init__()
        if self.bottom_detuning and self.bottom_detuning > 0:
            raise ValueError(
                "'bottom_detuning' must be negative (got "
                f"{self.bottom_detuning})."
            )
        if self.total_bottom_detuning:
            if self.total_bottom_detuning > 0:
                raise ValueError(
                    "'total_bottom_detuning' must be negative "
                    f"(got {self.total_bottom_detuning})."
                )
            if (
                self.bottom_detuning
                and self.bottom_detuning < self.total_bottom_detuning
            ):
                raise ValueError(
                    f"'total_bottom_detuning' (got "
                    f"{self.total_bottom_detuning}) must be lower than "
                    f"'bottom_detuning' (got {self.bottom_detuning})."
                )
        if self.min_avg_abs_detuning < 0:
            raise ValueError(
                "'min_avg_abs_detuning' must be non-negative "
                f"(got {self.min_avg_abs_detuning})."
            )
        if (
            self.bottom_detuning
            and self.min_avg_abs_detuning >= -self.bottom_detuning
        ):
            bottom_detuning = self.bottom_detuning
            raise ValueError(
                f"'min_avg_abs_detuning' (got {self.min_avg_abs_detuning}) "
                f"must be lower than or equal to {-bottom_detuning=}."
            )

    @property
    def basis(self) -> Literal["ground-rydberg"]:
        """The addressed basis name."""
        return "ground-rydberg"

    def _undefined_fields(self) -> list[str]:
        maybe_missing = (
            "bottom_detuning",
            "max_duration",
            "total_bottom_detuning",
        )
        return [f_ for f_ in maybe_missing if getattr(self, f_) is None]

    def is_virtual(self) -> bool:
        """Whether the channel is virtual (i.e. partially defined)."""
        return bool(self._undefined_fields())

    def _check_spot_floor(
        self, min_det: float, weights: Any
    ) -> None:
        """Every weighted spot detuning must stay above bottom_detuning."""
        if self.bottom_detuning is None:
            return
        max_weight = np.max(weights)
        if max_weight * min_det >= self.bottom_detuning:
            return
        raise ValueError(
            f"For a detuning map with a maximum weight of {max_weight},"
            f" a DMM pulse with minimum detuning {min_det} "
            "rad/µs goes below the local bottom "
            f"detuning of the DMM ({self.bottom_detuning} rad/µs). "
            "To respect this constraint, keep the detuning above "
            f"{self.bottom_detuning / max_weight} rad/µs."
        )

    def _check_total_floor(
        self, min_det: float, weights: Any
    ) -> None:
        """The summed detuning must stay above total_bottom_detuning."""
        if self.total_bottom_detuning is None:
            return
        sum_weight = np.sum(weights)
        if sum_weight * min_det >= self.total_bottom_detuning:
            return
        raise ValueError(
            "For a detuning map with a total summed weight of "
            f"{sum_weight}, the total applied detuning from a DMM pulse "
            f"with minimum detuning {min_det} rad/µs goes"
            " below the total bottom detuning "
            f"of the DMM ({self.total_bottom_detuning} rad/µs). "
            "To respect this constraint, keep the detuning above "
            f"{self.total_bottom_detuning / sum_weight} rad/µs."
        )

    def _check_avg_threshold(
        self, round_detuning: np.ndarray, weights: Any
    ) -> None:
        """The weighted average |detuning| must clear the DMM's minimum."""
        weights_arr = np.array(weights)
        non_zero_weight_inds = np.nonzero(weights_arr)
        assert len(non_zero_weight_inds) == 1, "Weights array is not 1D"
        if len(non_zero_weight_inds[0]) == 0:
            # With all weights zero there's nothing to enforce
            return
        avg_abs_detuning = np.average(np.abs(round_detuning))
        min_non_zero_weight = np.min(weights_arr[non_zero_weight_inds])
        if (
            0
            < min_non_zero_weight * avg_abs_detuning
            < self.min_avg_abs_detuning
        ):
            raise ValueError(
                "For a detuning map with a minimum non-zero weight of "
                f"{min_non_zero_weight}, a DMM pulse with an average "
                f"absolute detuning of {avg_abs_detuning:.3g} rad/µs does"
                " not respect the minimum threshold for the average absolute"
                f" detuning of the DMM ({self.min_avg_abs_detuning} rad/µs)."
            )

    def validate_pulse(
        self,
        pulse: Pulse,
        detuning_map: DetuningMap = DetuningMap(
            trap_coordinates=[(0, 0)], weights=[1.0]
        ),
    ) -> None:
        """Checks if a pulse can be executed via this DMM on a DetuningMap.

        Args:
            pulse: The pulse to validate.
            detuning_map: The detuning map on which the pulse is applied
                (defaults to a detuning map with weight 1.0).
        """
        super().validate_pulse(pulse)
        round_detuning = pm.round(pulse.detuning.samples, 6).as_array(
            detach=True
        )
        if np.any(round_detuning > 0):
            raise ValueError("The detuning in a DMM must not be positive.")
        min_round_detuning = np.min(round_detuning)
        self._check_spot_floor(min_round_detuning, detuning_map.weights)
        self._check_total_floor(min_round_detuning, detuning_map.weights)
        self._check_avg_threshold(round_detuning, detuning_map.weights)

    def _to_abstract_repr(self, id: str) -> dict[str, Any]:
        all_fields = fields(self)
        defaults = get_dataclass_defaults(all_fields)
        params = super()._to_abstract_repr(id)
        for p in OPTIONAL_ABSTR_DMM_FIELDS:
            if params[p] == defaults[p]:
                params.pop(p, None)
        return params


def _dmm_id_from_name(dmm_name: str) -> str:
    """Converts a dmm_name into a dmm_id.

    The dmm_name is generated automatically from dmm_id as
    ``dmm_id_{number of times dmm_id has been used}``.
    """
    return "_".join(dmm_name.split("_")[0:2])


def _get_dmm_name(dmm_id: str, channels: list[str]) -> str:
    """Get the dmm_name to add a dmm_id to a list of channels."""
    matching = [k for k in channels if _dmm_id_from_name(k) == dmm_id]
    if not matching:
        return dmm_id
    return f"{dmm_id}_{len(matching)}"
