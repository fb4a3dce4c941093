"""Replicating a Sequence on a different device.

Behavioral parity with reference
``pulser-core/pulser/sequence/helpers/_switch_device.py:33-413``
(``switch_device``): channel matching (type/basis/addressing, EOM
configs, timing parameters), exhaustive match enumeration and strict
slot-equality verification.
"""

from __future__ import annotations

import dataclasses
import itertools
import warnings
from typing import TYPE_CHECKING, Any, cast

from pulser_tpu_torch.channels.base_channel import Channel
from pulser_tpu_torch.channels.dmm import _get_dmm_name
from pulser_tpu_torch.channels.eom import BaseEOM
from pulser_tpu_torch.devices._device_datacls import BaseDevice
from pulser_tpu_torch.exceptions.sequence import (
    PulserValueError,
    SwitchDeviceError,
)

if TYPE_CHECKING:
    from pulser_tpu_torch.sequence.sequence import Sequence

#: Channel timing parameters that must match for a strict switch.
_TIMING_PARAMS = (
    "mod_bandwidth",
    "fixed_retarget_t",
    "clock_period",
    "phase_jump_time",
)


@dataclasses.dataclass
class _MatchReport:
    """Outcome of comparing an old channel with a candidate channel.

    ``non_strict_err``/``strict_err`` are empty strings when the
    channels match (under the respective criteria); ``diff_params``
    lists the parameter names that differed (used for the slot-mismatch
    error message).
    """

    non_strict_err: str = ""
    strict_err: str = ""
    diff_params: list[str] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return (self.non_strict_err, self.strict_err) == ("", "")


def _needs_retarget_check(ch_obj: Channel) -> bool:
    """Whether min_retarget_interval matters for this channel."""
    return ch_obj.addressing == "Local" and cast(
        int, ch_obj.fixed_retarget_t
    ) < cast(int, ch_obj.min_retarget_interval)


def _compare_eom_configs(
    old_ch_obj: Channel, new_ch_obj: Channel
) -> list[str]:
    """Lists the EOM-config parameters that differ between channels.

    Parameters that cannot influence the sequence's samples (e.g.
    ``multiple_beam_control`` with a single controlled beam) are
    ignored.
    """
    new_eom_config = dataclasses.asdict(
        cast(BaseEOM, new_ch_obj.eom_config)
    )
    old_eom_config = dataclasses.asdict(
        cast(BaseEOM, old_ch_obj.eom_config)
    )
    # multiple_beam_control only matters when two beams are controlled
    if len(old_eom_config.get("controlled_beams", [])) <= 1:
        new_eom_config.pop("multiple_beam_control", None)
        old_eom_config.pop("multiple_beam_control", None)
        # Controlled beams only matter when only one beam is
        # controlled by the new EOM
        if len(new_eom_config.get("controlled_beams", [])) > 1:
            new_eom_config.pop("controlled_beams", None)
            old_eom_config.pop("controlled_beams", None)
    # controlled_beams doesn't matter if both EOMs control two beams
    elif set(new_eom_config.get("controlled_beams", [])) == set(
        old_eom_config.get("controlled_beams", [])
    ):
        new_eom_config.pop("controlled_beams", None)
        old_eom_config.pop("controlled_beams", None)
    # custom_buffer_time doesn't have to match as long as the
    # channel's effective EOM buffer time does
    if new_ch_obj._eom_buffer_time == old_ch_obj._eom_buffer_time:
        new_eom_config.pop("custom_buffer_time")
        old_eom_config.pop("custom_buffer_time")
    assert old_eom_config.keys() == new_eom_config.keys()
    return [
        param
        for param in old_eom_config
        if old_eom_config[param] != new_eom_config[param]
    ]


def switch_device(
    seq: Sequence, new_device: BaseDevice, strict: bool = False
) -> Sequence:
    """Replicates the sequence with a different device.

    Designed to replicate the sequence with as few changes to the
    original contents as possible. With ``strict``, the switch fails
    whenever it cannot guarantee that the new sequence's contents are
    left unchanged.

    Args:
        seq: The Sequence whose device should be switched.
        new_device: The target device instance.
        strict: Enforce a strict match between devices and channels to
            guarantee the pulse sequence is left unchanged.

    Returns:
        The sequence on the new device, using the matching channels of
        the former device declared in the sequence.
    """
    if seq.device == new_device:
        warnings.warn(
            "Switching a sequence to the same device"
            " returns the sequence unchanged.",
            stacklevel=2,
        )
        return seq

    if seq._in_xy:
        interaction_param = "interaction_coeff_xy"
        name_in_msg = "XY interaction coefficient"
    else:
        interaction_param = "rydberg_level"
        name_in_msg = "Rydberg level"

    if getattr(new_device, interaction_param) != getattr(
        seq.device, interaction_param
    ):
        if strict:
            raise SwitchDeviceError(
                "Strict device match failed because the"
                f" devices have different {name_in_msg}s."
            )
        warnings.warn(
            f"Switching to a device with a different {name_in_msg},"
            " check that the expected interactions still hold.",
            stacklevel=2,
        )

    # Check the register is still valid on the new device
    try:
        type(seq)(register=seq._register, device=new_device)
    except PulserValueError as e:
        raise SwitchDeviceError(
            "The existing register is incompatible with the new"
            " device."
        ) from e

    match_cache: dict[str, _MatchReport] = {}

    def check_channels_match(
        old_ch_name: str, new_ch_obj: Channel
    ) -> _MatchReport:
        """Compares an old channel against a candidate new channel."""
        cache_key = f"{old_ch_name}\x00{id(new_ch_obj)}"
        if cache_key in match_cache:
            return match_cache[cache_key]
        report = _check_channels_match(old_ch_name, new_ch_obj)
        match_cache[cache_key] = report
        return report

    def _check_channels_match(
        old_ch_name: str, new_ch_obj: Channel
    ) -> _MatchReport:
        old_ch_obj = seq.declared_channels[old_ch_name]
        if not (
            type(old_ch_obj) is type(new_ch_obj)
            and old_ch_obj.basis == new_ch_obj.basis
            and old_ch_obj.addressing == new_ch_obj.addressing
        ):
            return _MatchReport(
                " with the right type, basis and addressing."
            )
        diff_params: list[str] = []
        if old_ch_name in active_eom_channels:
            # EOM mode is used: the new device needs a matching config
            if new_ch_obj.eom_config is None:
                return _MatchReport(" with an EOM configuration.")
            assert type(new_ch_obj.eom_config) is type(
                old_ch_obj.eom_config
            )
            if strict:
                eom_diff_params = _compare_eom_configs(
                    old_ch_obj, new_ch_obj
                )
                if seq.is_parametrized() and eom_diff_params:
                    return _MatchReport(
                        "",
                        " with the same EOM configuration; they"
                        " following EOM parameters differed:"
                        f" {eom_diff_params}",
                    )
                diff_params += [
                    f"'eom_config.{p}'" for p in eom_diff_params
                ]
        if not strict:
            return _MatchReport(diff_params=diff_params)

        timing_params = list(_TIMING_PARAMS)
        if _needs_retarget_check(old_ch_obj) or _needs_retarget_check(
            new_ch_obj
        ):
            timing_params.append("min_retarget_interval")
        timing_diff_params = [
            f"{param_!r}"
            for param_ in timing_params
            if getattr(new_ch_obj, param_)
            != getattr(old_ch_obj, param_)
        ]
        if seq.is_parametrized() and timing_diff_params:
            # Timing parameters must match up-front for a parametrized
            # sequence: their effects only appear at build time
            return _MatchReport(
                "",
                f" with the same {', '.join(timing_diff_params)}.",
            )
        diff_params += timing_diff_params
        return _MatchReport(diff_params=diff_params)

    def is_good_match(channel_match: dict[str, str]) -> bool:
        used = list(channel_match.values())
        if not new_device.reusable_channels and len(set(used)) < len(
            used
        ):
            return False
        return all(
            check_channels_match(
                old_ch_name, all_channels_new_device[new_ch_name]
            ).ok
            for old_ch_name, new_ch_name in channel_match.items()
        )

    def raise_error_non_matching_channel() -> None:
        strict_error_message = ""
        ch_match_err = ""
        channel_match: dict[str, Any] = {}
        for old_ch_name in seq.declared_channels:
            channel_match[old_ch_name] = None
            base_msg = f"No match for channel {old_ch_name!r}"
            for new_ch_id, new_ch_obj in (
                all_channels_new_device.items()
            ):
                if (
                    not new_device.reusable_channels
                    and new_ch_id in channel_match.values()
                ):
                    continue
                report = check_channels_match(old_ch_name, new_ch_obj)
                if report.ok:
                    channel_match[old_ch_name] = new_ch_id
                    if ch_match_err.startswith(base_msg):
                        ch_match_err = ""
                    if strict_error_message.startswith(base_msg):
                        strict_error_message = ""
                    break
                elif report.non_strict_err != "":
                    ch_match_err = ch_match_err or (
                        base_msg + report.non_strict_err
                    )
                else:
                    strict_error_message = (
                        base_msg + report.strict_err
                    )
        assert None in channel_match.values()
        if strict_error_message:
            raise SwitchDeviceError(strict_error_message)
        raise TypeError(ch_match_err)

    def build_sequence_from_matching(
        channel_match: dict[str, str]
    ) -> Sequence:
        # Works for Sequence subclasses too
        new_seq = type(seq)(
            register=seq._register, device=new_device
        )
        old_to_new_ch_name = {}
        dmm_calls: list[str] = []
        new_seq._variables = seq.declared_variables
        for call in seq._calls[1:] + seq._to_build_calls:
            sw_args = list(call.args)
            sw_kwargs = call.kwargs.copy()
            if call.name == "declare_channel":
                if "name" in sw_kwargs:  # pragma: no cover
                    sw_kwargs["channel_id"] = channel_match[
                        sw_kwargs["name"]
                    ]
                elif "channel_id" in sw_kwargs:  # pragma: no cover
                    sw_kwargs["channel_id"] = channel_match[
                        sw_args[0]
                    ]
                else:
                    sw_args[1] = channel_match[sw_args[0]]
            elif call.name == "add_dmm_detuning":
                if "dmm_name" in sw_kwargs:  # pragma: no cover
                    sw_kwargs["dmm_name"] = channel_match[
                        sw_kwargs["dmm_name"]
                    ]
                else:
                    sw_args[1] = channel_match[sw_args[1]]
            elif call.name in (
                "config_detuning_map",
                "config_slm_mask",
            ):
                if "dmm_id" in sw_kwargs:  # pragma: no cover
                    dmm_called = _get_dmm_name(
                        sw_kwargs["dmm_id"], dmm_calls
                    )
                    sw_kwargs["dmm_id"] = channel_match[dmm_called]
                else:
                    dmm_called = _get_dmm_name(sw_args[1], dmm_calls)
                    sw_args[1] = channel_match[dmm_called]
                dmm_calls.append(dmm_called)
                new_dmm_name = _get_dmm_name(
                    channel_match[dmm_called],
                    list(new_seq.declared_channels.keys()),
                )
                # The matched DMM now goes by its newly attributed name
                channel_match[dmm_called] = new_dmm_name
                old_to_new_ch_name[dmm_called] = new_dmm_name
            getattr(new_seq, call.name)(*sw_args, **sw_kwargs)

        if strict:
            # Verify the slots up to the moment they stop being added
            # (valid even for parametrized sequences)
            for old_ch_name in seq._schedule:
                new_ch_name = old_to_new_ch_name.setdefault(
                    old_ch_name, old_ch_name
                )
                if (
                    new_seq._schedule[new_ch_name].slots
                    != seq._schedule[old_ch_name].slots
                ):
                    report = check_channels_match(
                        old_ch_name,
                        new_seq.declared_channels[new_ch_name],
                    )
                    raise SwitchDeviceError(
                        "Changing the device produced a sequence with "
                        "different samples for channel"
                        f" {old_ch_name!r}. This may be due to a"
                        " mismatch in the following parameters:"
                        f" {', '.join(report.diff_params)}"
                    )
        return new_seq

    active_eom_channels = tuple(
        {**dict(zip(("channel",), call.args)), **call.kwargs}[
            "channel"
        ]
        for call in seq._calls + seq._to_build_calls
        if call.name == "enable_eom_mode"
    )
    all_channels_new_device = {
        **new_device.channels,
        **new_device.dmm_channels,
    }
    possible_channel_match: list[dict[str, str]] = []
    for channels_comb in itertools.product(
        all_channels_new_device, repeat=len(seq.declared_channels)
    ):
        channel_match = dict(
            zip(seq.declared_channels, channels_comb)
        )
        if is_good_match(channel_match):
            possible_channel_match.append(channel_match)
    if not possible_channel_match:
        raise_error_non_matching_channel()
    err_channel_match = {}
    for channel_match in possible_channel_match:
        try:
            return build_sequence_from_matching(channel_match)
        except ValueError as e:
            err_channel_match[tuple(channel_match.items())] = str(e)
            continue
    raise SwitchDeviceError(
        "No matching found between declared channels and channels in"
        " the new device that does not modify the samples of the"
        " Sequence. Here is a list of matchings tested and their"
        f" associated errors: {err_channel_match}"
    )
