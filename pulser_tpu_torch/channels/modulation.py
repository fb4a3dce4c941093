"""Utilities for modulation bandwidth and rise time calculations.

Behavioral parity with reference
``pulser-core/pulser/channels/modulation.py:26-141``.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "calculate_mod_bandwidth_from_intensity_rise_time",
    "calculate_mod_bandwidth_from_amplitude_rise_time",
    "calculate_amplitude_rise_time",
    "validate_mod_bandwidth",
]

# Empirical conversion factor between modulation bandwidth and rise time
MODBW_TO_TR = 0.48


def _mod_bw_rise_time_conversion(input_value: float) -> float:
    """Converts between modulation bandwidth and intensity rise time.

    Bidirectional: MHz -> ns or ns -> MHz, via the empirical factor.
    """
    return MODBW_TO_TR / input_value * 1e3


def calculate_mod_bandwidth_from_intensity_rise_time(
    intensity_rise_time: int,
) -> float:
    """Modulation bandwidth (Pulser convention) from intensity rise time.

    The bandwidth follows Pulser's non-standard definition: the frequency
    component with a 75% attenuation in amplitude (2x the -3dB bandwidth).

    Args:
        intensity_rise_time: Time to go from 10% to 90% output power in
            response to a step change (in ns).

    Returns:
        The modulation bandwidth (in MHz).
    """
    return _mod_bw_rise_time_conversion(intensity_rise_time)


def calculate_mod_bandwidth_from_amplitude_rise_time(
    amplitude_rise_time: int,
) -> float:
    """Modulation bandwidth (Pulser convention) from amplitude rise time.

    Args:
        amplitude_rise_time: Time to go from 10% to 90% output amplitude in
            response to a step change (in ns).

    Returns:
        The modulation bandwidth (in MHz).
    """
    return calculate_mod_bandwidth_from_intensity_rise_time(
        amplitude_rise_time / np.sqrt(2)  # amp rise = sqrt(2) * int rise
    )


def calculate_amplitude_rise_time(mod_bandwidth: float) -> int:
    """Amplitude rise time (in ns) from the modulation bandwidth (in MHz).

    Defined as the time taken to go from 10% to 90% output amplitude in
    response to a step change (t_amp = sqrt(2) * t_int).
    """
    return int(
        round(_mod_bw_rise_time_conversion(mod_bandwidth) * np.sqrt(2))
    )


def validate_mod_bandwidth(mod_bandwidth: float) -> None:
    """Validates that the modulation bandwidth is within acceptable limits.

    Raises:
        ValueError: If mod_bandwidth is not greater than zero.
        NotImplementedError: If mod_bandwidth exceeds the maximum allowed.
    """
    if mod_bandwidth <= 0.0:
        raise ValueError(
            "'mod_bandwidth' must be greater than zero, not"
            f" {mod_bandwidth}."
        )
    if mod_bandwidth > (
        max_bw := calculate_mod_bandwidth_from_amplitude_rise_time(1)
    ):
        raise NotImplementedError(
            f"'mod_bandwidth' must be lower than {max_bw:.0f} MHz"
        )
