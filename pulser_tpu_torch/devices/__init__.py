"""Neutral-atom device specifications.

:class:`Device` pins down a physical machine's constraints;
:class:`VirtualDevice` relaxes them for emulator-only use.
"""

from __future__ import annotations

from pulser_tpu_torch.devices._device_datacls import Device, VirtualDevice
from pulser_tpu_torch.devices._devices import (
    AnalogDevice,
    DigitalAnalogDevice,
    WeightedAnalogDevice,
)
from pulser_tpu_torch.devices._mock_device import MockDevice

_mock_devices: tuple[VirtualDevice, ...] = (MockDevice,)
_valid_devices: tuple[Device, ...] = (
    AnalogDevice,
    DigitalAnalogDevice,
    WeightedAnalogDevice,
)

__all__ = [
    "Device",
    "VirtualDevice",
    "AnalogDevice",
    "DigitalAnalogDevice",
    "MockDevice",
    "WeightedAnalogDevice",
]
