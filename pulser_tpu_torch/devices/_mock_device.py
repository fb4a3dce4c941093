"""A virtual device for unconstrained prototyping.

Spec parity with reference
``pulser-core/pulser/devices/_mock_device.py:18``.
"""

from pulser_tpu_torch.channels import DMM, Microwave, Raman, Rydberg
from pulser_tpu_torch.devices._device_datacls import VirtualDevice

# Fully unconstrained channels: no amp/detuning/duration limits
_open_channels = tuple(
    factory(None, None, max_duration=None)
    for factory in (
        Rydberg.Global,
        Rydberg.Local,
        Raman.Global,
        Raman.Local,
        Microwave.Global,
    )
)

MockDevice = VirtualDevice(
    name="MockDevice",
    dimensions=3,
    rydberg_level=70,
    max_atom_num=None,
    max_radial_distance=None,
    min_atom_distance=0.0,
    supports_slm_mask=True,
    channel_objects=_open_channels,
    dmm_objects=(DMM(),),
    short_description="A virtual device for unconstrained prototyping.",
)
