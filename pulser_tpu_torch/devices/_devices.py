"""Definitions of realistic devices.

Spec parity with reference ``pulser-core/pulser/devices/_devices.py``
(the numbers are hardware specifications, part of the public contract).
"""

import numpy as np

from pulser_tpu_torch.channels import DMM, Raman, Rydberg
from pulser_tpu_torch.channels.eom import RydbergBeam, RydbergEOM
from pulser_tpu_torch.devices._device_datacls import Device
from pulser_tpu_torch.register.special_layouts import TriangularLatticeLayout

_2PI = 2 * np.pi

# Timing specs shared by every DigitalAnalogDevice channel
_DAD_CLOCK = dict(clock_period=4, min_duration=16, max_duration=2**26)
# Retargeting specs shared by its local channels
_DAD_LOCAL = dict(
    max_abs_detuning=_2PI * 20,
    max_amp=_2PI * 10,
    min_retarget_interval=220,
    fixed_retarget_t=0,
    max_targets=1,
    **_DAD_CLOCK,
)

DigitalAnalogDevice = Device(
    name="DigitalAnalogDevice",
    dimensions=2,
    rydberg_level=70,
    max_atom_num=100,
    max_radial_distance=50,
    min_atom_distance=4,
    supports_slm_mask=True,
    channel_objects=(
        Rydberg.Global(
            max_abs_detuning=_2PI * 20, max_amp=_2PI * 2.5, **_DAD_CLOCK
        ),
        Rydberg.Local(**_DAD_LOCAL),
        Raman.Local(**_DAD_LOCAL),
    ),
    dmm_objects=(
        DMM(
            bottom_detuning=-_2PI * 20,
            total_bottom_detuning=-_2PI * 2000,
            **_DAD_CLOCK,
        ),
    ),
    short_description="A device with digital and analog capabilites.",
)

_ANALOG_EOM = RydbergEOM(
    mod_bandwidth=40,
    custom_buffer_time=240,
    limiting_beam=RydbergBeam.RED,
    max_limiting_amp=_2PI * 30,
    intermediate_detuning=_2PI * 450,
    controlled_beams=(RydbergBeam.BLUE,),
)

AnalogDevice = Device(
    name="AnalogDevice",
    short_description="A realistic device for analog sequence execution.",
    dimensions=2,
    min_atom_distance=5,
    max_atom_num=80,
    max_radial_distance=38,
    rydberg_level=60,
    requires_layout=True,
    accepts_new_layouts=True,
    optimal_layout_filling=0.45,
    pre_calibrated_layouts=(TriangularLatticeLayout(61, 5),),
    max_runs=2000,
    max_sequence_duration=6000,
    channel_objects=(
        Rydberg.Global(
            max_amp=_2PI * 2,
            max_abs_detuning=_2PI * 20,
            clock_period=4,
            min_duration=16,
            mod_bandwidth=8,
            eom_config=_ANALOG_EOM,
        ),
    ),
)


WeightedAnalogDevice = Device(
    name="WeightedAnalogDevice",
    short_description=(
        "A realistic device for weighted-analog sequence execution."
    ),
    dimensions=2,
    min_atom_distance=5,
    max_atom_num=256,
    max_radial_distance=80,
    rydberg_level=75,
    supports_slm_mask=True,
    requires_layout=True,
    accepts_new_layouts=True,
    min_layout_traps=150,
    max_layout_traps=512,
    min_layout_filling=0.35,
    max_layout_filling=0.5,
    optimal_layout_filling=0.45,
    max_runs=500,
    max_sequence_duration=6000,
    channel_objects=(
        Rydberg.Global(
            max_amp=_2PI * 2,
            max_abs_detuning=_2PI * 10,
            min_avg_amp=_2PI * 0.3,
            clock_period=4,
            min_duration=16,
            mod_bandwidth=50,
        ),
    ),
    dmm_objects=(
        DMM(
            bottom_detuning=-_2PI * 10,
            total_bottom_detuning=-_2PI * 1000,
            min_avg_abs_detuning=_2PI * 0.1,
            clock_period=4,
            min_duration=16,
            mod_bandwidth=22,
        ),
    ),
)
