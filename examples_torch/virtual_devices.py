"""Virtual devices: relax physical constraints for design exploration.

PyTorch rendition of the reference's "Virtual Devices" tutorial
(reference: tutorials/advanced_features/Virtual Devices.ipynb): a
``Device`` encodes one real QPU's constraints; ``to_virtual()`` lifts
it into a ``VirtualDevice`` you can mutate — drop limits, add channels,
reuse channels — to prototype sequences the hardware can't run yet.

Run:  python examples_torch/virtual_devices.py [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import dataclasses

import numpy as np

import pulser_tpu_torch as pt
from pulser_tpu_torch.channels import Raman, Rydberg
from pulser_tpu_torch.devices import AnalogDevice, MockDevice
from pulser_tpu_torch.ops.solver import resolve_device

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument(
    "--device",
    default=None,
    help="torch device to run on (default: the CUDA card; 'cpu' to run"
    " without one)",
)
# Nothing below runs on a device; the flag is resolved all the same,
# as in every example, so that a run without a card and without
# --device cpu stops here as the emulating examples do
DEVICE = resolve_device(parser.parse_args().device)

# --- a real device is frozen and strict -----------------------------
real = AnalogDevice
print(f"real device: {real.name}, max atoms {real.max_atom_num}")
too_many = pt.Register.square(
    int(np.ceil(np.sqrt(real.max_atom_num + 1))), spacing=5.0, prefix="q"
)
try:
    real.validate_register(too_many)
    raise AssertionError("expected the atom-count check to fire")
except ValueError as e:
    print(f"register rejected as expected: {e}")

# --- lift it to a virtual twin and relax the limits -----------------
virt = real.to_virtual()
assert type(virt).__name__ == "VirtualDevice"
# A VirtualDevice is still a dataclass: use `replace` to tweak fields.
virt = dataclasses.replace(
    virt,
    max_atom_num=None,  # no atom-count cap
    max_radial_distance=None,  # no trap-radius cap
    requires_layout=False,  # free-form registers allowed
)
virt.validate_register(too_many)  # now fine
print(
    f"virtual twin accepts {len(too_many.qubit_ids)} atoms "
    "(caps lifted)"
)

# Add a channel the real hardware does not have.
raman = Raman.Local(
    max_abs_detuning=2 * np.pi * 20,
    max_amp=2 * np.pi * 10,
    max_targets=2,
)
virt = dataclasses.replace(
    virt,
    channel_objects=tuple(virt.channel_objects) + (raman,),
    channel_ids=tuple(virt.channel_ids) + ("raman_local",),
    reusable_channels=True,
)

# Reusable channels: declare the same physical channel twice.
reg = pt.Register.from_coordinates(
    [(0.0, 0.0), (6.0, 0.0)], prefix="q"
)
seq = pt.Sequence(reg, virt)
seq.declare_channel("ryd_a", "rydberg_global")
seq.declare_channel("ryd_b", "rydberg_global")  # only legal virtually
seq.declare_channel("digital", "raman_local", initial_target="q0")
print(f"declared channels: {sorted(seq.declared_channels)}")
assert len(seq.declared_channels) == 3

seq.add(pt.Pulse.ConstantPulse(100, 2 * np.pi, 0.0, 0.0), "ryd_a")
seq.add(
    pt.Pulse.ConstantPulse(100, 2 * np.pi, 1.0, 0.0), "digital"
)
assert seq.get_duration() > 0

# --- the all-virtual MockDevice is the blank canvas -----------------
assert MockDevice.max_atom_num is None
assert MockDevice.reusable_channels
print(f"MockDevice: {MockDevice.short_description}")

# A custom Rydberg channel with tight modulation, from scratch:
fast_ryd = Rydberg.Global(
    max_abs_detuning=2 * np.pi * 40,
    max_amp=2 * np.pi * 20,
    mod_bandwidth=16,
)
custom = dataclasses.replace(
    MockDevice,
    channel_objects=(fast_ryd,),
    channel_ids=("fast_rydberg",),
    name="CustomMock",
)
s2 = pt.Sequence(reg, custom)
s2.declare_channel("ryd", "fast_rydberg")
assert s2.declared_channels["ryd"].mod_bandwidth == 16
print("custom channel device: OK")

# Virtual devices serialize like real ones. (The wire schema injects a
# default DMM when none is declared — same as the reference — so
# compare the fields we set rather than the whole dataclass.)
back = type(virt).from_abstract_repr(virt.to_abstract_repr())
assert back.channel_ids == virt.channel_ids
assert back.max_atom_num is None and back.reusable_channels
assert back.channel_objects[-1].max_targets == 2
print("virtual-device abstract-repr round trip: OK")
print("OK virtual-device walkthrough complete")
