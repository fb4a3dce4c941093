"""Serialization: shipping sequences, devices, and layouts as JSON.

PyTorch rendition of the reference's "Serialization" tutorial
(reference: tutorials/advanced_features/Serialization.ipynb). Two wire
formats exist:

* the **abstract representation** — the schema-validated, portable
  JSON contract every Pulser-compatible consumer (QPUs, emulators,
  other SDKs) speaks; and
* the **legacy coder** format — a Python-centric encoding kept for
  backward compatibility.

Run:  python examples_torch/serialization_walkthrough.py [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import numpy as np

import pulser_tpu_torch as pt
from pulser_tpu_torch.devices import AnalogDevice, DigitalAnalogDevice
from pulser_tpu_torch.json.abstract_repr.deserializer import (
    deserialize_device,
)
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

# --- build a sequence worth shipping --------------------------------
reg = pt.Register.square(2, spacing=6.0, prefix="q")
seq = pt.Sequence(reg, DigitalAnalogDevice)
seq.declare_channel("ryd", "rydberg_global")
amp = pt.BlackmanWaveform(500, np.pi)
seq.add(pt.Pulse.ConstantDetuning(amp, -2.0, 0.0), "ryd")
seq.delay(100, "ryd")
seq.add(pt.Pulse.ConstantAmplitude(0.0, pt.RampWaveform(300, -5.0, 5.0), 0.5), "ryd")
seq.measure("ground-rydberg")

# --- abstract representation: the portable contract -----------------
wire = seq.to_abstract_repr(seq_name="demo")
payload = json.loads(wire)
print(f"abstract repr: {sorted(payload)[:6]} ...")
assert payload["name"] == "demo"
assert payload["device"]["name"] == "DigitalAnalogDevice"
assert len(payload["operations"]) == 3  # pulse, delay, pulse

rebuilt = pt.Sequence.from_abstract_repr(wire)
assert rebuilt.get_duration() == seq.get_duration()
a = seq.get_register().qubits
b = rebuilt.get_register().qubits
assert all(
    np.allclose(a[q].as_array(), b[q].as_array()) for q in a
)
print("sequence abstract-repr round trip: OK")

# Unknown fields are REJECTED — the schema is the contract.
corrupt = dict(payload)
corrupt["operations"] = [
    {**payload["operations"][0], "op": "not-a-real-op"}
]
try:
    pt.Sequence.from_abstract_repr(json.dumps(corrupt))
    raise AssertionError("expected schema validation to fire")
except Exception as e:
    print(f"schema violation rejected: {type(e).__name__}")

# --- devices and layouts travel on the same wire --------------------
dev_wire = AnalogDevice.to_abstract_repr()
dev_back = deserialize_device(dev_wire)
assert dev_back == AnalogDevice
print("device abstract-repr round trip: OK (equal to the original)")

# --- legacy coder format (backward compatibility) -------------------
legacy = seq._serialize()
legacy_back = pt.Sequence._deserialize(legacy)
assert legacy_back.get_duration() == seq.get_duration()
samples_a = seq.get_register().qubits["q0"].as_array()
samples_b = legacy_back.get_register().qubits["q0"].as_array()
assert np.allclose(samples_a, samples_b)
print("legacy coder round trip: OK")

# --- parametrized sequences serialize with open variables -----------
pseq = pt.Sequence(reg, DigitalAnalogDevice)
pseq.declare_channel("ryd", "rydberg_global")
omega = pseq.declare_variable("omega", dtype=float)
pseq.add(pt.Pulse.ConstantPulse(200, omega, 0.0, 0.0), "ryd")
# Serializing a parametrized sequence requires defaults for the open
# variables so any consumer can build it as-is.
pwire = pseq.to_abstract_repr(omega=1.5)
pback = pt.Sequence.from_abstract_repr(pwire)
assert pback.is_parametrized()
built = pback.build(omega=2.0)
assert built.get_duration() == 200
print("parametrized round trip: OK (still parametrized)")
print("OK serialization walkthrough complete")
