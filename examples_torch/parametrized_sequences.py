"""Parametrized sequences: declare once, build many times.

The PyTorch rendition of the reference's "parametrized sequences"
tutorial: variables defer evaluation until ``build()``, so one
sequence template sweeps a whole experiment family — here a Rabi-angle
scan — and JAX-traced builds make the whole pipeline differentiable.

Run:  python examples_torch/parametrized_sequences.py [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import numpy as np

import pulser_tpu_torch as pt
from pulser_tpu_torch.emulator import TorchEmulator
from pulser_tpu_torch.ops.solver import resolve_device

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument(
    "--device",
    default=None,
    help="torch device to run on (default: the CUDA card; 'cpu' to run"
    " without one)",
)
DEVICE = resolve_device(parser.parse_args().device)

# --- template with declared variables ------------------------------
reg = pt.Register.from_coordinates([(0.0, 0.0)], prefix="q")
seq = pt.Sequence(reg, pt.MockDevice)
seq.declare_channel("ryd", "rydberg_global")

area = seq.declare_variable("area", dtype=float)
t_pulse = seq.declare_variable("t_pulse", dtype=int)

# A Blackman pulse whose area and duration are both variables —
# the waveform object is a lazy ParamObj until build().
seq.add(
    pt.Pulse.ConstantDetuning(
        pt.BlackmanWaveform(t_pulse, area), 0.0, 0.0
    ),
    "ryd",
)
seq.measure("ground-rydberg")

assert seq.is_parametrized()
print(f"declared variables: {sorted(seq.declared_variables)}")

# --- serialization round trip of the parametrized template ---------
wire = seq.to_abstract_repr(area=np.pi, t_pulse=500)
rebuilt_template = pt.Sequence.from_abstract_repr(wire)
assert rebuilt_template.is_parametrized()
print("abstract-repr round trip: OK (still parametrized)")

# --- Rabi-angle scan: one template, many builds --------------------
angles = np.linspace(0.25, 2.0, 8) * np.pi
excited = []
for theta in angles:
    built = seq.build(area=float(theta), t_pulse=500)
    res = TorchEmulator.from_sequence(built, torch_device=DEVICE).run()
    state = np.asarray(res.get_final_state().full())[:, 0]
    # r-first convention: index 0 is the rydberg state
    excited.append(float(np.abs(state[0]) ** 2))

print("theta/pi  P(r)")
for theta, p in zip(angles, excited):
    print(f"  {theta / np.pi:4.2f}   {p:.4f}")

# Rabi physics: P(r) = sin^2(theta/2)
expected = np.sin(angles / 2) ** 2
err = float(np.abs(np.asarray(excited) - expected).max())
print(f"max |P - sin^2(theta/2)|: {err:.2e}")
assert err < 1e-3, err
print("OK parametrized-sequence walkthrough complete")
