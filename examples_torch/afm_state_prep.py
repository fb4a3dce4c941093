"""Antiferromagnetic state preparation on a 3x3 Rydberg array.

The PyTorch rendition of the reference's flagship AFM tutorial:
an adiabatic amplitude-rise / detuning-sweep / amplitude-fall pulse
drives a square array through the paramagnet-to-antiferromagnet phase
transition; the final bitstring histogram concentrates on the two
checkerboard states.

Run:  python examples_torch/afm_state_prep.py [--device cpu]
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

# --- Sequence construction (identical API to the reference) --------
spacing = 6.0  # µm — strong nearest-neighbour blockade
reg = pt.Register.square(3, spacing=spacing, prefix="q")

omega_max = 2.0 * 2 * np.pi  # rad/µs
delta_0 = -6.0 * 2 * np.pi
delta_f = 2.0 * 2 * np.pi
t_rise, t_sweep, t_fall = 252, 2700, 252  # ns

seq = pt.Sequence(reg, pt.MockDevice)
seq.declare_channel("ising", "rydberg_global")
seq.add(
    pt.Pulse.ConstantDetuning(
        pt.RampWaveform(t_rise, 0.0, omega_max), delta_0, 0.0
    ),
    "ising",
)
seq.add(
    pt.Pulse.ConstantAmplitude(
        omega_max, pt.RampWaveform(t_sweep, delta_0, delta_f), 0.0
    ),
    "ising",
)
seq.add(
    pt.Pulse.ConstantDetuning(
        pt.RampWaveform(t_fall, omega_max, 0.0), delta_f, 0.0
    ),
    "ising",
)

# --- Emulation ------------------------------------------------------
sim = TorchEmulator.from_sequence(seq, torch_device=DEVICE)
results = sim.run()

counts = results.sample_final_state(2000)
top = sorted(counts.items(), key=lambda kv: -kv[1])[:6]
print("Top bitstrings (1 = Rydberg):")
for bitstring, count in top:
    print(f"  {bitstring}: {count}")

# Antiferromagnetic order: corners + center checkerboard and its
# 4-corner variant (the center site is only marginally favorable at
# this final detuning)
afm_states = ("101010101", "010101010", "101000101")
afm_weight = sum(counts.get(s, 0) for s in afm_states) / 2000
print(f"\nAFM (checkerboard-ordered) weight: {afm_weight:.1%}")

# Staggered magnetization through the sweep
obs = np.diag(
    [
        sum(
            (1 if (i // 3 + i % 3) % 2 == 0 else -1)
            * (1 - int(b))  # r-first convention: index 0 is |r>
            for i, b in enumerate(np.binary_repr(k, width=9))
        )
        for k in range(2**9)
    ]
).astype(complex)
mstag = results.expect([obs])[0]
print(
    f"staggered magnetization: start {float(np.real(mstag[0])):+.2f}"
    f" -> end {float(np.real(mstag[-1])):+.2f}"
)
