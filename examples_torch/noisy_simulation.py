"""Noisy emulation: SPAM + dephasing + amplitude fluctuations.

Demonstrates the three noise execution paths of the PyTorch emulator:

1. Deterministic Lindblad (``mesolve``) for pure decoherence noise;
2. Quantum-jump Monte-Carlo (``mcsolve``, trajectories batched
   on-device) when decoherence meets stochastic noise;
3. The vmapped trajectory batch for purely stochastic noise.

Run:  python examples_torch/noisy_simulation.py [--device cpu]
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

reg = pt.Register.square(2, spacing=7.0, prefix="q")


def make_seq() -> pt.Sequence:
    seq = pt.Sequence(reg, pt.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(
        pt.Pulse.ConstantPulse(600, 2 * np.pi, 0.0, 0.0), "ryd"
    )
    return seq


# 1. Pure decoherence -> master equation
nm_deph = pt.NoiseModel(dephasing_rate=0.1, relaxation_rate=0.02)
sim = TorchEmulator.from_sequence(
    make_seq(), noise_model=nm_deph, torch_device=DEVICE
)
rho = sim.run().get_final_state().full()
print(f"mesolve: trace={np.trace(rho).real:.6f}")
purity = float(np.real(np.trace(rho @ rho)))
print(f"mesolve: purity={purity:.4f} (decohered from 1.0)")

# 2. Stochastic amplitude noise -> batched trajectories
nm_amp = pt.NoiseModel(
    amp_sigma=0.05, laser_waist=120.0, runs=50, samples_per_run=1
)
np.random.seed(0)
sim2 = TorchEmulator.from_sequence(
    make_seq(), noise_model=nm_amp, torch_device=DEVICE
)
res2 = sim2.run()
counts = res2.sample_final_state(1000)
print(
    "trajectories:",
    sorted(counts.items(), key=lambda kv: -kv[1])[:3],
)

# 3. SPAM errors resample the measured bitstrings
nm_spam = pt.NoiseModel(p_false_pos=0.05, p_false_neg=0.02)
sim3 = TorchEmulator.from_sequence(
    make_seq(), noise_model=nm_spam, torch_device=DEVICE
)
res3 = sim3.run()
counts3 = res3.sample_final_state(1000)
print(
    "with SPAM:",
    sorted(counts3.items(), key=lambda kv: -kv[1])[:3],
)
