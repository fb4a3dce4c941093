"""XY spin exchange between dipole-coupled Rydberg states.

In XY mode the qubit lives in two Rydberg levels coupled by a
C3/r^3 dipole-dipole flip-flop interaction whose strength carries the
(1 - 3 cos^2 theta) angular factor with respect to the magnetic
field. Starting from |duu> (one flipped spin at the chain end), the
flip-flop term makes the excitation hop coherently along the chain.

Run:  python examples_torch/xy_spin_exchange.py [--device cpu]
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

reg = pt.Register(
    {"q0": (0.0, 0.0), "q1": (8.0, 0.0), "q2": (16.0, 0.0)}
)
seq = pt.Sequence(reg, pt.MockDevice)
# The magnetic field orientation sets the interaction anisotropy;
# (0, 0, 30) G (the default) is perpendicular to the chain
seq.set_magnetic_field(0.0, 0.0, 30.0)
seq.declare_channel("mw", "mw_global")

u_nn = pt.MockDevice.interaction_coeff_xy / 8.0**3
print(f"nearest-neighbour exchange U = {u_nn:.3f} rad/µs")

# Free spin-exchange evolution under the C3 coupling (the zero-
# amplitude pulse keeps the mw channel's clock running)
seq.add(pt.Pulse.ConstantPulse(400, 0.0, 0.0, 0.0), "mw")

eval_times = np.linspace(0, seq.get_duration() * 1e-3, 51)
sim = TorchEmulator.from_sequence(
    seq, evaluation_times=eval_times, torch_device=DEVICE
)
# One flipped spin at the chain end: |d u u> in the [u, d] basis
psi0 = np.zeros(8, dtype=complex)
psi0[0b100] = 1.0  # atom 0 in 'd' (index 1), atoms 1-2 in 'u'
sim.set_initial_state(psi0)
res = sim.run()

# Track each atom's 'd'-state occupation over time: the flipped
# spin sloshes along the chain
n_ops = []
for q in range(3):
    mats = [np.eye(2, dtype=complex)] * 3
    mats[q] = np.diag([0.0, 1.0]).astype(complex)  # |d><d|
    full = mats[0]
    for m in mats[1:]:
        full = np.kron(full, m)
    n_ops.append(full)
occ = np.real(np.array(res.expect(n_ops)))  # (3, n_times)

for label, row in zip(("q0", "q1", "q2"), occ):
    spark = "".join(
        " .:-=+*#%@"[min(9, int(v * 10))] for v in row[::2]
    )
    print(f"{label}: |{spark}|  final={row[-1]:.3f}")
print("total flipped spins:", f"{occ[:, -1].sum():.3f} (conserved)")
