"""Solving a Maximally Weighted Independent Set (MWIS) problem.

PyTorch rendition of the reference's "QAA to solve a MWIS problem"
application tutorial (reference: tutorials/applications/QAA to solve a
MWIS problem.ipynb). The weighted analog Ising Hamiltonian does the
work: graph *edges* become blockaded atom pairs, and node *weights*
ride a ``DetuningMap`` — the DMM pulls the detuning of low-weight
nodes down so the adiabatic sweep prefers exciting the heavy ones.

Graph: nodes {0,1,2,3}, edges {0-1, 0-2, 0-3, 2-3}, weights
w = (0, 2, 2, 0).  The MWIS is {1, 2} -> bitstring "0110".

Run:  python examples_torch/mwis_qaa.py [--device cpu]
"""

from __future__ import annotations

import argparse
import itertools
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

# --- the graph ------------------------------------------------------
edges = [(0, 1), (0, 2), (0, 3), (2, 3)]
weights = np.array([0.0, 2.0, 2.0, 0.0])
n = 4

# Brute-force: maximize sum(w_i z_i) over independent sets.
best, best_val = None, -1.0
for z in itertools.product((0, 1), repeat=n):
    if any(z[i] and z[j] for i, j in edges):
        continue
    val = float(np.dot(weights, z))
    if val > best_val:
        best, best_val = "".join(map(str, z)), val
print(f"brute-force MWIS: {best} (weight {best_val})")
assert best == "0110"

# --- the register: edges inside the blockade, non-edges outside -----
# Node 0 touches everything -> center; 2 and 3 share an edge -> a
# close pair on one side; 1 sits alone on the other.  At 7 um the
# C6 coupling is ~46 rad/us (blockaded); non-edges sit at >13 um
# (~0.8 rad/us, negligible).
r = 7.0
theta = np.pi / 6  # keeps |2-3| = 2 r sin(theta) = r
coords = np.array(
    [
        (0.0, 0.0),  # node 0
        (-r, 0.0),  # node 1
        (r * np.cos(theta), r * np.sin(theta)),  # node 2
        (r * np.cos(theta), -r * np.sin(theta)),  # node 3
    ]
)
reg = pt.Register.from_coordinates(coords, prefix="q")

C6 = pt.MockDevice.interaction_coeff
dist = np.linalg.norm(coords[:, None] - coords[None, :], axis=-1)
for i, j in edges:
    assert C6 / dist[i, j] ** 6 > 40, (i, j)
for i, j in [(1, 2), (1, 3)]:
    assert C6 / dist[i, j] ** 6 < 1.0, (i, j)
print("register embeds the graph: edges blockaded, non-edges free")

# --- weights ride the DMM -------------------------------------------
# The DMM can only *lower* detunings, so the heaviest nodes take
# weight 0 (untouched) and lighter nodes are pushed down in
# proportion to their weight deficit.
eps = (weights.max() - weights) / weights.max()
det_map = reg.define_detuning_map(
    {f"q{k}": float(eps[k]) for k in range(n)}
)

seq = pt.Sequence(reg, pt.MockDevice)
seq.declare_channel("ising", "rydberg_global")
seq.config_detuning_map(det_map, "dmm_0")

# --- the adiabatic schedule -----------------------------------------
# Final single-atom energies: -6 for the heavy nodes, -(6-4) = -2 for
# the light ones; the blockade (+46) forbids edge pairs, so the
# instantaneous ground state ends at "0110" (energy ~ -11.2).
T = 6000  # ns
omega_max = 4.0  # above the non-edge coupling, below the blockade
amp = pt.InterpolatedWaveform(T, [1e-9, omega_max, 1e-9])
det = pt.InterpolatedWaveform(T, [-10.0, 0.0, 6.0])
seq.add(pt.Pulse(amp, det, 0.0), "ising")
# The DMM detuning ramps down as the global detuning ramps up.
seq.add_dmm_detuning(pt.RampWaveform(T, 0.0, -4.0), "dmm_0")
seq.measure("ground-rydberg")

counts = (
    TorchEmulator.from_sequence(seq, torch_device=DEVICE)
    .run()
    .sample_final_state(N_samples=2000)
)
top = counts.most_common(4)
print("most sampled:", top)
assert top[0][0] == best, (top, best)
assert top[0][1] > 2000 * 0.5, top
print(
    f"QAA found the MWIS {top[0][0]} with probability "
    f"{top[0][1] / 2000:.2f}"
)
print("OK mwis-qaa walkthrough complete")
