"""Solving a QUBO with the Quantum Adiabatic Algorithm (QAA).

PyTorch rendition of the reference's "QAA to solve a QUBO problem"
application tutorial (reference: tutorials/applications/QAA to solve a
QUBO problem.ipynb), with a JAX twist: the register *embedding* — atom
positions whose Rydberg interactions reproduce the QUBO couplings — is
found by gradient descent straight through the C6/r^6 interaction law,
instead of a derivative-free optimizer.

Pipeline: QUBO matrix -> differentiable embedding -> adiabatic
amplitude/detuning schedule -> sampled bitstrings -> argmin(QUBO).

Run:  python examples_torch/qubo_qaa.py [--device cpu]
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
import torch

import pulser_tpu_torch as pt
from pulser_tpu_torch.devices import DigitalAnalogDevice
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

# --- the problem: a 5-variable QUBO ---------------------------------
# cost(z) = z^T Q z over z in {0,1}^5.  Every diagonal entry rewards
# turning its bit on; strong off-diagonal penalties (20) forbid most
# pairs, except the cheap (0, 4) pairing (3).
n = 5
Q = np.full((n, n), 20.0)
Q[np.diag_indices(n)] = -8.0
Q[0, 4] = Q[4, 0] = 3.0

bitstrings = ["".join(b) for b in itertools.product("01", repeat=n)]
costs = {
    b: float(
        np.array(list(b), dtype=float)
        @ Q
        @ np.array(list(b), dtype=float)
    )
    for b in bitstrings
}
optimum = min(costs, key=costs.__getitem__)
print(f"brute-force optimum: {optimum} (cost {costs[optimum]:.1f})")
assert optimum == "10001"  # bits 0 and 4: 2*(-8) + 2*3 = -10

# --- differentiable embedding: positions from the QUBO --------------
# The Ising energy of a sampled configuration is
#   E(z) = -delta_f * sum z_i + sum_{i<j} (C6 / r_ij^6) z_i z_j
# so matching C6/r^6 to 2*Q_ij (the QUBO counts each pair twice) and
# delta_f to -Q_ii aligns the two landscapes exactly.
C6 = DigitalAnalogDevice.interaction_coeff
target = 2.0 * np.asarray(Q)


def interactions(flat_xy: torch.Tensor) -> torch.Tensor:
    """C6 / r^6 of every pair, for one layout (2n,) or a batch (S, 2n)."""
    xy = flat_xy.reshape(*flat_xy.shape[:-1], n, 2)
    diff = xy[..., :, None, :] - xy[..., None, :, :]
    r2 = (diff**2).sum(-1) + torch.eye(n, dtype=xy.dtype)  # finite diagonal
    return C6 / r2**3


def embedding_loss(flat_xy: torch.Tensor) -> torch.Tensor:
    """Hinge-matched embedding objective, one value per layout.

    Forbidden pairs only need to be *blockaded* (u >= 40 — any excess
    just strengthens the constraint), while the cheap (0, 4) pair must
    realize its penalty exactly; a soft floor keeps every distance
    above the device's 4 um minimum.
    """
    u = interactions(flat_xy)
    xy = flat_xy.reshape(*flat_xy.shape[:-1], n, 2)
    diff = xy[..., :, None, :] - xy[..., None, :, :]
    eye = torch.eye(n, dtype=xy.dtype)
    r = torch.sqrt((diff**2).sum(-1) + eye)
    strong_mask = torch.as_tensor(target == 40.0, dtype=xy.dtype) * (1.0 - eye)
    hinge = (torch.relu(40.0 - u) ** 2 * strong_mask).sum((-2, -1))
    exact = (u[..., 0, 4] - 6.0) ** 2 + (u[..., 4, 0] - 6.0) ** 2
    too_close = (torch.relu(4.5 - r) ** 2 * (1.0 - eye)).sum((-2, -1))
    return hinge + exact + 100.0 * too_close


# Adam through C6/r^6 with autograd (the raw gradient spans many
# orders of magnitude near r -> 0, so a normalizing optimizer is the
# right tool). The landscape has a poor local minimum beside the good
# one, so 8 random layouts descend together (Adam acts elementwise, so
# they stay independent) and the best one is kept.
N_STARTS = 8
generator = torch.Generator().manual_seed(0)
starts = torch.randn(N_STARTS, 2 * n, generator=generator, dtype=torch.float64)
starts = (starts * 5.0).requires_grad_(True)
opt = torch.optim.Adam([starts], lr=0.05)
for step in range(3000):
    opt.zero_grad()
    losses = embedding_loss(starts)
    losses.sum().backward()
    opt.step()
with torch.no_grad():
    losses = embedding_loss(starts)
best_start = int(torch.argmin(losses))
xy = starts.detach()[best_start]
print(f"embedding loss after Adam: {float(losses[best_start]):.2f}")

coords = xy.numpy().reshape(n, 2)
coords -= coords.mean(0)
reg = pt.Register.from_coordinates(coords, prefix="q")

# The realized couplings must rank like the penalties: the one cheap
# pair ends up much farther apart than the forbidden ones.
U = interactions(xy).numpy()
mask = ~np.eye(n, dtype=bool)
strong = U[(target == 40.0) & mask].min()
weak = U[0, 4]
print(f"realized couplings: strong >= {strong:.1f}, weak {weak:.1f}")
assert strong > 35.0, strong  # every forbidden pair blockaded
assert abs(weak - 6.0) < 1.5, weak  # the cheap pair matched

# --- the adiabatic schedule -----------------------------------------
# Ramp Omega on and off while sweeping the detuning from far-negative
# (all atoms ground) to +8 = -diag(Q); the instantaneous ground state
# morphs from |00000> into argmin(QUBO).
omega_max = 10.0  # between the weak (6) and strong (40) couplings
delta_f = 8.0
T = 6000  # ns

amp = pt.InterpolatedWaveform(T, [1e-9, omega_max, 1e-9])
det = pt.InterpolatedWaveform(T, [-delta_f, 0.0, delta_f])
seq = pt.Sequence(reg, DigitalAnalogDevice)
seq.declare_channel("ising", "rydberg_global")
seq.add(pt.Pulse(amp, det, 0.0), "ising")
seq.measure("ground-rydberg")

counts = (
    TorchEmulator.from_sequence(seq, torch_device=DEVICE)
    .run()
    .sample_final_state(N_samples=2000)
)
top = counts.most_common(4)
print("most sampled:", top)

best_sampled = top[0][0]
assert best_sampled == optimum, (best_sampled, optimum)
# The optimum should dominate the distribution, not just edge it out.
assert top[0][1] > 2000 * 0.3, top
print(
    f"QAA found {best_sampled} with probability "
    f"{top[0][1] / 2000:.2f}"
)
print("OK qubo-qaa walkthrough complete")
