"""Microwave engineering of XXZ Hamiltonians in an XY Rydberg array.

The bare dipole-dipole interaction between two Rydberg levels is a
pure spin-exchange (XX+YY) flip-flop.  Following the Floquet-
engineering recipe of Geier et al. (Science 374, 1149 (2021)) — the
physics behind the reference's "Microwave-engineering of programmable
XXZ Hamiltonians" tutorial (reference: tutorials/retired/) — a
periodic train of global microwave rotation pulses transforms the
time-averaged Hamiltonian into an anisotropic XXZ model:

    free evolution  ->  H_XY  = J (XX + YY)
    +X(pi/2) ... -X(pi/2) windows rotate H_XY into J (XX + ZZ),

so a symmetric [tau, +X(pi/2), tau, -X(pi/2), tau] cycle averages to

    H_eff = J (XX + 2/3 (YY + ZZ))   (an XXZ model with Delta = 2/3
                                      along the dressed axes).

The example prepares a single flipped spin on a 3-atom chain, runs
(a) the free flip-flop and (b) the Floquet train over the same total
interaction time, and shows that the engineered anisotropy slows the
excitation transport while the total magnetization stays conserved.

Run:  python examples_torch/xxz_hamiltonians.py [--device cpu]
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

R = 12.0  # interatomic spacing (µm)
reg = pt.Register(
    {"q0": (0.0, 0.0), "q1": (R, 0.0), "q2": (2 * R, 0.0)}
)
J = pt.MockDevice.interaction_coeff_xy / R**3
print(f"nearest-neighbour exchange J = {J:.4f} rad/µs")

# Strong, fast rotation pulses: the pulse Rabi frequency must dominate
# J so each kick acts as an instantaneous global rotation.
OMEGA = 2 * np.pi * 20.0  # rad/µs
T_PI2 = int(round((np.pi / 2) / OMEGA * 1e3 / 4) * 4)  # ns, clock-safe
TAU = 300  # free-evolution window (ns)
N_CYCLES = 4


def base_seq() -> pt.Sequence:
    seq = pt.Sequence(reg, pt.MockDevice)
    seq.set_magnetic_field(0.0, 0.0, 30.0)
    seq.declare_channel("mw", "mw_global")
    return seq


def kick(seq: pt.Sequence, sign: float) -> None:
    """A global ±X(pi/2) microwave rotation."""
    phase = 0.0 if sign > 0 else np.pi
    seq.add(
        pt.Pulse.ConstantPulse(T_PI2, OMEGA, 0.0, phase),
        "mw",
        protocol="no-delay",
    )


def wait(seq: pt.Sequence, ns: int) -> None:
    seq.add(
        pt.Pulse.ConstantPulse(ns, 0.0, 0.0, 0.0),
        "mw",
        protocol="no-delay",
    )


# (a) free XY flip-flop over the full duration
seq_free = base_seq()
wait(seq_free, 3 * TAU * N_CYCLES)

# (b) Floquet train: [tau, +X(pi/2), tau, -X(pi/2), tau] x N_CYCLES
seq_xxz = base_seq()
for _ in range(N_CYCLES):
    wait(seq_xxz, TAU)
    kick(seq_xxz, +1)
    wait(seq_xxz, TAU)
    kick(seq_xxz, -1)
    wait(seq_xxz, TAU)


def run(seq: pt.Sequence) -> np.ndarray:
    sim = TorchEmulator.from_sequence(seq, torch_device=DEVICE)
    psi0 = np.zeros(8, dtype=complex)
    psi0[0b100] = 1.0  # |d u u>: flipped spin on atom 0 ([u, d] basis)
    sim.set_initial_state(psi0)
    state = np.asarray(sim.run().get_final_state().full())[:, 0]
    probs = np.abs(state) ** 2
    # per-atom 'd'-occupation (atom q <-> bit 2-q in the index)
    occ = np.array(
        [
            sum(p for i, p in enumerate(probs) if (i >> (2 - q)) & 1)
            for q in range(3)
        ]
    )
    return occ


occ_free = run(seq_free)
occ_xxz = run(seq_xxz)
print(f"free XY   d-occupation per atom: {np.round(occ_free, 4)}")
print(f"Floquet-XXZ d-occupation per atom: {np.round(occ_xxz, 4)}")

# The excitation hopped away from atom 0 under free exchange...
transferred_free = 1.0 - occ_free[0]
transferred_xxz = 1.0 - occ_xxz[0]
print(f"transport off atom 0: free={transferred_free:.4f}"
      f"  engineered={transferred_xxz:.4f}")
assert transferred_free > 0.4
assert transferred_xxz < transferred_free
# ...and the engineered anisotropy strongly suppresses the
# end-to-end (atom 0 -> atom 2) transfer
print(f"end-to-end transfer: free={occ_free[2]:.4f}"
      f"  engineered={occ_xxz[2]:.4f}")
assert occ_xxz[2] < 0.5 * occ_free[2]
print("XXZ engineering suppresses spin transport: OK")

# Total magnetization is conserved by the free flip-flop (the XY
# Hamiltonian commutes with sum_z); the rotation kicks of the Floquet
# drive move population between magnetization sectors on purpose.
total_free = float(np.sum(occ_free))
print(f"total d-occupation (free): {total_free:.6f}")
assert abs(total_free - 1.0) < 1e-3
print("magnetization conserved under free exchange: OK")
