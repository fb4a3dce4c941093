"""The Rydberg blockade: the interaction that powers neutral atoms.

PyTorch rendition of the reference's introductory tutorial
(reference: tutorials/intro_rydberg_blockade.ipynb): two atoms under a
resonant global pi pulse. Far apart they excite independently; inside
the blockade radius the van der Waals shift C6/r^6 detunes the doubly
excited |rr> out of reach, the pair shares ONE excitation, and the
effective Rabi frequency speeds up by sqrt(2) - the signature every
register geometry in this framework is built around
(``Device.rydberg_blockade_radius`` inverts the same C6 law).

Run:  python examples_torch/rydberg_blockade_intro.py [--device cpu]
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


def run_pair(spacing: float) -> np.ndarray:
    """Final 2-atom state after a global resonant pi pulse."""
    reg = pt.Register.from_coordinates(
        [(-spacing / 2, 0.0), (spacing / 2, 0.0)], prefix="q"
    )
    seq = pt.Sequence(reg, pt.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(
        pt.Pulse.ConstantDetuning(
            pt.BlackmanWaveform(1000, np.pi), 0.0, 0.0
        ),
        "ryd",
    )
    res = TorchEmulator.from_sequence(seq, torch_device=DEVICE).run()
    return np.asarray(res.get_final_state().full())[:, 0]


omega_peak = float(np.max(pt.BlackmanWaveform(1000, np.pi).samples))
r_blockade = pt.MockDevice.rydberg_blockade_radius(omega_peak)
print(f"peak Omega = {omega_peak:.3f} rad/us")
print(f"blockade radius at peak Omega = {r_blockade:.2f} um")

# Far-separated atoms: independent pi rotations -> both end in |r>.
psi_far = run_pair(4 * r_blockade)
p_rr_far = float(np.abs(psi_far[0]) ** 2)  # ground-rydberg: r=0 digit
print(f"P(rr) far apart ({4 * r_blockade:.0f} um): {p_rr_far:.3f}")
assert p_rr_far > 0.95, p_rr_far

# Deep inside the blockade radius: |rr> is shifted out of resonance.
psi_near = run_pair(r_blockade / 2)
p_rr_near = float(np.abs(psi_near[0]) ** 2)
print(f"P(rr) blockaded ({r_blockade / 2:.1f} um): {p_rr_near:.4f}")
assert p_rr_near < 0.01, p_rr_near

# The surviving dynamics is a two-level oscillation between |gg> and
# the entangled symmetric state (|gr> + |rg>)/sqrt(2), at sqrt(2) *
# Omega - so the same pi pulse leaves the pair mid-rotation, sharing
# a single excitation coherently.
p_gr = float(np.abs(psi_near[1]) ** 2)  # |g r>
p_rg = float(np.abs(psi_near[2]) ** 2)  # |r g>
print(f"single-excitation shares: P(gr) = {p_gr:.3f}, P(rg) = {p_rg:.3f}")
assert abs(p_gr - p_rg) < 1e-3  # symmetric superposition
phase_match = psi_near[1] * np.conj(psi_near[2])
assert phase_match.real > 0, "excitation must be shared in phase"
print("blockade physics OK: one shared excitation, |rr> suppressed")
