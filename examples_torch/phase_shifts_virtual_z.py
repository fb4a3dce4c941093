"""Phase shifts and virtual-Z gates on the digital (hyperfine) basis.

PyTorch rendition of the reference's "Phase Shifts and Virtual Z
gates" tutorial (reference: tutorials/advanced_features/Phase Shifts
and Virtual Z gates.ipynb): a ``phase_shift`` costs zero time — it just
rotates the phase reference every later pulse on that basis sees — so a
Ramsey pair of pi/2 pulses separated by a shift phi traces the textbook
fringe.

Run:  python examples_torch/phase_shifts_virtual_z.py [--device cpu]
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


def ramsey(phi: float) -> tuple[float, int]:
    """P(still ground) after pi/2 . Rz(phi) . pi/2, and total duration."""
    reg = pt.Register.from_coordinates([(0.0, 0.0)], prefix="q")
    seq = pt.Sequence(reg, pt.MockDevice)
    seq.declare_channel("digital", "raman_local", initial_target="q0")

    # pi/2 pulse: area = Omega * T = pi/2
    half_pi = pt.Pulse.ConstantDetuning(
        pt.BlackmanWaveform(200, np.pi / 2), 0.0, 0.0
    )
    seq.add(half_pi, "digital")
    # The virtual-Z gate: free, instantaneous, per-qubit, per-basis.
    seq.phase_shift(phi, "q0", basis="digital")
    seq.add(half_pi, "digital")
    seq.measure("digital")

    res = TorchEmulator.from_sequence(seq, torch_device=DEVICE).run()
    state = np.asarray(res.get_final_state().full())[:, 0]
    # digital basis ordering is g-first: index 0 = |g>, 1 = |h>
    return float(np.abs(state[0]) ** 2), seq.get_duration()


# A phase shift adds NO time to the channel: both builds last 400 ns.
p0, t0 = ramsey(0.0)
p_pi, t_pi = ramsey(np.pi)
assert t0 == t_pi == 400, (t0, t_pi)
print(f"duration with/without shift: {t_pi} ns == {t0} ns (free gate)")

# phi = 0: the two pi/2 pulses compose to a pi pulse -> fully excited.
print(f"P(g | phi=0)  = {p0:.4f}")
assert p0 < 1e-3, p0
# phi = pi: the second pulse undoes the first -> back to ground.
print(f"P(g | phi=pi) = {p_pi:.4f}")
assert p_pi > 1 - 1e-3, p_pi

# Full fringe: P(g) = sin^2(phi / 2).
phis = np.linspace(0.0, 2 * np.pi, 9)
fringe = np.array([ramsey(float(phi))[0] for phi in phis])
expected = np.sin(phis / 2) ** 2
err = float(np.abs(fringe - expected).max())
print("phi/pi  P(g)")
for phi, p in zip(phis, fringe):
    print(f"  {phi / np.pi:4.2f}  {p:.4f}")
print(f"max |P - sin^2(phi/2)|: {err:.2e}")
assert err < 1e-3, err

# The running phase reference is queryable per qubit and basis.
reg = pt.Register.from_coordinates([(0.0, 0.0)], prefix="q")
seq = pt.Sequence(reg, pt.MockDevice)
seq.declare_channel("digital", "raman_local", initial_target="q0")
seq.phase_shift(1.0, "q0", basis="digital")
seq.phase_shift(2.5, "q0", basis="digital")
acc = float(seq.current_phase_ref("q0", basis="digital"))
print(f"accumulated phase ref: {acc:.4f}")
assert abs(acc - 3.5) < 1e-12, acc
print("OK phase-shift walkthrough complete")
