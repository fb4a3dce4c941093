"""Interpolated and composite waveforms: smooth pulse design.

PyTorch rendition of the reference's "Interpolated Waveforms" and
"Composite Waveforms" tutorials (reference:
tutorials/advanced_features/Interpolated Waveforms.ipynb): a handful of
control points become a smooth monotone (PCHIP) ramp, pieces are
chained with ``CompositeWaveform``, and the result drives an adiabatic
sweep on the emulator.

Run:  python examples_torch/interpolated_waveforms.py [--device cpu]
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

# --- an interpolated detuning ramp from 5 control points ------------
duration = 1000  # ns
values = [-12.0, -8.0, 0.0, 6.0, 10.0]  # rad/us
det_wf = pt.InterpolatedWaveform(duration, values)

# The PCHIP interpolant passes through every control point (up to the
# 1 ns sampling grid: anchors land between integer timestamps).
samples = det_wf.samples.as_array()
anchor_t = np.linspace(0, duration - 1, len(values)).astype(int)
anchor_err = float(np.abs(samples[anchor_t] - values).max())
print(f"control-point max error: {anchor_err:.2e}")
assert anchor_err < 0.05, anchor_err

# ...and, being monotone between increasing anchors, never overshoots.
assert samples.min() >= min(values) - 1e-9
assert samples.max() <= max(values) + 1e-9
print("monotone interpolation: no overshoot")

# Uneven `times` skew where the anchors sit (fractions of duration).
skewed = pt.InterpolatedWaveform(
    duration, values, times=[0.0, 0.1, 0.2, 0.5, 1.0]
)
s = skewed.samples.as_array()
assert abs(s[100] - values[1]) < 0.05  # anchor moved to t = 0.1 * T
print("custom times: anchor hit at t=100ns")

# --- composite: rise / interpolated sweep / fall --------------------
amp_max = 8.0  # rad/us
rise = pt.RampWaveform(200, 0.0, amp_max)
hold = pt.ConstantWaveform(duration, amp_max)
fall = pt.RampWaveform(200, amp_max, 0.0)
amp_wf = pt.CompositeWaveform(rise, hold, fall)
assert amp_wf.duration == 200 + duration + 200
print(f"composite duration: {amp_wf.duration} ns (sum of parts)")

full_det = pt.CompositeWaveform(
    pt.ConstantWaveform(200, values[0]),
    det_wf,
    pt.ConstantWaveform(200, values[-1]),
)

# --- drive a 2-atom adiabatic sweep with the composite pulse --------
reg = pt.Register.from_coordinates(
    [(0.0, 0.0), (7.0, 0.0)], prefix="q"
)
seq = pt.Sequence(reg, pt.MockDevice)
seq.declare_channel("ryd", "rydberg_global")
seq.add(pt.Pulse(amp_wf, full_det, 0.0), "ryd")
seq.measure("ground-rydberg")

res = TorchEmulator.from_sequence(seq, torch_device=DEVICE).run()
final = res.get_final_state()
probs = np.abs(np.asarray(final.full())[:, 0]) ** 2
# Blockaded pair swept to positive detuning: the symmetric one-excitation
# manifold dominates; double excitation stays suppressed.
p_rr = float(probs[0])  # r-first convention: |rr> is index 0
p_single = float(probs[1] + probs[2])
print(f"P(rr) = {p_rr:.4f}   P(one excited) = {p_single:.4f}")
assert p_rr < 0.1, p_rr
assert p_single > 0.5, p_single
print("OK interpolated-waveform walkthrough complete")
