"""SLM mask and detuning-map modulation (DMM) walkthrough.

The PyTorch rendition of the reference's "SLM mask" and "DMM"
tutorials (BASELINE config #4 — SLM + DMM + digital local raman):

1. A ``DetuningMap`` assigns per-trap weights; a DMM channel plays a
   (negative) detuning waveform scaled by each qubit's weight.
2. An SLM mask shields chosen qubits from the first global pulse —
   in Ising mode it lowers them by a large DMM detuning instead of
   physically removing them.
3. A local raman (digital basis) pulse addresses a single qubit.

Run:  python examples_torch/slm_mask_dmm.py [--device cpu]
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
from pulser_tpu_torch.sampler import sample
from pulser_tpu_torch.ops.solver import resolve_device

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument(
    "--device",
    default=None,
    help="torch device to run on (default: the CUDA card; 'cpu' to run"
    " without one)",
)
DEVICE = resolve_device(parser.parse_args().device)

# --- register + detuning map ---------------------------------------
reg = pt.Register.square(2, spacing=8.0, prefix="q")
qubit_ids = list(reg.qubit_ids)

# Weight the detuning: q0 gets the full effect, q1 half, rest none.
weights = {"q0": 1.0, "q1": 0.5, "q2": 0.0, "q3": 0.0}
detuning_map = reg.define_detuning_map(weights)

seq = pt.Sequence(reg, pt.MockDevice)
seq.declare_channel("ryd", "rydberg_global")
seq.declare_channel("raman", "raman_local", initial_target="q0")
seq.config_detuning_map(detuning_map, "dmm_0")

# --- SLM mask: shield q2/q3 from the first global pulse ------------
seq.config_slm_mask(["q2", "q3"])

# The masked (first) global pulse: only q0/q1 respond.
seq.add(pt.Pulse.ConstantPulse(400, 2 * np.pi, 0.0, 0.0), "ryd")

# DMM detuning: -4 rad/us, weighted per qubit by the detuning map.
seq.add_dmm_detuning(pt.ConstantWaveform(400, -4.0), "dmm_0")

# Local digital pulse on q0 (raman channel, 'digital' basis).
seq.add(
    pt.Pulse.ConstantDetuning(
        pt.BlackmanWaveform(500, np.pi), 0.0, 0.0
    ),
    "raman",
)

print(f"sequence duration: {seq.get_duration()} ns")
print(f"declared channels: {sorted(seq.declared_channels)}")

# --- inspect the lowered samples -----------------------------------
samples = sample(seq)
nested = samples.to_nested_dict()
slm_window = samples._slm_mask.end
print(f"SLM mask window: 0-{slm_window} ns over {samples._slm_mask.targets}")

# During the mask window the masked qubits carry the -10*amp detuning
masked_det = np.asarray(
    nested["Local"]["ground-rydberg"]["q2"]["det"]
)[:slm_window]
assert masked_det.min() < -10, "SLM mask detuning not applied"

# The DMM detuning lands weighted: q0 full, q1 half. It plays in
# parallel with the global pulse ("no-delay" for DMMs), and the
# global pulse itself carries zero detuning, so the whole detuning
# series on q0/q1 is the weighted DMM waveform.
det_q0 = np.asarray(nested["Local"]["ground-rydberg"]["q0"]["det"])
det_q1 = np.asarray(nested["Local"]["ground-rydberg"]["q1"]["det"])
assert det_q0.sum() < 0, "DMM detuning missing on q0"
ratio = det_q1.sum() / det_q0.sum()
print(f"q1/q0 DMM detuning ratio: {ratio:.3f} (weights 0.5/1.0)")
assert abs(ratio - 0.5) < 1e-9

# --- emulate -------------------------------------------------------
sim = TorchEmulator.from_sequence(seq, torch_device=DEVICE)
res = sim.run()
final = res.get_final_state()
counts = res.sample_final_state(1000)
top = counts.most_common(3)
print(f"top outcomes: {top}")
norm = float(np.linalg.norm(np.asarray(final.full())))
print(f"final-state norm: {norm:.6f}")
assert abs(norm - 1) < 1e-5
print("OK slm+dmm walkthrough complete")
