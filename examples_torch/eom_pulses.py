"""Fast square pulses through the EOM mode of AnalogDevice.

EOM (electro-optic modulator) mode trades waveform freedom for
nanosecond-scale switching: the channel plays only square pulses at a
fixed setpoint, idling at a discrete ``detuning_off`` level picked
from the EOM beam physics. This example enables EOM mode, plays a
spin-echo-like train with a setpoint change, corrects the accumulated
phase drift, serializes the sequence to the abstract representation
and emulates it.

Run:  python examples_torch/eom_pulses.py [--device cpu]
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

reg = pt.Register({"q0": (-3.0, 0.0), "q1": (3.0, 0.0)})
seq = pt.Sequence(reg, pt.AnalogDevice)
seq.declare_channel("ryd", "rydberg_global")

# --- EOM block: Rabi pulses with ns-scale rise times ---------------
amp_on = 2 * np.pi  # rad/µs
seq.enable_eom_mode(
    "ryd", amp_on=amp_on, detuning_on=0.0, optimal_detuning_off=-20.0
)
det_off = float(seq._schedule["ryd"].eom_blocks[-1].detuning_off)
print(
    "detuning_off chosen by the EOM physics:",
    f"{det_off:.3f} rad/µs",
)

seq.add_eom_pulse("ryd", duration=100, phase=0.0)
seq.delay(300, "ryd")  # idles at detuning_off
# Setpoint change: closes the block and reopens at the new amplitude
seq.modify_eom_setpoint("ryd", amp_on=amp_on / 2, detuning_on=0.0)
# The pi-phase echo pulse, folding in the idle-time phase drift
seq.add_eom_pulse(
    "ryd", duration=200, phase=np.pi, correct_phase_drift=True
)
seq.disable_eom_mode("ryd")
print(f"sequence duration: {seq.get_duration()} ns")

# --- Wire format round trip ----------------------------------------
s = seq.to_abstract_repr()
seq2 = pt.Sequence.from_abstract_repr(s)
assert seq2.get_duration() == seq.get_duration()
print(f"abstract repr: {len(s)} bytes, round trip OK")

# --- Emulate -------------------------------------------------------
res = TorchEmulator.from_sequence(seq2, torch_device=DEVICE).run()
np.random.seed(0)
print("final bitstrings:", dict(res.sample_final_state(500)))
