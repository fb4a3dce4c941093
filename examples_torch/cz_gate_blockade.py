"""A Control-Z gate from the Rydberg blockade (pi / 2pi / pi protocol).

PyTorch rendition of the reference's "Control-Z Gate Sequence"
tutorial (reference: tutorials/quantum_computing/Control-Z Gate
Sequence.ipynb): qubits live in the hyperfine pair |g>, |h>; the
rydberg channel couples |g> <-> |r| only, so driving

    pi(control) . 2pi(target) . pi(control)

picks up a minus sign on every input EXCEPT when the blockade
intervenes: with both qubits in |g>, the excited control shifts the
target's |r> out of resonance, the target's 2pi cycle is blocked (no
-1), and the net conditional phase pattern becomes diag(-1,-1,-1,+1)
on (gg, gh, hg, hh) - a CZ up to single-qubit Z rotations. Moving the
atoms far apart switches the blockade off and the gg phase flips back
to +1, which is the whole gate.

Run:  python examples_torch/cz_gate_blockade.py [--device cpu]
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

PI_PULSE = pt.Pulse.ConstantDetuning(
    pt.BlackmanWaveform(200, np.pi), 0.0, 0.0
)
TWO_PI_PULSE = pt.Pulse.ConstantDetuning(
    pt.BlackmanWaveform(200, 2 * np.pi), 0.0, 0.0
)


def cz_phase(inp: str, spacing: float) -> complex:
    """Amplitude <inp|U|inp> for inp in {'gg','gh','hg','hh'}."""
    reg = pt.Register.from_coordinates(
        [(0.0, 0.0), (spacing, 0.0)], prefix="q"
    )
    seq = pt.Sequence(reg, pt.MockDevice)
    seq.declare_channel("digital", "raman_local", initial_target="q0")
    seq.declare_channel("ryd", "rydberg_local", initial_target="q0")

    # State prep: raman pi pulses flip the requested qubits g -> h.
    for qubit, state in zip(("q0", "q1"), inp):
        if state == "h":
            seq.target(qubit, "digital")
            seq.add(PI_PULSE, "digital")

    # The gate: pi on the control, 2pi on the target, pi back.
    seq.target("q0", "ryd")
    seq.add(PI_PULSE, "ryd")
    seq.target("q1", "ryd")
    seq.add(TWO_PI_PULSE, "ryd")
    seq.target("q0", "ryd")
    seq.add(PI_PULSE, "ryd")

    state = np.asarray(
        TorchEmulator.from_sequence(seq, torch_device=DEVICE)
        .run()
        .get_final_state(ignore_global_phase=False)
        .full()
    )[:, 0]
    # The emulator picks the smallest basis holding the used channels:
    # pure-gg runs never touch the raman channel, so they evolve in
    # the 2-level ground-rydberg basis (r, g) = (0, 1); any |h> prep
    # promotes to the 3-level 'all' basis (r, g, h) = (0, 1, 2).
    d = round(len(state) ** 0.5)
    digit = {"g": 1, "h": 2}
    idx = d * digit[inp[0]] + digit[inp[1]]
    # The input state must map back onto itself (no leakage).
    assert abs(state[idx]) > 0.98, (inp, abs(state[idx]))
    # Each raman pi prep pulse contributes a -i (e^{-i pi sigma_x/2}
    # sends |g> to -i|h>); divide it out so what remains is the
    # conditional phase of the rydberg protocol alone.
    return complex(state[idx]) / (-1j) ** inp.count("h")


BLOCKADED = 4.0  # um: V ~ 1323 rad/us >> peak Omega -> blockade on
FREE = 40.0  # um: V ~ 1e-3 rad/us -> blockade off

print("input | phase (blockaded) | phase (free atoms)")
signs = {}
for inp in ("gg", "gh", "hg", "hh"):
    a_blk = cz_phase(inp, BLOCKADED)
    a_far = cz_phase(inp, FREE)
    signs[inp] = (np.sign(a_blk.real), np.sign(a_far.real))
    print(
        f"  {inp}  |      {a_blk.real:+.3f}       |     {a_far.real:+.3f}"
    )

# Without blockade every drive is independent: gg sees two full 2pi
# cycles -> (+1); with blockade the target's cycle is frozen -> (-1).
assert signs["hh"] == (1, 1)
assert signs["gh"] == (-1, -1)
assert signs["hg"] == (-1, -1)
assert signs["gg"] == (-1, 1), signs["gg"]
print("conditional phase pattern diag(-1,-1,-1,+1): CZ gate OK")
