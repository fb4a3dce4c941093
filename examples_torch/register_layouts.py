"""Register layouts and mappable registers.

PyTorch rendition of the reference's "Register Layouts &
Mappable Registers" tutorial (reference: tutorials/advanced_features/
Register Layouts.ipynb): real QPUs trap atoms on a pre-calibrated grid
of optical tweezers, so registers are *carved out of a layout* — either
eagerly (``define_register``) or lazily, with a ``MappableRegister``
that is only pinned to trap indices when the sequence is built.

Run:  python examples_torch/register_layouts.py [--device cpu]
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
from pulser_tpu_torch.register import (
    MappableRegister,
    RegisterLayout,
    SquareLatticeLayout,
    TriangularLatticeLayout,
)
from pulser_tpu_torch.ops.solver import resolve_device

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument(
    "--device",
    default=None,
    help="torch device to run on (default: the CUDA card; 'cpu' to run"
    " without one)",
)
# Nothing below runs on a device; the flag is resolved all the same,
# as in every example, so that a run without a card and without
# --device cpu stops here as the emulating examples do
DEVICE = resolve_device(parser.parse_args().device)

# --- an arbitrary layout: any set of trap coordinates ---------------
coords = [(0.0, 0.0), (5.0, 0.0), (0.0, 5.0), (5.0, 5.0), (10.0, 10.0)]
layout = RegisterLayout(coords)
print(f"layout traps: {layout.number_of_traps}")
assert layout.number_of_traps == 5

# Carve a register by trap index; qubit ids follow the given order.
reg = layout.define_register(0, 3, qubit_ids=["ctrl", "tgt"])
np.testing.assert_allclose(
    np.asarray(reg.qubits["tgt"].as_array()), [5.0, 5.0]
)
print(f"carved register: {list(reg.qubit_ids)}")

# The register remembers its provenance — devices that require
# calibrated layouts check this trap link at sequence-build time.
assert reg.layout is layout
assert reg._layout_info is not None

# --- special layouts: square and triangular lattices ----------------
square = SquareLatticeLayout(4, 4, spacing=5.0)
sub = square.square_register(2)
assert len(sub.qubit_ids) == 4
print(f"{square} -> central 2x2 register")

tri = TriangularLatticeLayout(30, spacing=6.0)
hexa = tri.hexagonal_register(7)
assert len(hexa.qubit_ids) == 7
print(f"{tri} -> 7-atom hexagonal register")

# --- mappable registers: decide the trap mapping at build time ------
mappable = MappableRegister(square, "q0", "q1", "q2")
seq = pt.Sequence(mappable, pt.MockDevice)
assert seq.is_register_mappable()
seq.declare_channel("ryd", "rydberg_global")
seq.add(
    pt.Pulse.ConstantPulse(400, 2 * np.pi, 0.0, 0.0), "ryd"
)

# One template, two different trap assignments:
reg_a = seq.build(qubits={"q0": 0, "q1": 1, "q2": 2}).register
reg_b = seq.build(qubits={"q0": 5, "q1": 10, "q2": 15}).register
a0 = np.asarray(reg_a.qubits["q0"].as_array())
b0 = np.asarray(reg_b.qubits["q0"].as_array())
assert not np.allclose(a0, b0)
print(f"q0 sits at {a0} in build A, {b0} in build B")

# The layout itself serializes (it is part of the QPU calibration).
wire = layout.to_abstract_repr()
back = RegisterLayout.from_abstract_repr(wire)
assert back == layout
print("layout abstract-repr round trip: OK")
print("OK register-layout walkthrough complete")
