"""``Register3D`` and three-dimensional layouts against pulser_tpu.

After the ``TestRegister3D`` cases of ``tests/test_register.py``: each
scenario is a function of a package namespace run through both packages
by ``tests/torch_parity.py::assert_parity`` (same errors, same
warnings); coordinates agree within 1e-12, ids, ``static_hash`` and
``str`` exactly. The devices' checks of a 3-D register (``MockDevice``
has three dimensions, ``DigitalAnalogDevice`` two) and a 3-D register's
sequence and interaction matrix are held alike too.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_layouts import COORD_TOL, layout_facts, reg_facts
from torch_parity import assert_parity

torch.set_num_threads(1)

#: Four traps off any plane, and a fifth on the first three's plane.
TRAPS_3D = [
    [0.0, 0.0, 0.0],
    [6.0, 0.0, 0.0],
    [0.0, 6.0, 1.0],
    [3.0, 2.0, 7.0],
    [6.0, 6.0, 1.0],
]


def constructors(ns):
    R3 = ns.pkg.Register3D
    return [
        reg_facts(R3.cubic(2, spacing=1.0, prefix="q")),
        reg_facts(R3.cubic(3, prefix="c")),
        reg_facts(R3.cuboid(1, 2, 1, spacing=1.0, prefix="q")),
        reg_facts(R3.cuboid(2, 3, 4, spacing=5.0, prefix="q")),
        reg_facts(
            R3({"a": (0.0, 0.0, 0.0), "b": (1.0, 2.0, 3.0), "c": (-4, 5, 6)})
        ),
        reg_facts(
            R3.from_coordinates(np.array(TRAPS_3D), center=True, prefix="t")
        ),
    ]


def to_2d(ns):
    """A plane tilted out of xy projects down; a spread within the
    tolerance is accepted."""
    R3 = ns.pkg.Register3D
    flat = R3(
        {
            "q0": (0.0, 0.0, 0.0),
            "q1": (4.0, 0.0, 2.0),
            "q2": (0.0, 5.0, 0.0),
            "q3": (4.0, 5.0, 2.0),
        }
    )
    wobbly = R3(
        {
            "q0": (0.0, 0.0, 0.0),
            "q1": (4.0, 0.0, 0.05),
            "q2": (0.0, 5.0, 0.0),
            "q3": (4.0, 5.0, -0.05),
        }
    )
    return [reg_facts(flat.to_2D()), reg_facts(wobbly.to_2D(tol_width=0.2))]


def layout_3d(ns):
    """A 3-D layout defines a ``Register3D``, which carries it."""
    layout = ns.pkg.register.RegisterLayout(TRAPS_3D, slug="tetra")
    reg = layout.define_register(0, 2, 3, qubit_ids=["a", "b", "c"])
    return [
        layout_facts(layout),
        layout.dimensionality,
        reg_facts(reg),
        reg_facts(layout.define_register(1, 4)),
        layout.get_traps_from_coordinates(*np.array(TRAPS_3D)[[3, 1]]),
    ]


def mock_device_takes_3d(ns):
    """``MockDevice`` (three dimensions) validates a 3-D register and
    builds and samples a sequence on it."""
    P = ns.pkg
    reg = P.Register3D.cuboid(2, 2, 2, spacing=6.0, prefix="q")
    P.MockDevice.validate_register(reg)
    seq = P.Sequence(reg, P.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(P.Pulse.ConstantPulse(100, 1.0, -0.5, 0.0), "ryd")
    ch = ns.sample(seq).channel_samples["ryd"]
    return [str(seq), np.asarray(ch.amp), np.asarray(ch.det)]


def interaction_matrix_3d(ns):
    """The Ising interaction matrix of a 3-D register (the pairwise
    distances, z included), as the emulator builds it."""
    P = ns.pkg
    from importlib import import_module

    hd = import_module(f"{P.__name__}.hamiltonian_data.hamiltonian_data")
    reg = P.Register3D.from_coordinates(
        np.array(TRAPS_3D) * 1.5, center=False, prefix="q"
    )
    seq = P.Sequence(reg, P.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(P.Pulse.ConstantPulse(100, 1.0, 0.0, 0.0), "ryd")
    data = hd.HamiltonianData(
        ns.sample(seq), reg, P.MockDevice, P.NoiseModel()
    )
    return [
        np.asarray(data.noiseless_interaction_matrix),
        np.asarray(hd._distances(reg).as_array()),
    ]


@pytest.mark.parametrize(
    "call",
    [
        lambda P: P.Register3D({"a": (0, 0)}),
        lambda P: P.Register3D({"a": (0, 0, 0), "b": (1, 1)}),
        lambda P: P.Register3D.cuboid(0, 2, 2, prefix="q"),
        lambda P: P.Register3D.cuboid(2, 0, 2, prefix="q"),
        lambda P: P.Register3D.cuboid(2, 2, 0, prefix="q"),
        lambda P: P.Register3D.cuboid(2, 2, 2, 0.0, prefix="q"),
        lambda P: P.Register3D.cubic(0),
        lambda P: P.Register3D.cubic(2, spacing=-3.0),
        lambda P: P.Register3D.cubic(2, spacing=1.0, prefix="q").to_2D(),
        lambda P: P.DigitalAnalogDevice.validate_register(
            P.Register3D.cubic(2, spacing=6.0, prefix="q")
        ),
        lambda P: P.Sequence(
            P.Register3D.cubic(2, spacing=6.0, prefix="q"), P.AnalogDevice
        ),
    ],
    ids=[
        "2d_coords", "mixed_coords", "rows", "columns", "layers",
        "spacing", "side", "negative_spacing", "not_coplanar",
        "2d_device", "2d_device_sequence",
    ],
)
def test_invalid_3d_registers_raise_alike(call):
    assert assert_parity(lambda ns: call(ns.pkg))[0] == "raise"


SCENARIOS = {
    "constructors": constructors,
    "to_2d": to_2d,
    "layout_3d": layout_3d,
    "mock_device_takes_3d": mock_device_takes_3d,
    "interaction_matrix_3d": interaction_matrix_3d,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_register3d_scenario_matches_pulser_tpu(name):
    assert_parity(SCENARIOS[name], tol=COORD_TOL)


def test_register3d_is_exported_like_pulser_tpu():
    import pulser_tpu

    import pulser_tpu_torch

    assert "Register3D" in pulser_tpu_torch.__all__
    assert (
        pulser_tpu_torch.Register3D is pulser_tpu_torch.register.Register3D
    )
    assert set(pulser_tpu.register.__all__) == set(
        pulser_tpu_torch.register.__all__
    )
