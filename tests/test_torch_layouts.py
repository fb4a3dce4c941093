"""The lattice layouts and the Register constructors against pulser_tpu.

After ``tests/test_register_layout.py``, ``test_register.py`` and
``test_register_matrix.py``: each scenario is a function of a package
namespace, run through ``pulser_tpu`` and ``pulser_tpu_torch`` by
``tests/torch_parity.py::assert_parity`` (same numpy seed, the same
warnings, the same errors). Registers and layouts are compared by class,
qubit ids, coordinates (within 1e-12), the layout's ``static_hash`` and
``str``; the calibrated layouts of ``AnalogDevice`` by their keys.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from torch_parity import assert_parity

torch.set_num_threads(1)

#: Coordinates agree to this (they are computed in float64 numpy in both).
COORD_TOL = 1e-12


def reg_facts(reg) -> list:
    """What identifies a register: class, ids, coordinates, layout."""
    layout = reg.layout
    return [
        type(reg).__name__,
        [str(q) for q in reg.qubit_ids],
        np.stack([np.asarray(p, dtype=float) for p in reg.qubits.values()]),
        None if layout is None else layout_facts(layout),
    ]


def layout_facts(layout) -> list:
    return [
        type(layout).__name__,
        str(layout),
        layout.static_hash(),
        layout.number_of_traps,
        np.asarray(layout.coords),
    ]


def square_lattice_layout(ns):
    L = ns.pkg.register.SquareLatticeLayout(9, 7, 5)
    return [
        layout_facts(L),
        reg_facts(L.square_register(3)),
        reg_facts(L.square_register(4)),
        reg_facts(L.rectangular_register(3, 7, prefix="r")),
        L.square_register(3)
        == ns.pkg.Register.square(3, spacing=5, prefix="q"),
    ]


def rectangular_lattice_layout(ns):
    L = ns.pkg.register.RectangularLatticeLayout(9, 7, 2, 4)
    return [
        layout_facts(L),
        reg_facts(L.square_register(3)),
        reg_facts(L.rectangular_register(2, 5)),
    ]


def triangular_lattice_layout(ns):
    L = ns.pkg.register.TriangularLatticeLayout(50, 5)
    return [
        layout_facts(L),
        reg_facts(L.hexagonal_register(19)),
        reg_facts(L.hexagonal_register(11)),
        reg_facts(L.rectangular_register(3, 4)),
        L.hexagonal_register(19)
        == ns.pkg.Register.hexagon(2, spacing=5, prefix="q"),
    ]


def analog_calibrated_layout(ns):
    """TRI16's register: AnalogDevice's calibrated layout, and the
    device's calibration queries."""
    P = ns.pkg
    dev = P.AnalogDevice
    (layout,) = dev.pre_calibrated_layouts
    reg = layout.hexagonal_register(16)
    other = P.register.TriangularLatticeLayout(61, 4)
    return [
        layout_facts(layout),
        reg_facts(reg),
        sorted(dev.calibrated_register_layouts),
        dev.is_calibrated_layout(layout),
        dev.is_calibrated_layout(other),
        dev.register_is_from_calibrated_layout(reg),
        dev.register_is_from_calibrated_layout(
            other.hexagonal_register(7)
        ),
        dev.register_is_from_calibrated_layout(
            P.Register.square(2, prefix="q")
        ),
        dev.register_is_from_calibrated_layout(
            layout.make_mappable_register(5)
        ),
    ]


def calibrated_layout_refused(ns):
    """A device whose calibrated layout breaks its own constraints."""
    P = ns.pkg
    return dataclasses.replace(
        P.AnalogDevice,
        pre_calibrated_layouts=(P.register.TriangularLatticeLayout(61, 1),),
    )


def calibration_query_type_error(ns):
    return ns.pkg.AnalogDevice.register_is_from_calibrated_layout("q0")


def triangular_lattice(ns):
    R = ns.pkg.Register
    return [
        reg_facts(R.triangular_lattice(3, 4, spacing=5.0, prefix="q")),
        reg_facts(R.triangular_lattice(1, 5, prefix="a")),
        reg_facts(R.triangular_lattice(4, 1, spacing=6.5, prefix="q")),
    ]


def hexagon(ns):
    R = ns.pkg.Register
    return [
        reg_facts(R.hexagon(1, spacing=1.0, prefix="q")),
        reg_facts(R.hexagon(2, spacing=5.0, prefix="q")),
        reg_facts(R.hexagon(3, prefix="h")),
    ]


def max_connectivity(ns):
    P = ns.pkg
    return [
        reg_facts(P.Register.max_connectivity(n, dev, prefix="q"))
        for n in (1, 4, 7, 9, 12, 19, 25)
        for dev in (P.DigitalAnalogDevice, P.AnalogDevice)
    ] + [
        reg_facts(
            P.Register.max_connectivity(
                10, P.DigitalAnalogDevice, spacing=5.0, prefix="q"
            )
        )
    ]


@pytest.mark.parametrize(
    "call",
    [
        lambda P: P.Register.triangular_lattice(0, 2),
        lambda P: P.Register.triangular_lattice(2, 0),
        lambda P: P.Register.triangular_lattice(2, 2, 0.0),
        lambda P: P.Register.hexagon(0),
        lambda P: P.Register.hexagon(1, spacing=-1.0),
        lambda P: P.Register.max_connectivity(2, None),
        lambda P: P.Register.max_connectivity(0, P.DigitalAnalogDevice),
        lambda P: P.Register.max_connectivity(1000, P.DigitalAnalogDevice),
        lambda P: P.Register.max_connectivity(
            4, P.DigitalAnalogDevice, spacing=1.0
        ),
        lambda P: P.Register.max_connectivity(10, P.MockDevice),
        lambda P: P.register.TriangularLatticeLayout(50, 5)
        .hexagonal_register(51),
        lambda P: P.register.TriangularLatticeLayout(50, 5)
        .rectangular_register(7, 8),
        lambda P: P.register.TriangularLatticeLayout(50, 5)
        .rectangular_register(8, 3),
        lambda P: P.register.SquareLatticeLayout(9, 7, 5).square_register(8),
        lambda P: P.register.RectangularLatticeLayout(9, 7, 2, 4)
        .rectangular_register(10, 3),
    ],
    ids=[
        "tri_rows", "tri_columns", "tri_spacing", "hex_layers",
        "hex_spacing", "maxconn_device", "maxconn_zero", "maxconn_many",
        "maxconn_spacing", "maxconn_mock", "trilayout_too_many",
        "trilayout_rect_too_many", "trilayout_rect_off_lattice",
        "square_does_not_fit", "rect_does_not_fit",
    ],
)
def test_invalid_constructions_raise_alike(call):
    assert assert_parity(lambda ns: call(ns.pkg))[0] == "raise"


def rotated(ns):
    R = ns.pkg.Register
    plain = R.square(2, spacing=4.0, prefix="q")
    layout = ns.pkg.register.TriangularLatticeLayout(20, 5)
    on_layout = layout.hexagonal_register(7)
    return [
        reg_facts(plain.rotated(45)),
        reg_facts(plain.rotated(-120.5)),
        reg_facts(on_layout.rotated(30)),  # warns: the layout is dropped
    ]


def automatic_layout(optimal_filling):
    def case(ns):
        P = ns.pkg
        reg = P.Register.triangular_lattice(4, 5, spacing=5, prefix="q")
        device = dataclasses.replace(
            P.AnalogDevice,
            max_atom_num=44,
            max_layout_filling=0.5,
            optimal_layout_filling=optimal_filling,
            pre_calibrated_layouts=(),
        )
        device.validate_register(reg)
        new = reg.with_automatic_layout(device, layout_slug="foo")
        capped = dataclasses.replace(
            device,
            max_layout_traps=new.layout.number_of_traps - 1,
            max_layout_filling=0.9,
        )
        return [
            reg_facts(new),
            new == reg,
            reg_facts(reg.with_automatic_layout(capped)),
        ]

    return case


def automatic_layout_errors(which):
    def case(ns):
        P = ns.pkg
        reg = P.Register.triangular_lattice(4, 5, spacing=5, prefix="q")
        device = dataclasses.replace(
            P.AnalogDevice,
            max_atom_num=52,
            max_layout_filling=0.5,
            pre_calibrated_layouts=(),
        )
        if which == "virtual":
            return reg.with_automatic_layout(P.MockDevice)
        if which == "min_traps":
            return reg.with_automatic_layout(
                dataclasses.replace(device, min_layout_traps=200)
            )
        raise AssertionError(which)

    return case


def empty_traps(ns):
    layout = ns.pkg.register.TriangularLatticeLayout(19, 5)
    reg = layout.hexagonal_register(7)
    return reg_facts(reg._get_empty_traps_reg())


def empty_traps_without_layout(ns):
    return ns.pkg.Register.square(2, prefix="q")._get_empty_traps_reg()


SCENARIOS = {
    "square_lattice_layout": square_lattice_layout,
    "rectangular_lattice_layout": rectangular_lattice_layout,
    "triangular_lattice_layout": triangular_lattice_layout,
    "analog_calibrated_layout": analog_calibrated_layout,
    "calibrated_layout_refused": calibrated_layout_refused,
    "calibration_query_type_error": calibration_query_type_error,
    "triangular_lattice": triangular_lattice,
    "hexagon": hexagon,
    "max_connectivity": max_connectivity,
    "rotated": rotated,
    "automatic_layout-none": automatic_layout(None),
    "automatic_layout-0.4": automatic_layout(0.4),
    "automatic_layout_virtual_device": automatic_layout_errors("virtual"),
    "automatic_layout_no_site": automatic_layout_errors("min_traps"),
    "empty_traps": empty_traps,
    "empty_traps_without_layout": empty_traps_without_layout,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_layout_scenario_matches_pulser_tpu(name):
    assert_parity(SCENARIOS[name], tol=COORD_TOL)


def test_calibrated_layouts_carry_across():
    """``interop.from_jax_device`` carries AnalogDevice's calibrated
    layout across as the port's own class, equal and of equal hash."""
    import pulser_tpu

    import pulser_tpu_torch
    from pulser_tpu_torch.interop import from_jax_device

    dev = from_jax_device(pulser_tpu.AnalogDevice)
    assert dev == pulser_tpu_torch.AnalogDevice
    (ours,) = dev.pre_calibrated_layouts
    (theirs,) = pulser_tpu.AnalogDevice.pre_calibrated_layouts
    assert type(ours) is pulser_tpu_torch.register.TriangularLatticeLayout
    assert ours.static_hash() == theirs.static_hash()
    assert str(ours) == str(theirs)


def test_automatic_layout_refuses_differentiable_coordinates():
    """A register whose coordinates require grad has no layout to
    generate, as under a JAX trace in pulser_tpu."""
    import pulser_tpu_torch as P

    coords = torch.tensor([[0.0, 0.0], [5.0, 0.0]], requires_grad=True)
    reg = P.Register.from_coordinates(coords, prefix="q")
    with pytest.raises(NotImplementedError, match="differentiable"):
        reg.with_automatic_layout(P.AnalogDevice)
