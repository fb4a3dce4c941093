"""Everything related to the register and layouts."""

from pulser_tpu_torch.register.base_register import BaseRegister, QubitId
from pulser_tpu_torch.register.register import Register
from pulser_tpu_torch.register.register3d import Register3D
from pulser_tpu_torch.register.register_layout import RegisterLayout
from pulser_tpu_torch.register.special_layouts import (
    RectangularLatticeLayout,
    SquareLatticeLayout,
    TriangularLatticeLayout,
)
from pulser_tpu_torch.register.mappable_reg import MappableRegister
from pulser_tpu_torch.register.weight_maps import DetuningMap, WeightMap

__all__ = [
    "BaseRegister",
    "QubitId",
    "Register",
    "Register3D",
    "RegisterLayout",
    "RectangularLatticeLayout",
    "SquareLatticeLayout",
    "TriangularLatticeLayout",
    "MappableRegister",
    "DetuningMap",
    "WeightMap",
]
