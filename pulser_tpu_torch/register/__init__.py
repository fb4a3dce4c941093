"""The register: qubit ids and their positions."""

from pulser_tpu_torch.register.base_register import BaseRegister, QubitId
from pulser_tpu_torch.register.mappable_reg import MappableRegister
from pulser_tpu_torch.register.register import Register
from pulser_tpu_torch.register.register_layout import RegisterLayout
from pulser_tpu_torch.register.weight_maps import DetuningMap, WeightMap

__all__ = [
    "BaseRegister",
    "QubitId",
    "MappableRegister",
    "Register",
    "RegisterLayout",
    "DetuningMap",
    "WeightMap",
]
