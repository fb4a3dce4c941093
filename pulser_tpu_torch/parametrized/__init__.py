"""Classes for parametrization of sequences."""

from pulser_tpu_torch.parametrized.paramabc import Parametrized
from pulser_tpu_torch.parametrized.paramobj import ParamObj
from pulser_tpu_torch.parametrized.variable import Variable, VariableItem

__all__ = ["Parametrized", "ParamObj", "Variable", "VariableItem"]
