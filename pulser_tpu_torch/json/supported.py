"""Supported modules and objects for legacy JSON (de)serialization.

API parity with reference ``pulser-core/pulser/json/supported.py``
(same accepted modules/names), retargeted at the ``pulser_tpu_torch``
module tree. The registry is parsed from a compact spec — one line
per entry, ``module [module...]: name name ...`` with ``@group``
references — rather than literal tuples.
"""

from __future__ import annotations

from typing import Any, Mapping

from pulser_tpu_torch.exceptions.serialization import (
    SerializationSupportAttributeMissing,
    SerializationSupportClassMissing,
    SerializationSupportModuleMissing,
)

# Name groups referenced from the module spec below via "@group"
_GROUPS: dict[str, tuple[str, ...]] = {
    "operators": (
        "neg",
        "abs",
        "getitem",
        "add",
        "sub",
        "mul",
        "truediv",
        "pow",
        "mod",
    ),
    "numpy": (
        "array",
        "round",
        "round_",
        "ceil",
        "floor",
        "sqrt",
        "exp",
        "log2",
        "log",
        "sin",
        "cos",
        "tan",
    ),
    "devices": (
        "DigitalAnalogDevice",
        "AnalogDevice",
        "WeightedAnalogDevice",
        "MockDevice",
        "Chadoq2",
        "IroiseMVP",
        "VirtualDevice",
    ),
    "waveforms": (
        "CompositeWaveform",
        "CustomWaveform",
        "ConstantWaveform",
        "RampWaveform",
        "BlackmanWaveform",
        "InterpolatedWaveform",
        "KaiserWaveform",
    ),
}

# module [module ...]: accepted names (or @group references)
_MODULES_SPEC = """
builtins: float int str set
_operator operator: @operators
numpy pulser_tpu_torch.math: @numpy
pulser_tpu_torch.math.abstract_array: AbstractArray
pulser_tpu_torch.register.register: Register
pulser_tpu_torch.register.register3d: Register3D
pulser_tpu_torch.register.register_layout: RegisterLayout
pulser_tpu_torch.register.special_layouts: RectangularLatticeLayout SquareLatticeLayout TriangularLatticeLayout
pulser_tpu_torch.register.mappable_reg: MappableRegister
pulser_tpu_torch.register.weight_maps: DetuningMap
pulser_tpu_torch.devices: @devices
pulser_tpu_torch.channels: Rydberg Raman Microwave DMM
pulser_tpu_torch.channels.eom: BaseEOM RydbergEOM RydbergBeam
pulser_tpu_torch.pulse: Pulse
pulser_tpu_torch.waveforms: @waveforms
pulser_tpu_torch.sequence.sequence: Sequence
pulser_tpu_torch.sequence: Sequence
pulser_tpu_torch.parametrized.variable: Variable
pulser_tpu_torch.parametrized.paramobj: ParamObj
"""

#: Package roots that name this package's modules in a legacy payload:
#: the reference's and the JAX package's.
LEGACY_ROOTS = ("pulser", "pulser_tpu")

# Classmethod constructors reachable via "__submodule__"
SUPPORTS_SUBMODULE = (
    "Pulse",
    "BlackmanWaveform",
    "KaiserWaveform",
    "Register",
    "Register3D",
)


def _expand(names: list[str]) -> tuple[str, ...]:
    out: list[str] = []
    for token in names:
        if token.startswith("@"):
            out.extend(_GROUPS[token[1:]])
        else:
            out.append(token)
    return tuple(out)


def _build_registry() -> dict[str, tuple[str, ...]]:
    registry: dict[str, tuple[str, ...]] = {}
    for line in _MODULES_SPEC.strip().splitlines():
        modules, _, names = line.partition(":")
        accepted = _expand(names.split())
        for module in modules.split():
            registry[module] = accepted
            if module.startswith("pulser_tpu_torch."):
                # The module paths of the reference and of the JAX
                # package are accepted too, so their serialized payloads
                # load here unchanged (into this package's classes)
                for root in LEGACY_ROOTS:
                    registry[root + module[len("pulser_tpu_torch"):]] = (
                        accepted
                    )
    return registry


SUPPORTED_MODULES = _build_registry()


def validate_serialization(obj_dict: Mapping[str, Any]) -> None:
    """Checks if 'obj_dict' can be serialized."""
    try:
        obj_dict["_build"]
        obj_str = obj_dict["__name__"]
        module_str = obj_dict["__module__"]
    except KeyError:
        raise TypeError("Invalid 'obj_dict'.")

    if module_str not in SUPPORTED_MODULES:
        raise SerializationSupportModuleMissing(module=module_str)

    if "__submodule__" in obj_dict:
        submodule_str = obj_dict["__submodule__"]
        if submodule_str not in SUPPORTS_SUBMODULE:
            raise SerializationSupportAttributeMissing(
                module=module_str, submodule=submodule_str
            )
        # The accepted-name check below then applies to the class
        # holding the classmethod, not the method name itself
        obj_str = submodule_str

    if obj_str not in SUPPORTED_MODULES[module_str]:
        raise SerializationSupportClassMissing(
            module=module_str, class_name=obj_str
        )
