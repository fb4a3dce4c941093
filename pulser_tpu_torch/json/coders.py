"""The custom Encoder and Decoder for legacy JSON serialization.

Port of ``pulser_tpu/json/coders.py`` (behavioral parity with reference
``pulser-core/pulser/json/coders.py:30-132``, ``PulserEncoder`` /
``PulserDecoder``). Payloads written by the reference (module paths
under ``pulser.*``) or by the JAX package (``pulser_tpu.*``) are decoded
into this package's classes by remapping the module root.
"""

from __future__ import annotations

import importlib
import inspect
from json import JSONDecoder, JSONEncoder
from typing import Any, cast

import numpy as np

from pulser_tpu_torch.json.supported import (
    LEGACY_ROOTS,
    validate_serialization,
)
from pulser_tpu_torch.json.utils import obj_to_dict
from pulser_tpu_torch.parametrized import Variable


class PulserEncoder(JSONEncoder):
    """The custom encoder for pulser objects."""

    def default(self, o: Any) -> dict[str, Any] | int:
        """Handles JSON encoding of objects not supported by default."""
        if hasattr(o, "_to_dict"):
            # Framework objects know their own record form
            return cast(dict, o._to_dict())
        if type(o) is type:
            return obj_to_dict(o, _build=False, _name=o.__name__)
        if isinstance(o, np.ndarray):
            return obj_to_dict(o, o.tolist(), _name="array")
        if isinstance(o, np.integer):
            return int(o)
        if isinstance(o, set):
            return obj_to_dict(o, list(o))
        return cast(dict, JSONEncoder.default(self, o))


def _local_module_path(module_str: str) -> str:
    """The module of this package a serialized module path names.

    A payload names its modules under ``pulser``, ``pulser_tpu`` or
    ``pulser_tpu_torch``; each resolves to the same module of this
    package, so decoding never imports another package's modules. Any
    other path (``numpy``, ``builtins``, ``operator``) is kept.
    """
    root, dot, rest = module_str.partition(".")
    if root in LEGACY_ROOTS:
        return "pulser_tpu_torch" + dot + rest
    return module_str


class PulserDecoder(JSONDecoder):
    """The custom decoder for pulser objects."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        """Initializes the decoder."""
        self.vars: dict[str, Variable] = {}
        super().__init__(object_hook=self.object_hook, *args, **kwargs)

    def object_hook(self, obj: dict[str, Any]) -> Any:
        """Enforces custom deserializations when decoding."""
        try:
            build = obj["_build"]
            obj_name = obj["__name__"]
            module_str = obj["__module__"]
        except KeyError:
            return obj

        validate_serialization(obj)
        module_str = _local_module_path(module_str)

        if (
            obj_name == "Variable"
            and module_str == "pulser_tpu_torch.parametrized.variable"
        ):
            var_name = obj["name"]
            if var_name in self.vars:
                var = self.vars[var_name]
                assert var.name == var_name, (
                    f"Variable {var.name} already "
                    f"declared under {var_name}."
                )
                assert var.dtype == obj["dtype"], (
                    "Mismatching variable types for variables under"
                    f" the name '{var_name}'."
                )
                assert var.size == obj["size"], (
                    "Mismatching sizes for variables under the name "
                    f"'{var_name}'."
                )
            else:
                var = Variable(var_name, obj["dtype"], obj["size"])
                self.vars[var_name] = var
            return var

        module = importlib.import_module(module_str)
        if "__submodule__" in obj:
            submodule = getattr(module, obj["__submodule__"])
            cls = getattr(submodule, obj_name)
            if inspect.ismethod(cls):
                cls = cls.__func__  # Use the unbound function
        else:
            cls = getattr(module, obj_name)

        if not build:
            return cls

        if "Device" in obj_name:
            _upgrade_device_kwargs(obj["__kwargs__"])
        if "Sequence" in obj_name:
            return _rebuild_sequence(cls, obj)
        return cls(*obj["__args__"], **obj["__kwargs__"])


def _upgrade_device_kwargs(kwargs: dict[str, Any]) -> None:
    """Converts a legacy '_channels' payload to the modern pair form."""
    _channels = kwargs.pop("_channels", None)
    already_modern = kwargs.get("channel_objects") or kwargs.get(
        "channel_ids"
    )
    if _channels and not already_modern:
        as_dict = dict(_channels)
        kwargs["channel_ids"] = tuple(as_dict.keys())
        kwargs["channel_objects"] = tuple(as_dict.values())


def _rebuild_sequence(cls: Any, obj: dict[str, Any]) -> Any:
    """Reconstructs a Sequence record: replay calls, restore vars."""
    seq = cls(*obj["__args__"], **obj["__kwargs__"])
    for name, args, kwargs in obj["calls"]:
        getattr(seq, name)(*args, **kwargs)
    seq._building = obj["vars"] == {}
    for name, var in obj["vars"].items():
        assert (
            name not in seq._variables
        ), f"Multiples variables with the name '{name}'."
        seq._variables[name] = var
    for name, args, kwargs in obj["to_build_calls"]:
        getattr(seq, name)(*args, **kwargs)
    return seq
