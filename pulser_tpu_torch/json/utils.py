"""Shared helpers for the JSON serialization layers.

API parity with reference ``pulser-core/pulser/json/utils.py``.
"""

from __future__ import annotations

import json
import warnings
from dataclasses import MISSING, Field
from typing import TYPE_CHECKING, Any, Literal, Optional, Sequence

import numpy as np

from pulser_tpu_torch.exceptions.serialization import AbstractReprError

if TYPE_CHECKING:
    from pulser_tpu_torch.register.base_register import QubitId


def get_dataclass_defaults(fields: tuple[Field, ...]) -> dict[str, Any]:
    """Collects each dataclass field's default, where one exists."""
    out: dict[str, Any] = {}
    for field in fields:
        if field.default is not MISSING:
            out[field.name] = field.default
        elif field.default_factory is not MISSING:
            out[field.name] = field.default_factory()
    return out


def obj_to_dict(
    obj: object,
    *args: Any,
    _build: bool = True,
    _module: Optional[str] = None,
    _name: Optional[str] = None,
    _submodule: Optional[str] = None,
    **kwargs: Any,
) -> dict[str, Any]:
    """The legacy-JSON record for reconstructing an object.

    Args:
        obj: The object being recorded.

    Other Parameters:
        _build: False when the record is a bare reference that should
            not be instantiated on decode.
        _module: Overrides the recorded module path.
        _name: Overrides the recorded object name.
        _submodule: A class holding the recorded classmethod, when one
            applies.
        args: Constructor positional arguments, for buildable records.
        kwargs: Constructor keyword arguments, for buildable records.

    Returns:
        The dictionary encoding the object.
    """
    cls = obj.__class__
    record: dict[str, Any] = {
        "_build": _build,
        "__module__": _module or cls.__module__,
        "__name__": _name or cls.__name__,
    }
    if _build:
        record["__args__"] = args
        record["__kwargs__"] = kwargs
    if _submodule:
        record["__submodule__"] = _submodule

    from pulser_tpu_torch.json.supported import validate_serialization

    validate_serialization(record)
    return record


class _NumpyAwareEncoder(json.JSONEncoder):
    """Falls back to tolist() for numpy arrays."""

    def default(self, o: Any) -> Any:
        if isinstance(o, np.ndarray):
            return o.tolist()
        return json.JSONEncoder.default(self, o)


def make_json_compatible(obj: Any) -> Any:
    """Round-trips an object through JSON to plain python types."""
    return json.loads(json.dumps(obj, cls=_NumpyAwareEncoder))


def stringify_qubit_ids(qubit_ids: Sequence[QubitId]) -> list[str]:
    """Casts qubit IDs to str, refusing casts that collide."""
    names = [str(id) for id in qubit_ids]
    non_str_ids = [id for id in qubit_ids if not isinstance(id, str)]
    if non_str_ids:
        warnings.warn(
            "Register serialization to an abstract representation "
            "irreversibly converts all qubit ID's to strings.",
            stacklevel=2,
        )
        if len(set(names)) < len(names):
            clashes = [
                (id, str(id))
                for id in non_str_ids
                if str(id) in qubit_ids
            ]
            raise AbstractReprError(
                "Name collisions encountered when converting qubit IDs to "
                f"strings for IDs: {clashes}"
            )
    return names


ObjectType = Literal[
    "sequence",
    "device",
    "layout",
    "register",
    "noise",
    "results",
    "config",
]


def get_filename(object_type: ObjectType) -> str:
    """The JSON-schema filename validating the given object type."""
    return f"{object_type}-schema.json"
