"""Validation of the abstract representation (wire format).

Port of ``pulser_tpu/json/abstract_repr/validation.py`` (counterpart of
reference ``pulser-core/pulser/json/abstract_repr/validation.py:98``).
Validates a serialized payload against the JSON schema of its object
type, with ``fastjsonschema`` where it is installed and with
``jsonschema`` (and ``referencing``) otherwise. Both are imported only
when a payload is validated, so the package imports without either;
validating without either raises an ``ImportError`` that names both.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path
from typing import Any, Callable

from pulser_tpu_torch.exceptions.serialization import (
    AbstractReprError,
    SchemaValidationError,
)
from pulser_tpu_torch.json.utils import ObjectType, get_filename

SCHEMAS_PATH = Path(__file__).parent / "schemas"


def _load_schema_copy(filename: str) -> Any:
    """Loads a schema by filename (also the handler of the sibling
    ``$ref``s).

    fastjsonschema mutates the '$ref's of schemas it compiles, so a
    fresh copy is returned every time.
    """
    with open(SCHEMAS_PATH / filename, "r", encoding="utf-8") as f:
        return json.load(f)


def _jsonschema_validator(schema: dict) -> Callable[[Any], None]:
    """A ``jsonschema`` validator that resolves the sibling schemas by
    filename, as the fastjsonschema handler does."""
    import jsonschema
    from referencing import Registry, Resource

    registry = Registry().with_resources(
        (p.name, Resource.from_contents(_load_schema_copy(p.name)))
        for p in SCHEMAS_PATH.glob("*-schema.json")
    )
    return jsonschema.Draft7Validator(schema, registry=registry).validate


@functools.lru_cache
def _get_validator(object_type: ObjectType) -> Callable[[Any], None]:
    schema = _load_schema_copy(get_filename(object_type))
    try:
        import fastjsonschema
    except ImportError:
        try:
            return _jsonschema_validator(schema)
        except ImportError as e:
            raise ImportError(
                "Validating an abstract representation needs either the"
                " 'fastjsonschema' package or the 'jsonschema' package"
                " (with 'referencing'); neither can be imported."
            ) from e
    # Sibling files are referenced with bare filenames (the "" URI scheme)
    return fastjsonschema.compile(schema, handlers={"": _load_schema_copy})


def validate_abstract_repr(obj_str: str, name: ObjectType) -> None:
    """Validate the abstract representation of an object.

    Args:
        obj_str: The JSON string to validate.
        name: The type of object to validate against.
    """
    try:
        obj = json.loads(obj_str)
    except json.JSONDecodeError as e:
        raise AbstractReprError(
            f"The serialized {name} is not a valid JSON string."
        ) from e

    validator = _get_validator(name)
    try:
        validator(obj)
    except Exception as e:
        raise SchemaValidationError(
            f"The serialized {name} does not respect its JSON schema: "
            f"{e}"
        ) from e
