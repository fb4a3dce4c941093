"""Serialization errors.

API parity with reference
``pulser-core/pulser/exceptions/serialization.py`` (same class names
and message texts), using the template-rendering base shared with the
sequence errors instead of per-class ``__str__`` methods.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, Optional

from pulser_tpu_torch.exceptions.base import PulserError


class SerializationError(PulserError):
    """Exception raised while attempting to serialize data."""


@dataclass
class SerializationSupportMissing(SerializationError):
    """Attempting to serialize a class we don't know how to serialize."""

    _template: ClassVar[Optional[str]] = None

    def __str__(self) -> str:
        if self._template is None:
            return super().__str__()
        return self._template.format(self=self)


@dataclass
class SerializationSupportModuleMissing(SerializationSupportMissing):
    """Error: we don't know how to serialize values from this module."""

    module: str

    _template = "No serialization support for module '{self.module}'."


@dataclass
class SerializationSupportAttributeMissing(SerializationSupportMissing):
    """Error: we don't know how to serialize this attribute."""

    module: str
    submodule: str

    _template = (
        "No serialization support for attributes of "
        "'{self.module}.{self.submodule}'."
    )


@dataclass
class SerializationSupportClassMissing(SerializationSupportMissing):
    """Error: we don't know how to serialize values of this class."""

    module: str
    class_name: str

    _template = (
        "No serialization support for "
        "'{self.module}.{self.class_name}'."
    )


class AbstractReprError(PulserError):
    """Error raised when representing a sequence in the abstract format."""


class DeserializeDeviceError(PulserError):
    """Error raised when deserializing a device fails."""


class SchemaValidationError(AbstractReprError):
    """The serialized payload does not respect its JSON schema.

    Distinguished from other abstract-repr errors so callers can wrap
    build-time schema failures of parametrized sequences (reference
    ``sequence.py:1906-1915`` wraps only validation errors).
    """
