"""Deprecated alias module for serialization errors.

The exceptions live in :mod:`pulser_tpu_torch.exceptions.serialization`;
this path is kept for compatibility with code written against the old
layout (reference: pulser-core/pulser/json/exceptions.py) and warns on
import.
"""

import warnings

from pulser_tpu_torch.exceptions.serialization import (
    AbstractReprError,
    DeserializeDeviceError,
    SerializationError,
)

warnings.warn(
    "module pulser_tpu_torch.json.exceptions is deprecated, "
    "please migrate your code to "
    "use pulser_tpu_torch.exceptions.serialization",
    category=DeprecationWarning,
    stacklevel=2,
)

__all__ = [
    "AbstractReprError",
    "DeserializeDeviceError",
    "SerializationError",
]
