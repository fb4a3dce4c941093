"""Exception hierarchy for pulser_tpu_torch."""

from pulser_tpu_torch.exceptions.base import (
    PulserError,
    PulserNotImplementedError,
    PulserTypeError,
    PulserValueError,
)

__all__ = [
    "PulserError",
    "PulserValueError",
    "PulserTypeError",
    "PulserNotImplementedError",
]
