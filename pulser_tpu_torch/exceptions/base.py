"""Base exception types for pulser_tpu_torch.

API parity with reference ``pulser-core/pulser/exceptions/base.py``.
"""

from __future__ import annotations


class PulserError(Exception):
    """Base class for errors raised by pulser_tpu_torch."""


class PulserValueError(ValueError, PulserError):
    """A ValueError raised by pulser_tpu_torch."""


class PulserTypeError(TypeError, PulserError):
    """A TypeError raised by pulser_tpu_torch."""


class PulserNotImplementedError(NotImplementedError, PulserError):
    """A NotImplementedError raised by pulser_tpu_torch."""
