"""The abstract base class for parametrized objects.

API parity with reference ``pulser-core/pulser/parametrized/paramabc.py:25``.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import TYPE_CHECKING, Any

if TYPE_CHECKING:
    from pulser_tpu_torch.parametrized import Variable


class Parametrized(ABC):
    """Abstract base class for a parametrized object."""

    @property
    @abstractmethod
    def variables(self) -> dict[str, Variable]:
        """All the variables involved with this object."""

    @abstractmethod
    def build(self) -> Any:
        """Builds the object."""

    @abstractmethod
    def _to_dict(self) -> dict[str, Any]:
        """Serializes the object in a dictionary."""
