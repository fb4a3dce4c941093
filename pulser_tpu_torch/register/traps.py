"""Trap sets: validated, canonically numbered coordinate collections.

Behavioral parity with reference
``pulser-core/pulser/register/traps.py:31`` (trap numbering follows the
canonical coordinate order; identity is the content hash).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from collections.abc import Iterator
from dataclasses import dataclass
from functools import cached_property
from typing import Any

import numpy as np
from numpy.typing import ArrayLike

import pulser_tpu_torch.math as pm
from pulser_tpu_torch.register._coordinates import COORD_PRECISION, CoordsCollection

__all__ = ["Traps", "COORD_PRECISION"]


def _checked_trap_coords(trap_coordinates: ArrayLike) -> None:
    """Validates raw trap coordinates (shape, dimension, uniqueness)."""
    bad_input = ValueError(
        "'trap_coordinates' must be an array or list of coordinates."
    )
    try:
        arr = pm.AbstractArray(trap_coordinates, dtype=float).as_array(
            detach=True
        )
    except ValueError as e:
        raise bad_input from e
    if arr.ndim != 2:
        raise bad_input
    n_traps, dims = arr.shape
    if dims not in (2, 3):
        raise ValueError(
            f"Each coordinate must be of size 2 or 3, not {dims}."
        )
    if len(np.unique(arr, axis=0)) != n_traps:
        raise ValueError(
            "All trap coordinates of a register layout must be unique."
        )


@dataclass(init=False, eq=False, frozen=True)
class Traps(ABC, CoordsCollection):
    """Defines a unique set of traps.

    The traps are always sorted under the same convention: ascending order
    along x, then along y, then along z (if applicable). Respecting this
    order, the traps are then numbered starting from 0.

    Args:
        trap_coordinates: The coordinates of each trap.
    """

    slug: str | None

    def __init__(self, trap_coordinates: ArrayLike, slug: str | None = None):
        """Initializes a set of traps."""
        _checked_trap_coords(trap_coordinates)
        object.__setattr__(self, "_coords", trap_coordinates)
        object.__setattr__(self, "slug", slug)

    @property
    def traps_dict(self) -> dict[int, np.ndarray]:
        """Mapping between trap IDs and coordinates."""
        return dict(enumerate(self.sorted_coords))

    @cached_property  # Acts as an attribute in a frozen dataclass
    def _coords_to_traps(self) -> dict[tuple[float, ...], int]:
        return {
            tuple(coord): trap_id
            for trap_id, coord in enumerate(self.sorted_coords)
        }

    @property
    def number_of_traps(self) -> int:
        """The number of traps in the layout."""
        return len(self._canonical_order)

    def get_traps_from_coordinates(
        self, *coordinates: ArrayLike
    ) -> list[int]:
        """Finds the trap IDs for a given set of trap coordinates.

        Args:
            coordinates: The coordinates to return the trap IDs of.

        Returns:
            The list of trap IDs corresponding to the coordinates.
        """
        lookup = self._coords_to_traps
        keys = np.round(
            np.array(coordinates, dtype=float), decimals=COORD_PRECISION
        )
        ids = []
        for given, key in zip(coordinates, keys):
            try:
                ids.append(lookup[tuple(key)])
            except KeyError:
                raise ValueError(
                    f"The coordinate '{given!s}' is not a part of the "
                    "RegisterLayout."
                ) from None
        return ids

    @abstractmethod
    def _hash_components(self) -> Iterator[bytes]:
        # Subclasses must consciously define their hashed content.
        yield from super()._hash_components()

    def static_hash(self) -> str:
        """Returns the idempotent hash as a hexstring (no '0x' prefix)."""
        return self._safe_hash().hex()

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, Traps) and (
            self._safe_hash() == other._safe_hash()
        )

    def __str__(self) -> str:
        return self.slug or self.__repr__()
