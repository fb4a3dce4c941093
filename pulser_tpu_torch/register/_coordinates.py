"""Canonical coordinate collections: ordering and content hashing.

Matches the conventions of the reference
``pulser-core/pulser/register/_coordinates.py:19``: points are rounded
to ``COORD_PRECISION`` decimals, ordered by x then y (then z), and
hashed with sha256 over the dimensionality byte(s) + sorted bytes so
that equal point sets hash identically regardless of input order.
"""

from __future__ import annotations

import hashlib
from collections.abc import Iterator, Sequence
from dataclasses import dataclass
from functools import cached_property
from typing import cast

import numpy as np

import pulser_tpu_torch.math as pm

# Positions are significant to 1e-6 um; anything smaller is noise.
COORD_PRECISION = 6


def canonical_order(points: np.ndarray) -> np.ndarray:
    """The permutation sorting points by x, breaking ties by y then z."""
    # np.lexsort keys run minor-to-major, so feed the axes reversed.
    return np.lexsort(tuple(points.T[::-1]))


@dataclass(eq=False, frozen=True)
class CoordsCollection:
    """A set of coordinates with a canonical order and stable hash.

    Points are kept exactly as given in ``_coords`` (possibly
    differentiable); the canonical view rounds them and sorts them
    in ascending (x, y[, z]) order — trap numbering follows that order,
    starting at 0.

    Args:
        _coords: The coordinates.
    """

    _coords: pm.AbstractArray | list

    @cached_property
    def _coords_arr(self) -> pm.AbstractArray:
        """All points stacked into one (n, dims) array, input order."""
        return pm.vstack(cast(Sequence, self._coords)).astype(float)

    @cached_property
    def _canonical_order(self) -> np.ndarray:
        rounded = pm.round(self._coords_arr, decimals=COORD_PRECISION)
        return canonical_order(rounded.as_array(detach=True))

    @cached_property
    def _sorted_coords(self) -> pm.AbstractArray:
        """Rounded points in canonical order (differentiable view)."""
        rounded = pm.round(self._coords_arr, decimals=COORD_PRECISION)
        return rounded[self._canonical_order]

    @property
    def sorted_coords(self) -> np.ndarray:
        """The sorted coordinates."""
        # A fresh copy so callers can't mutate the cached array.
        return self._sorted_coords.as_array(detach=True).copy()

    @property
    def dimensionality(self) -> int:
        """The dimensionality of the coordinates (2 or 3)."""
        return int(self._sorted_coords.shape[1])

    def _hash_components(self) -> Iterator[bytes]:
        """The byte chunks fed, in order, to the content hash.

        Subclasses extend this to mix extra content (e.g. weights)
        into their identity.
        """
        # bytes(n) is n zero bytes: the dimensionality is encoded in
        # the chunk *length* (flattening with tobytes loses the shape).
        yield bytes(self.dimensionality)
        yield self.sorted_coords.tobytes()

    def _safe_hash(self) -> bytes:
        digest = hashlib.sha256()
        for chunk in self._hash_components():
            digest.update(chunk)
        return digest.digest()
