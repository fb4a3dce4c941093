"""Abstract register: an ordered qubit-id -> position mapping.

Behavioral parity with reference
``pulser-core/pulser/register/base_register.py:58-332``. Register
layouts and serialization are not ported yet (see ROADMAP.md).
"""

from __future__ import annotations

import warnings
from abc import ABC, abstractmethod
from collections.abc import Iterable, Mapping
from collections.abc import Sequence as abcSequence
from typing import Any, Optional, Type, TypeVar, cast

import numpy as np
from numpy.typing import ArrayLike

import pulser_tpu_torch.math as pm
from pulser_tpu_torch.register._coordinates import CoordsCollection
from pulser_tpu_torch.register.weight_maps import DetuningMap

T = TypeVar("T", bound="BaseRegister")
QubitId = str

_NON_STR_ID_WARNING = (
    "Usage of `int`s or any non-`str`types as `QubitId`s"
    " will be deprecated. Define your `QubitId`s as `str`s,"
    " prefer setting `prefix='q'` when using classmethods,"
    " as that will become the new default once `int` qubit"
    " IDs become invalid."
)


def _id_map(
    coords: pm.AbstractArray,
    prefix: Optional[str],
    labels: Optional[abcSequence[QubitId]],
) -> dict[Any, pm.AbstractArray]:
    """Pairs a stack of positions with qubit ids.

    Exactly one naming scheme applies: ``prefix`` numbers the
    positions as ``f"{prefix}{i}"``, ``labels`` names them
    explicitly, and with neither the ids are plain integers.
    """
    if prefix is not None and labels is not None:
        raise NotImplementedError(
            "It is impossible to specify a prefix and "
            "a set of labels at the same time"
        )
    if prefix is not None:
        return {f"{prefix}{i}": pos for i, pos in enumerate(coords)}
    if labels is None:
        return dict(cast(Iterable, enumerate(coords)))
    if len(coords) != len(labels):
        raise ValueError(
            f"Label length ({len(labels)}) does not"
            f"match number of coordinates ({len(coords)})"
        )
    return dict(zip(cast(Iterable, labels), coords))


class BaseRegister(ABC, CoordsCollection):
    """The abstract class for a register."""

    @abstractmethod
    def __init__(
        self,
        qubits: Mapping[str, ArrayLike] | Mapping[int, ArrayLike],
    ):
        """Initializes a custom Register."""
        if not isinstance(qubits, dict):
            raise TypeError(
                "The qubits have to be stored in a dictionary "
                "matching qubit ids to position coordinates."
            )
        if not qubits:
            raise ValueError(
                "Cannot create a Register with an empty qubit dictionary."
            )
        super().__init__(
            [pm.AbstractArray(v, dtype=float) for v in qubits.values()]
        )
        self._ids: tuple[QubitId, ...] = tuple(qubits.keys())
        if any(not isinstance(qid, str) for qid in self._ids):
            with warnings.catch_warnings():
                warnings.filterwarnings("once")
                warnings.warn(
                    _NON_STR_ID_WARNING, DeprecationWarning, stacklevel=2
                )

    # --- identity & lookup -------------------------------------------

    @property
    def qubit_ids(self) -> tuple[QubitId, ...]:
        """The qubit IDs of this register."""
        return self._ids

    @property
    def qubits(self) -> dict[QubitId, pm.AbstractArray]:
        """Dictionary of the qubit names and their position coordinates."""
        return dict(zip(self._ids, self._coords_arr))

    def find_indices(self, id_list: abcSequence[QubitId]) -> list[int]:
        """Positions of the given qubit IDs in this register's order.

        Args:
            id_list: The qubit IDs to locate.

        Returns:
            One index per requested ID; only meaningful for this
            register's ID ordering.
        """
        if not set(id_list) <= set(self._ids):
            raise ValueError(
                "The IDs list must be selected among the IDs of the"
                " register's qubits."
            )
        order = {qid: i for i, qid in enumerate(self._ids)}
        return [order[qid] for qid in id_list]

    def coords_hex_hash(self) -> str:
        """Returns the idempotent hash of the coordinates as a hexstring."""
        return self._safe_hash().hex()

    def __eq__(self, other: Any) -> bool:
        if type(other) is not type(self) or self._ids != other._ids:
            return False
        return bool(
            np.allclose(
                self._coords_arr.as_array(detach=True),
                other._coords_arr.as_array(detach=True),
            )
        )

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}({self.qubits})"

    # --- construction ------------------------------------------------

    @classmethod
    def from_coordinates(
        cls: Type[T],
        coords: ArrayLike | pm.TensorLike,
        center: bool = True,
        prefix: Optional[str] = None,
        labels: Optional[abcSequence[QubitId]] = None,
    ) -> T:
        """Builds a register by listing positions instead of a dict.

        Args:
            coords: One position per qubit.
            center: If True, shifts all positions so their mean sits at
                the origin.
            prefix: When given, qubit i is named ``f"{prefix}{i}"``.
            labels: Explicit qubit IDs (exclusive with ``prefix``).

        Returns:
            A register with qubits placed on the given coordinates.
        """
        positions = pm.vstack(cast(abcSequence, coords)).astype(float)
        if center:
            positions = positions - pm.mean(positions, axis=0)
        return cls(_id_map(positions, prefix, labels))

    # --- derived objects ----------------------------------------------

    def define_detuning_map(
        self,
        detuning_weights: Mapping[QubitId, float],
        slug: str | None = None,
    ) -> DetuningMap:
        """Builds a DetuningMap over a subset of this register's qubits.

        Args:
            detuning_weights: Weight in [0, 1] per targeted qubit ID.
            slug: An optional identifier for the detuning map.

        Returns:
            A DetuningMap putting each weight on the matching qubit's
            position.
        """
        if not set(detuning_weights.keys()) <= set(self._ids):
            raise ValueError(
                "The qubit ids linked to detuning weights have to be"
                " defined in the register."
            )
        spots = pm.vstack([self.qubits[qid] for qid in detuning_weights])
        return DetuningMap(spots, list(detuning_weights.values()), slug)
