"""Abstract register: an ordered qubit-id -> position mapping.

Behavioral parity with reference
``pulser-core/pulser/register/base_register.py:58-332``.
"""

from __future__ import annotations

import json
import warnings
from abc import ABC, abstractmethod
from collections.abc import Iterable, Mapping
from collections.abc import Sequence as abcSequence
from typing import TYPE_CHECKING, Any, NamedTuple, Optional, Type
from typing import TypeVar, Union, cast

import numpy as np
from numpy.typing import ArrayLike

import pulser_tpu_torch.math as pm
from pulser_tpu_torch.json.abstract_repr.serializer import AbstractReprEncoder
from pulser_tpu_torch.json.abstract_repr.validation import validate_abstract_repr
from pulser_tpu_torch.json.utils import obj_to_dict
from pulser_tpu_torch.register._coordinates import CoordsCollection
from pulser_tpu_torch.register.weight_maps import DetuningMap

if TYPE_CHECKING:
    from pulser_tpu_torch.register.register_layout import RegisterLayout

T = TypeVar("T", bound="BaseRegister")
QubitId = str

_NON_STR_ID_WARNING = (
    "Usage of `int`s or any non-`str`types as `QubitId`s"
    " will be deprecated. Define your `QubitId`s as `str`s,"
    " prefer setting `prefix='q'` when using classmethods,"
    " as that will become the new default once `int` qubit"
    " IDs become invalid."
)


class _LayoutInfo(NamedTuple):
    """Records which layout (and traps) a register was carved from."""

    layout: RegisterLayout
    trap_ids: tuple[int, ...]


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
        **kwargs: Any,
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

        self._layout_info: Optional[_LayoutInfo] = None
        if kwargs:
            if set(kwargs) != {"layout", "trap_ids"}:
                raise ValueError(
                    "If specifying 'kwargs', they must only be 'layout' and"
                    " 'trap_ids'."
                )
            self._attach_layout(
                kwargs["layout"], tuple(kwargs["trap_ids"])
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

    @property
    def layout(self) -> Optional[RegisterLayout]:
        """The layout used to define the register."""
        info = self._layout_info
        return info.layout if info is not None else None

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
        **kwargs: Any,
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
        return cls(_id_map(positions, prefix, labels), **kwargs)

    # --- layout provenance -------------------------------------------

    def _attach_layout(
        self, register_layout: RegisterLayout, trap_ids: tuple[int, ...]
    ) -> None:
        """Validates and records the layout this register came from.

        The checks run in order; each entry is (ok, message).
        """
        own = self._coords_arr.as_array(detach=True)

        def _traps_match() -> bool:
            picked = register_layout.coords[list(trap_ids)]
            return own.shape == picked.shape and not np.any(own != picked)

        checks: tuple[tuple[bool, str], ...] = (
            (
                register_layout.dimensionality == self.dimensionality,
                "The RegisterLayout dimensionality is not the same as"
                " this register's.",
            ),
            (
                len(set(trap_ids)) == len(trap_ids),
                "Every 'trap_id' must be a unique integer.",
            ),
            (
                len(trap_ids) == len(self._ids),
                "The amount of 'trap_ids' must be equal to the number"
                " of atoms in the register.",
            ),
        )
        for ok, message in checks:
            if not ok:
                raise ValueError(message)
        if not _traps_match():
            raise ValueError(
                "The chosen traps from the RegisterLayout don't match"
                " this register's coordinates."
            )
        self._layout_info = _LayoutInfo(register_layout, trap_ids)

    # Kept as a separate hook: subclasses and tests exercise the
    # validation half without mutating provenance.
    def _validate_layout(
        self, register_layout: RegisterLayout, trap_ids: tuple[int, ...]
    ) -> None:
        saved = self._layout_info
        self._attach_layout(register_layout, trap_ids)
        self._layout_info = saved

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

    # --- serialization -------------------------------------------------

    @abstractmethod
    def _to_dict(self) -> dict[str, Any]:
        """Serializes the object via from_coordinates."""
        cls_dict = obj_to_dict(
            None,
            _build=False,
            _name=self.__class__.__name__,
            _module=self.__class__.__module__,
        )
        layout_kwargs = (
            self._layout_info._asdict() if self._layout_info else {}
        )
        return obj_to_dict(
            self,
            cls_dict,
            [pos.tolist() for pos in self._coords_arr],
            False,
            None,
            self._ids,
            **layout_kwargs,
            _submodule=self.__class__.__name__,
            _name="from_coordinates",
        )

    @abstractmethod
    def _to_abstract_repr(self) -> list[dict[str, Union[QubitId, float]]]:
        pass

    def to_abstract_repr(self) -> str:
        """Serializes the register into an abstract JSON object."""
        payload: dict[str, Any] = dict(register=self._to_abstract_repr())
        if self.layout is not None:
            payload["layout"] = self.layout
        as_str = json.dumps(payload, cls=AbstractReprEncoder)
        validate_abstract_repr(as_str, "register")
        return as_str
