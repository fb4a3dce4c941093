"""Register layouts: the trap geometries registers are carved out of.

Behavioral parity with reference
``pulser-core/pulser/register/register_layout.py:41-298``.
"""

from __future__ import annotations

import json
from collections.abc import Iterator, Mapping
from collections.abc import Sequence as abcSequence
from dataclasses import dataclass
from typing import Any, Optional, cast

import numpy as np

import pulser_tpu_torch
from pulser_tpu_torch.json.abstract_repr.serializer import AbstractReprEncoder
from pulser_tpu_torch.json.abstract_repr.validation import validate_abstract_repr
from pulser_tpu_torch.json.utils import obj_to_dict
from pulser_tpu_torch.register._reg_drawer import RegDrawer
from pulser_tpu_torch.register.base_register import BaseRegister, QubitId
from pulser_tpu_torch.register.mappable_reg import MappableRegister
from pulser_tpu_torch.register.traps import Traps
from pulser_tpu_torch.register.weight_maps import DetuningMap


@dataclass(init=False, repr=False, eq=False, frozen=True)
class RegisterLayout(Traps, RegDrawer):
    """A layout of traps out of which registers can be defined.

    A ``RegisterLayout`` defines a register from a set of traps. It is
    intended to be given to the user by the hardware provider to show
    which layouts are available on a given device. The user can create a
    ``Register`` by selecting traps, or a ``MappableRegister`` for
    build-time register definition.

    Note:
        The traps are always sorted under the same convention: ascending
        order along x, then along y, then along z (if applicable).
        Respecting this order, the traps are then numbered from 0.

    Args:
        trap_coordinates: The trap coordinates defining the layout.
        slug: An optional identifier for the layout.
    """

    @property
    def coords(self) -> np.ndarray:
        """A shorthand for 'sorted_coords'."""
        return self.sorted_coords

    def _pick_qubit_ids(
        self,
        trap_ids: tuple[int, ...],
        qubit_ids: Optional[abcSequence[QubitId]],
    ) -> abcSequence[QubitId]:
        """Validates a trap selection and resolves its qubit IDs."""
        if len(set(trap_ids)) != len(trap_ids):
            raise ValueError("Every 'trap_id' must be a unique integer.")
        if not set(trap_ids).issubset(self.traps_dict):
            raise ValueError(
                "All 'trap_ids' must correspond to the ID of a trap."
            )
        if not qubit_ids:
            return [f"q{i}" for i in range(len(trap_ids))]
        if len(set(qubit_ids)) != len(qubit_ids):
            raise ValueError("'qubit_ids' must be a sequence of unique IDs.")
        if len(qubit_ids) != len(trap_ids):
            raise ValueError(
                "'qubit_ids' must have the same size as the number of "
                f"provided 'trap_ids' ({len(trap_ids)})."
            )
        return qubit_ids

    def define_register(
        self,
        *trap_ids: int,
        qubit_ids: Optional[abcSequence[QubitId]] = None,
    ) -> BaseRegister:
        """Defines a register from selected traps.

        Args:
            trap_ids: The trap IDs selected to form the Register.
            qubit_ids: A sequence of unique qubit IDs to associate to the
                selected traps. Must be of the same length as the selected
                traps.

        Returns:
            The respective register instance.
        """
        ids = self._pick_qubit_ids(trap_ids, qubit_ids)
        qubits = dict(zip(ids, self.sorted_coords[list(trap_ids)]))
        if self.dimensionality == 3:
            return pulser_tpu_torch.Register3D(
                qubits, layout=self, trap_ids=trap_ids
            )
        return pulser_tpu_torch.Register(qubits, layout=self, trap_ids=trap_ids)

    def define_detuning_map(
        self,
        detuning_weights: Mapping[int, float],
        slug: str | None = None,
    ) -> DetuningMap:
        """Builds a DetuningMap on a subset of this layout's traps.

        Args:
            detuning_weights: Weight in [0, 1] per targeted trap ID.
            slug: An optional identifier for the detuning map.

        Returns:
            A DetuningMap putting each weight on the matching trap.
        """
        if not set(detuning_weights.keys()) <= set(self.traps_dict):
            raise ValueError(
                "The trap ids of detuning weights have to be integers"
                f" in [0, {self.number_of_traps - 1}]."
            )
        targeted = [self.traps_dict[t] for t in detuning_weights]
        return DetuningMap(targeted, list(detuning_weights.values()), slug)

    def draw(
        self,
        blockade_radius: Optional[float] = None,
        draw_graph: bool = False,
        draw_half_radius: bool = False,
        projection: bool = True,
        fig_name: str | None = None,
        kwargs_savefig: dict = {},
        show: bool = True,
    ) -> None:
        """Draws the entire register layout.

        Args:
            blockade_radius: The distance (in μm) between atoms below which
                the Rydberg blockade effect occurs.
            draw_half_radius: Whether to draw half the blockade radius
                around each trap.
            draw_graph: Whether to draw atom interactions as graph edges.
            projection: If the layout is in 3D, draws it as projections on
                different planes.
            fig_name: The name on which to save the figure, if any.
            kwargs_savefig: Keyword arguments for savefig.
            show: Whether to call `plt.show()` before returning.
        """
        import matplotlib.pyplot as plt

        radius_opts = dict(
            blockade_radius=blockade_radius,
            draw_half_radius=draw_half_radius,
        )
        self._draw_checks(
            self.number_of_traps, draw_graph=draw_graph, **radius_opts
        )
        trap_labels = [str(i) for i in range(self.number_of_traps)]
        if self.dimensionality == 3:
            self._draw_3D(
                self.coords,
                trap_labels,
                projection=projection,
                with_labels=True,
                draw_graph=draw_graph,
                are_traps=True,
                **radius_opts,
            )
        else:
            _, ax = self._initialize_fig_axes(self.coords, **radius_opts)
            self._draw_2D(
                ax,
                self.coords,
                trap_labels,
                draw_graph=draw_graph,
                are_traps=True,
                **radius_opts,
            )
        if fig_name is not None:
            plt.savefig(fig_name, **kwargs_savefig)
        if show:
            plt.show()

    def make_mappable_register(
        self, n_qubits: int, prefix: str = "q"
    ) -> MappableRegister:
        """Creates a mappable register associated with this layout.

        A mappable register is a register whose atoms' positions have not
        yet been defined. Note that not all the qubits 'reserved' in a
        MappableRegister need to be in the final Register.

        Args:
            n_qubits: The number of qubits to reserve in the mappable
                register.
            prefix: The prefix for the qubit ids.

        Returns:
            A substitute for a regular register that can be used to
            initialize a Sequence.
        """
        reserved = [f"{prefix}{i}" for i in range(n_qubits)]
        return MappableRegister(self, *reserved)

    def _hash_components(self) -> Iterator[bytes]:
        yield from super()._hash_components()

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, RegisterLayout) and super().__eq__(other)

    def __repr__(self) -> str:
        return f"RegisterLayout_{self._safe_hash().hex()}"

    def __hash__(self) -> int:
        return hash(self._safe_hash())

    def _to_dict(self) -> dict[str, Any]:
        # Allows serialization of subclasses without a special _to_dict()
        return obj_to_dict(
            self,
            self._coords_arr.tolist(),
            slug=self.slug,
            _module=__name__,
            _name="RegisterLayout",
        )

    def _to_abstract_repr(self) -> dict[str, Any]:
        out: dict = {"coordinates": cast(list, self.coords.tolist())}
        if self.slug is not None:
            out["slug"] = self.slug
        return out

    def to_abstract_repr(self) -> str:
        """Serializes the layout into an abstract JSON object."""
        as_str = json.dumps(self, cls=AbstractReprEncoder)
        validate_abstract_repr(as_str, "layout")
        return as_str

    @staticmethod
    def from_abstract_repr(obj_str: str) -> RegisterLayout:
        """Deserialize a layout from an abstract JSON object.

        Args:
            obj_str: the JSON string representing the layout encoded in
                the abstract JSON format.
        """
        if not isinstance(obj_str, str):
            raise TypeError(
                "The serialized layout must be given as a string. "
                f"Instead, got object of type {type(obj_str)}."
            )
        from pulser_tpu_torch.json.abstract_repr.deserializer import (
            deserialize_abstract_layout,
        )

        return deserialize_abstract_layout(obj_str)
