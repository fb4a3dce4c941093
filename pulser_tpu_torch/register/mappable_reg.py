"""Registers whose atoms get placed on traps only at build time.

Behavioral parity with reference
``pulser-core/pulser/register/mappable_reg.py:29``.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import TYPE_CHECKING, Any
from typing import Sequence as abcSequence

from pulser_tpu_torch.json.utils import obj_to_dict, stringify_qubit_ids

if TYPE_CHECKING:
    from pulser_tpu_torch.register.base_register import BaseRegister, QubitId
    from pulser_tpu_torch.register.register_layout import RegisterLayout
    from pulser_tpu_torch.register.weight_maps import DetuningMap


class MappableRegister:
    """A register with the traps of each qubit still to be defined.

    Args:
        register_layout: The register layout on which this register will
            be defined.
        qubit_ids: The IDs for the qubits to pre-declare on this register.
    """

    def __init__(
        self, register_layout: RegisterLayout, *qubit_ids: QubitId
    ):
        """Initializes the mappable register."""
        if len(qubit_ids) > register_layout.number_of_traps:
            raise ValueError(
                "The number of required qubits is greater than the number"
                f" of traps in this layout"
                f" ({register_layout.number_of_traps})."
            )
        self._layout = register_layout
        self._qubit_ids = qubit_ids

    @property
    def qubit_ids(self) -> tuple[QubitId, ...]:
        """The qubit IDs of this mappable register."""
        return self._qubit_ids

    @property
    def layout(self) -> RegisterLayout:
        """The layout used to define the register."""
        return self._layout

    def build_register(self, qubits: Mapping[QubitId, int]) -> BaseRegister:
        """Pins the declared qubits onto layout traps.

        Args:
            qubits: Which trap (by ID) each used qubit ID lands on.
                Pre-declared IDs missing from this map are dropped from
                the final register.

        Returns:
            The concrete register.
        """
        used = set(qubits.keys())
        if not used <= set(self._qubit_ids):
            raise ValueError(
                "All qubits must be labeled with pre-declared qubit IDs."
            )
        # Only a prefix of the pre-declared IDs may be used.
        if used != set(self.qubit_ids[: len(used)]):
            raise ValueError(
                f"To declare {len(qubits.keys())} qubits, 'qubits' should "
                f"contain the first {len(qubits.keys())} elements of the "
                "'qubit_ids'."
            )
        # Preserve pre-declared ordering, not the mapping's.
        in_order = [qid for qid in self._qubit_ids if qid in used]
        return self._layout.define_register(
            *tuple(qubits[qid] for qid in in_order),
            qubit_ids=tuple(in_order),
        )

    def find_indices(self, id_list: abcSequence[QubitId]) -> list[int]:
        """Positions of the given IDs in the pre-declared ordering.

        Args:
            id_list: The qubit IDs to locate.

        Returns:
            One index per requested ID, valid for this declaration
            order.
        """
        if not set(id_list) <= set(self._qubit_ids):
            raise ValueError(
                "The IDs list must be selected among pre-declared qubit"
                " IDs."
            )
        return [self.qubit_ids.index(id) for id in id_list]

    def define_detuning_map(
        self,
        detuning_weights: Mapping[int, float],
        slug: str | None = None,
    ) -> DetuningMap:
        """Builds a DetuningMap on this register's layout traps.

        Args:
            detuning_weights: Weight in [0, 1] per targeted trap ID.
            slug: An optional identifier for the detuning map.

        Returns:
            A DetuningMap putting each weight on the matching trap.
        """
        return self._layout.define_detuning_map(detuning_weights, slug)

    def _to_dict(self) -> dict[str, Any]:
        return obj_to_dict(self, self._layout, *self._qubit_ids)

    def _to_abstract_repr(self) -> list[dict[str, str]]:
        return [
            dict(qid=qid) for qid in stringify_qubit_ids(self.qubit_ids)
        ]
