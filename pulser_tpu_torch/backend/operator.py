"""The abstract base class for a quantum operator.

API parity with reference
``pulser-core/pulser/backend/operator.py:38-321``.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from collections.abc import Collection, Mapping, Sequence
from typing import Any, Generic, Type, TypeVar

from pulser_tpu_torch.backend.state import Eigenstate, State
from pulser_tpu_torch.exceptions.serialization import AbstractReprError

ArgScalarType = TypeVar("ArgScalarType")
ReturnScalarType = TypeVar("ReturnScalarType")
StateType = TypeVar("StateType", bound=State)
OperatorType = TypeVar("OperatorType", bound="Operator")

# Generic type aliases
T = TypeVar("T")
QuditOp = Mapping[str, T]  # single qudit operator
TensorOp = Sequence[
    tuple[QuditOp[T], Collection[int]]
]  # QuditOp applied to set of qudits
FullOp = Sequence[tuple[T, TensorOp[T]]]  # weighted sum of TensorOp


class Operator(ABC, Generic[ArgScalarType, ReturnScalarType, StateType]):
    """Base class enforcing an API for quantum operators."""

    _eigenstates: Sequence[Eigenstate] | None
    _n_qudits: int | None
    _operations: FullOp[complex] | None

    def __init__(self) -> None:
        """Initializes an Operator."""
        self._eigenstates = None
        self._n_qudits = None
        self._operations = None

    @abstractmethod
    def apply_to(self, state: StateType, /) -> StateType:
        """Apply the operator to a state."""

    @abstractmethod
    def expect(self, state: StateType, /) -> ReturnScalarType:
        """Compute the expectation value of self on the given state."""

    @abstractmethod
    def __add__(
        self: OperatorType, other: OperatorType, /
    ) -> OperatorType:
        """Computes the sum of two operators."""

    @abstractmethod
    def __rmul__(
        self: OperatorType, scalar: ArgScalarType
    ) -> OperatorType:
        """Scale the operator by a scalar factor."""

    @abstractmethod
    def __matmul__(
        self: OperatorType, other: OperatorType
    ) -> OperatorType:
        """Compose two operators where 'self' is applied after 'other'."""

    @classmethod
    def from_operator_repr(
        cls: Type[OperatorType],
        *,
        eigenstates: Sequence[Eigenstate],
        n_qudits: int,
        operations: FullOp[ArgScalarType],
    ) -> OperatorType:
        """Create an operator from the operator representation.

        The full operator representation (``FullOp``) is a weighted sum of
        tensor operators (``TensorOp``): a sequence of coefficient and
        tensor-operator pairs. Each ``TensorOp`` is a sequence of qudit
        operators (``QuditOp``) applied to mutually exclusive sets of
        qudits (by index); qudits without an associated ``QuditOp`` get
        the identity. Each ``QuditOp`` maps strings ``"ij"`` (for
        ``|i><j|`` over eigenstates i, j) to coefficients.

        Args:
            eigenstates: The eigenstates to use.
            n_qudits: How many qudits there are in the system.
            operations: The full operator representation.

        Returns:
            The constructed operator.
        """
        State._validate_eigenstates(eigenstates)
        cls._validate_operations(
            eigenstates=eigenstates,
            n_qudits=n_qudits,
            operations=operations,
        )
        obj, _operations = cls._from_operator_repr(
            eigenstates=eigenstates,
            n_qudits=n_qudits,
            operations=operations,
        )
        obj._eigenstates = eigenstates
        obj._n_qudits = n_qudits
        obj._operations = _operations
        return obj

    @classmethod
    @abstractmethod
    def _from_operator_repr(
        cls: Type[OperatorType],
        *,
        eigenstates: Sequence[Eigenstate],
        n_qudits: int,
        operations: FullOp[ArgScalarType],
    ) -> tuple[OperatorType, FullOp[complex]]:
        """Implements the conversion used in `from_operator_repr()`."""

    def _to_abstract_repr(self) -> dict[str, Any]:
        recorded = (self._eigenstates, self._n_qudits, self._operations)
        if any(part is None for part in recorded):
            cls_name = self.__class__.__name__
            raise AbstractReprError(
                f"Failed to serialize state of type {cls_name!r} because"
                f" it was not created via"
                f" '{cls_name}.from_operator_repr()'."
            )
        return {
            "eigenstates": tuple(self._eigenstates),  # type: ignore
            "n_qudits": self._n_qudits,
            "operations": self._operations,
        }

    @staticmethod
    def _validate_operations(
        *,
        eigenstates: Sequence[Eigenstate],
        n_qudits: int,
        operations: FullOp,
    ) -> None:
        """Check validity of operations passed to `from_operator_repr`.

        Each tensor operator may claim a qudit index only once, and
        every qudit-operator key must be a two-eigenstate projector
        label.
        """

        def check_keys(qudit_op: QuditOp) -> None:
            for proj_str in qudit_op:
                well_formed = len(proj_str) == 2 and all(
                    s_ in eigenstates for s_ in proj_str
                )
                if not well_formed:
                    raise ValueError(
                        f"Every QuditOp key must be made up"
                        f" of two eigenstates"
                        f" among {eigenstates};"
                        f" instead, got '{proj_str}'."
                    )

        for tensor_op_num, (_, tensor_op) in enumerate(operations):
            free_inds = set(range(n_qudits))
            for qudit_op, qudit_inds in tensor_op:
                claimed_twice = set(qudit_inds) - free_inds
                if claimed_twice:
                    raise ValueError(
                        "Got invalid indices for a system with "
                        f"{n_qudits} qudits: {claimed_twice}. For TensorOp "
                        f"#{tensor_op_num}, only indices {free_inds} "
                        "were still available."
                    )
                free_inds -= set(qudit_inds)
                check_keys(qudit_op)


class OperatorRepr(Operator):
    """An operator that is only its serializable description.

    Built with ``from_operator_repr``; exists so operators can ride the
    wire to remote backends without a numerical backing.
    """

    @classmethod
    def _from_operator_repr(
        cls: Type[OperatorType],
        *,
        eigenstates: Sequence[Eigenstate],
        n_qudits: int,
        operations: FullOp[complex],
    ) -> tuple[OperatorType, FullOp[complex]]:
        op = cls()
        return op, operations

    def apply_to(self, state: StateType, /) -> StateType:
        """``apply_to`` not implemented in ``OperatorRepr``."""
        raise NotImplementedError(
            "``apply_to`` not implemented in ``OperatorRepr``."
        )

    def expect(self, state: StateType, /) -> None:
        """``expect`` not implemented in ``OperatorRepr``."""
        raise NotImplementedError(
            "``expect`` not implemented in ``OperatorRepr``."
        )

    def __add__(
        self: OperatorType, other: OperatorType, /
    ) -> OperatorType:
        """``__add__`` not implemented in ``OperatorRepr``."""
        raise NotImplementedError(
            "``__add__`` not implemented in ``OperatorRepr``."
        )

    def __rmul__(
        self: OperatorType, scalar: ArgScalarType
    ) -> OperatorType:
        """``__rmul__`` not implemented in ``OperatorRepr``."""
        raise NotImplementedError(
            "``__rmul__`` not implemented in ``OperatorRepr``."
        )

    def __matmul__(
        self: OperatorType, other: OperatorType
    ) -> OperatorType:
        """``__matmul__`` not implemented in ``OperatorRepr``."""
        raise NotImplementedError(
            "``__matmul__`` not implemented in ``OperatorRepr``."
        )
