"""The abstract base class for a quantum state.

API parity with reference ``pulser-core/pulser/backend/state.py:34-327``.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from collections import Counter
from collections.abc import Mapping, Sequence
from typing import (
    Any,
    Generic,
    Literal,
    SupportsFloat,
    Type,
    TypeVar,
    Union,
)

from pulser_tpu_torch.channels.base_channel import States
from pulser_tpu_torch.exceptions.serialization import AbstractReprError

Eigenstate = Union[States, Literal["0", "1"]]

ArgScalarType = TypeVar("ArgScalarType")
ReturnScalarType = TypeVar("ReturnScalarType", bound=SupportsFloat)
StateType = TypeVar("StateType", bound="State")

# Which eigenstate reads out as "1", per two-level basis.
_ONE_STATE_OF_BASIS: dict[frozenset[str], str] = {
    frozenset("01"): "1",
    frozenset("rg"): "r",
    frozenset("gh"): "h",
    frozenset("ud"): "d",
}


class State(ABC, Generic[ArgScalarType, ReturnScalarType]):
    """What every backend's quantum-state type must implement."""

    _eigenstates: Sequence[Eigenstate]
    _amplitudes: Mapping[str, complex] | None

    def __init__(self, *, eigenstates: Sequence[Eigenstate]) -> None:
        """Initializes a State."""
        self._validate_eigenstates(eigenstates)
        self._eigenstates = eigenstates
        self._amplitudes = None

    @property
    @abstractmethod
    def n_qudits(self) -> int:
        """The number of qudits in the state."""

    @property
    def eigenstates(self) -> tuple[Eigenstate, ...]:
        """The single-qudit basis labels, in numerical order.

        With eigenstates ("a", "b", ...), "a" maps to the unit vector
        (1, 0, ...), "b" to (0, 1, ...), and so on.
        """
        return tuple(self._eigenstates)

    @property
    def qudit_dim(self) -> int:
        """The dimension (i.e. number of eigenstates) of a qudit."""
        return len(self.eigenstates)

    def get_basis_state_from_index(self, index: int) -> str:
        """The basis-state label sitting at a state-vector index.

        Args:
            index: A position in the flattened state vector.

        Returns:
            The corresponding string of per-qudit eigenstate labels.
        """
        if index < 0:
            raise ValueError(
                f"'index' must be a non-negative integer;"
                f" got {index} instead."
            )
        # The index read out in base `qudit_dim`, least-significant
        # digit = last qudit, left-padded with the zeroth eigenstate.
        digits: list[int] = []
        left = index
        while left:
            left, digit = divmod(left, self.qudit_dim)
            digits.append(digit)
        digits += [0] * (self.n_qudits - len(digits))
        return "".join(self.eigenstates[d] for d in reversed(digits))

    @abstractmethod
    def overlap(
        self: StateType, other: StateType, /
    ) -> ReturnScalarType:
        """``Tr[AB]`` with another state of the same type.

        Reduces to ``|<a|b>|^2`` when both states are pure.
        """

    @abstractmethod
    def sample(
        self,
        *,
        num_shots: int,
        one_state: Eigenstate | None = None,
        p_false_pos: float = 0.0,
        p_false_neg: float = 0.0,
    ) -> Counter[str]:
        """Measured bitstrings, with optional SPAM readout errors.

        Args:
            num_shots: The number of measurements.
            one_state: Which eigenstate reads out as 1.
            p_false_pos: Probability of flipping a measured 0 to 1.
            p_false_neg: Probability of flipping a measured 1 to 0.

        Returns:
            A Counter over the measured bitstrings.
        """

    @classmethod
    def from_state_amplitudes(
        cls: Type[StateType],
        *,
        eigenstates: Sequence[Eigenstate],
        amplitudes: Mapping[str, ArgScalarType],
    ) -> StateType:
        """Builds the state out of per-basis-state amplitudes.

        Args:
            eigenstates: The single-qudit basis, e.g. ('r', 'g').
            amplitudes: Complex amplitude per basis-state label (e.g.
                {"rgr": 0.5, "grg": 0.5}).

        Returns:
            The assembled state.
        """
        cls._validate_eigenstates(eigenstates)
        n_qudits = cls._validate_amplitudes(amplitudes, eigenstates)
        obj, kept_amplitudes = cls._from_state_amplitudes(
            eigenstates=eigenstates,
            n_qudits=n_qudits,
            amplitudes=amplitudes,
        )
        obj._amplitudes = kept_amplitudes
        return obj

    @classmethod
    @abstractmethod
    def _from_state_amplitudes(
        cls: Type[StateType],
        *,
        eigenstates: Sequence[Eigenstate],
        n_qudits: int,
        amplitudes: Mapping[str, ArgScalarType],
    ) -> tuple[StateType, Mapping[str, complex]]:
        """Implements the conversion used in `from_state_amplitudes()`."""

    def infer_one_state(self) -> Eigenstate:
        """Infers the state measured as 1 from the eigenstates."""
        basis = frozenset(self.eigenstates) - {"x"}
        try:
            return _ONE_STATE_OF_BASIS[basis]  # type: ignore[index]
        except KeyError:
            raise RuntimeError(
                "Failed to infer the 'one state' from the "
                f"eigenstates: {self.eigenstates}"
            ) from None

    @staticmethod
    def _validate_eigenstates(
        eigenstates: Sequence[Eigenstate],
    ) -> None:
        if not isinstance(eigenstates, Sequence):
            raise TypeError(
                "'eigenstates' must be a 'collections.Sequence' "
                f"(list or tuple), not {type(eigenstates).__name__}."
            )
        if not all(
            isinstance(s, str) and len(s) == 1 for s in eigenstates
        ):
            raise ValueError(
                "All eigenstates must be represented by single"
                " characters."
            )
        if len(set(eigenstates)) != len(eigenstates):
            raise ValueError(
                "'eigenstates' can't contain repeated entries."
            )

    @staticmethod
    def _validate_amplitudes(
        amplitudes: Mapping[str, Any],
        eigenstates: Sequence[Eigenstate],
    ) -> int:
        """Validates the state amplitudes mapping.

        Returns:
            The number of qudits in the state.
        """
        keys = list(amplitudes)
        n_qudits = len(keys[0])
        alphabet = set(eigenstates)
        consistent = all(
            len(bs) == n_qudits and set(bs) <= alphabet for bs in keys
        )
        if not consistent:
            raise ValueError(
                "All basis states must be combinations of eigenstates"
                f" with the same length. Expected combinations of"
                f" {eigenstates}, each with {n_qudits} elements."
            )
        return n_qudits

    def _serial_payload(self) -> dict[str, Any]:
        """The wire form, requiring amplitude-based construction."""
        if self._amplitudes is None:
            cls_name = self.__class__.__name__
            raise AbstractReprError(
                f"Failed to serialize state of type {cls_name!r} because"
                f" it was not created via"
                f" '{cls_name}.from_state_amplitudes()'."
            )
        return {
            "eigenstates": tuple(self._eigenstates),
            "amplitudes": dict(self._amplitudes),
        }

    def _to_abstract_repr(self) -> dict[str, Any]:
        payload = self._serial_payload()
        # Guard against in-place mutation since construction: rebuild
        # from the recorded amplitudes and compare.
        recreation = self.from_state_amplitudes(
            eigenstates=self._eigenstates,
            amplitudes=self._amplitudes,  # type: ignore[arg-type]
        )
        if abs(float(self.overlap(recreation)) - 1.0) > 1e-12:
            raise AbstractReprError(
                f"Failed to serialize state of type"
                f" {self.__class__.__name__!r} because"
                " it was modified in place after its creation."
            )
        return payload


class StateRepr(State):
    """A state that is only its serializable description.

    Built with ``from_state_amplitudes``; exists so states can ride the
    wire to remote backends without a numerical backing.
    """

    _n_qudits: int

    @classmethod
    def _from_state_amplitudes(
        cls,
        *,
        eigenstates: Sequence[Eigenstate],
        n_qudits: int,
        amplitudes: Mapping[str, complex],
    ) -> tuple[StateRepr, Mapping[str, complex]]:
        state = cls(eigenstates=eigenstates)
        cls._n_qudits = n_qudits
        return state, amplitudes

    def _to_abstract_repr(self) -> dict[str, Any]:
        # No overlap available to check for mutation; serialize as-is.
        return self._serial_payload()

    @property
    def n_qudits(self) -> int:
        """The number of qudits in the state."""
        return self._n_qudits

    def overlap(self, other: StateRepr, /) -> None:
        """``overlap`` not implemented in ``StateRepr``."""
        raise NotImplementedError

    def sample(
        self,
        *,
        num_shots: int,
        one_state: Eigenstate | None = None,
        p_false_pos: float = 0.0,
        p_false_neg: float = 0.0,
    ) -> Counter[str]:
        """``sample`` not implemented in ``StateRepr``."""
        raise NotImplementedError
