"""The stock observables shipped with the backend API.

API parity with reference
``pulser-core/pulser/backend/default_observables.py:33-579``. Every
observable here derives from one plumbing base that fixes its tag and
its default cross-trajectory aggregation method.
"""

from __future__ import annotations

import copy
import functools
import warnings
from collections import Counter
from collections.abc import Sequence
from typing import TYPE_CHECKING, Any, ClassVar, Type

from pulser_tpu_torch.backend.observable import AggregationMethod, Observable
from pulser_tpu_torch.backend.operator import Operator, OperatorType
from pulser_tpu_torch.backend.state import Eigenstate, State, StateType
from pulser_tpu_torch.exceptions.serialization import AbstractReprError

if TYPE_CHECKING:
    from pulser_tpu_torch.backend.config import EmulationConfig


@functools.cache
def _number_operator(
    qudit_ids: frozenset[int],
    n_qudits: int,
    eigenstates: Sequence[Eigenstate],
    one_state: Eigenstate,
    op_type: Type[OperatorType],
) -> OperatorType:
    """|one><one| projectors on the given qudits, as a backend operator."""
    projector = {one_state * 2: 1.0}
    return op_type.from_operator_repr(
        eigenstates=eigenstates,
        n_qudits=n_qudits,
        operations=[(1.0, [(projector, qudit_ids)])],
    )


def _identity_like(hamiltonian: Operator, state: State) -> Operator:
    """The identity operator, in the same backend type as `hamiltonian`."""
    return hamiltonian.from_operator_repr(
        eigenstates=state.eigenstates,
        n_qudits=state.n_qudits,
        operations=[(1.0, [])],
    )


class _DefaultObservable(Observable):
    """Common plumbing: a fixed base tag + per-class aggregation default."""

    _TAG: ClassVar[str]
    _AGGREGATION: ClassVar[AggregationMethod]

    def __init__(
        self,
        *,
        evaluation_times: Sequence[float] | None = None,
        tag_suffix: str | None = None,
        default_aggregation_method: AggregationMethod | None = None,
    ):
        """Initializes the observable."""
        super().__init__(
            evaluation_times=evaluation_times,
            tag_suffix=tag_suffix,
            default_aggregation_method=(
                self._AGGREGATION
                if default_aggregation_method is None
                else default_aggregation_method
            ),
        )

    @property
    def _base_tag(self) -> str:
        return self._TAG


class StateResult(_DefaultObservable):
    """Stores the quantum state at the evaluation times."""

    _TAG = "state"
    _AGGREGATION = AggregationMethod.SKIP_WARN

    def _to_abstract_repr(self) -> dict[str, Any]:
        raise AbstractReprError(
            "`StateResult` observable is not supported in any remote"
            " backend. If you are interested in the full quantum state at"
            " arbitrary times during the emulation, please consider using"
            " the local version of the same backend."
        )

    def apply(self, *, state: StateType, **kwargs: Any) -> StateType:
        """A deep copy of the current state."""
        return copy.deepcopy(state)


class BitStrings(_DefaultObservable):
    """Stores bitstrings sampled from the state at the evaluation times.

    Error rates are taken from the NoiseModel passed to the backend via
    the EmulationConfig. The bitstrings are stored as a Counter[str].

    Args:
        evaluation_times: The relative times at which to sample.
        num_shots: How many bitstrings to sample each time. If left as
            `None`, uses `default_num_shots` of the ``EmulationConfig``.
        one_state: The eigenstate that measures to 1.
        tag_suffix: Optional suffix appended to the tag.
        default_aggregation_method: How to combine the values of this
            observable from multiple results.
    """

    _TAG = "bitstrings"
    _AGGREGATION = AggregationMethod.BAG_UNION

    def __init__(
        self,
        *,
        evaluation_times: Sequence[float] | None = None,
        num_shots: int | None = None,
        one_state: Eigenstate | None = None,
        tag_suffix: str | None = None,
        default_aggregation_method: AggregationMethod | None = None,
    ):
        """Initializes the observable."""
        super().__init__(
            evaluation_times=evaluation_times,
            tag_suffix=tag_suffix,
            default_aggregation_method=default_aggregation_method,
        )
        self.num_shots = num_shots
        self.one_state = one_state

    @property
    def num_shots(self) -> int | None:
        """How many bitstrings to sample at each evaluation."""
        if self._num_shots is None:
            warnings.warn(
                "When `BitStrings.num_shots` is left as None, it relies"
                " on `EmulationConfig.default_num_shots` to decide how"
                " many shots to take.",
                RuntimeWarning,
                stacklevel=2,
            )
        return self._num_shots

    @num_shots.setter
    def num_shots(self, num_shots: int | None) -> None:
        if num_shots is not None:
            if num_shots < 1:
                raise ValueError(
                    "'num_shots' must be greater than or equal to 1, "
                    f"not {num_shots}."
                )
            num_shots = int(num_shots)
        self._num_shots = num_shots

    def _to_abstract_repr(self) -> dict[str, Any]:
        out = super()._to_abstract_repr()
        out["num_shots"] = self._num_shots
        out["one_state"] = self.one_state
        return out

    def apply(
        self,
        *,
        config: EmulationConfig,
        state: State,
        **kwargs: Any,
    ) -> Counter[str]:
        """Samples the state with the config's SPAM error rates."""
        shots = (
            config.default_num_shots
            if self._num_shots is None
            else self._num_shots
        )
        return state.sample(
            num_shots=shots,
            one_state=self.one_state,
            p_false_pos=config.noise_model.p_false_pos,
            p_false_neg=config.noise_model.p_false_neg,
        )


class Fidelity(_DefaultObservable):
    """Stores the fidelity with a pure state at the evaluation times.

    For pure states this corresponds to ``|<ψ|φ(t)>|^2`` for the given
    state ``|ψ>`` and the evolved state ``|φ(t)>``.

    Args:
        state: The state ``|ψ>``. Must be of an appropriate type for the
            backend.
        evaluation_times: The relative times at which to compute.
        tag_suffix: Optional suffix appended to the tag.
        default_aggregation_method: How to combine values from multiple
            results.
    """

    _TAG = "fidelity"
    _AGGREGATION = AggregationMethod.MEAN

    def __init__(
        self,
        state: State,
        *,
        evaluation_times: Sequence[float] | None = None,
        tag_suffix: str | None = None,
        default_aggregation_method: AggregationMethod | None = None,
    ):
        """Initializes the observable."""
        super().__init__(
            evaluation_times=evaluation_times,
            tag_suffix=tag_suffix,
            default_aggregation_method=default_aggregation_method,
        )
        if not isinstance(state, State):
            raise TypeError(
                f"'state' must be a State instance; got {type(state)}"
                " instead."
            )
        self.state = state

    def _to_abstract_repr(self) -> dict[str, Any]:
        out = super()._to_abstract_repr()
        out["state"] = self.state
        return out

    def apply(self, *, state: State, **kwargs: Any) -> Any:
        """The overlap of the reference state with the current one."""
        return self.state.overlap(state)


class Expectation(_DefaultObservable):
    """Stores the expectation of an operator on the current state.

    Args:
        operator: The operator to measure. Must be of the appropriate
            type for the backend.
        evaluation_times: The relative times at which to compute.
        tag_suffix: Optional suffix appended to the tag.
        default_aggregation_method: How to combine values from multiple
            results.
    """

    _TAG = "expectation"
    _AGGREGATION = AggregationMethod.MEAN

    def __init__(
        self,
        operator: Operator,
        *,
        evaluation_times: Sequence[float] | None = None,
        tag_suffix: str | None = None,
        default_aggregation_method: AggregationMethod | None = None,
    ):
        """Initializes the observable."""
        super().__init__(
            evaluation_times=evaluation_times,
            tag_suffix=tag_suffix,
            default_aggregation_method=default_aggregation_method,
        )
        if not isinstance(operator, Operator):
            raise TypeError(
                "'operator' must be an Operator instance;"
                f" got {type(operator)} instead."
            )
        self.operator = operator

    def _to_abstract_repr(self) -> dict[str, Any]:
        out = super()._to_abstract_repr()
        out["operator"] = self.operator
        return out

    def apply(self, *, state: State, **kwargs: Any) -> Any:
        """The operator's expectation value on the current state."""
        return self.operator.expect(state)


class _OneStateObservable(_DefaultObservable):
    """Plumbing for observables parameterized by a 'one' eigenstate."""

    _AGGREGATION = AggregationMethod.MEAN

    def __init__(
        self,
        *,
        evaluation_times: Sequence[float] | None = None,
        one_state: Eigenstate | None = None,
        tag_suffix: str | None = None,
        default_aggregation_method: AggregationMethod | None = None,
    ):
        """Initializes the observable."""
        super().__init__(
            evaluation_times=evaluation_times,
            tag_suffix=tag_suffix,
            default_aggregation_method=default_aggregation_method,
        )
        self.one_state = one_state

    def _to_abstract_repr(self) -> dict[str, Any]:
        out = super()._to_abstract_repr()
        out["one_state"] = self.one_state
        return out

    def _projector_expectation(
        self,
        qudit_ids: frozenset[int],
        state: State,
        hamiltonian: Operator,
    ) -> Any:
        return _number_operator(
            qudit_ids,
            state.n_qudits,
            state.eigenstates,
            self.one_state or state.infer_one_state(),
            type(hamiltonian),
        ).expect(state)


class CorrelationMatrix(_OneStateObservable):
    """Stores the correlation matrix for the current state.

    Calculated as ``[[<φ(t)|n_i n_j|φ(t)> for j] for i]`` where
    ``n_k = |one_state><one_state|``.

    Args:
        evaluation_times: The relative times at which to compute.
        one_state: The eigenstate to measure the population of.
        tag_suffix: Optional suffix appended to the tag.
        default_aggregation_method: How to combine values from multiple
            results.
    """

    _TAG = "correlation_matrix"

    def apply(
        self, *, state: State, hamiltonian: Operator, **kwargs: Any
    ) -> list[list]:
        """All pairwise <n_i n_j> expectations, as a nested list."""

        @functools.cache
        def pair_value(qudit_ids: frozenset[int]) -> Any:
            return self._projector_expectation(
                qudit_ids, state, hamiltonian
            )

        n = state.n_qudits
        return [
            [pair_value(frozenset((i, j))) for j in range(n)]
            for i in range(n)
        ]


class Occupation(_OneStateObservable):
    """Stores the occupation number of an eigenstate on each qudit.

    For every qudit i, calculates ``<φ(t)|n_i|φ(t)>``, where
    ``n_i = |one_state><one_state|``.

    Args:
        evaluation_times: The relative times at which to compute.
        one_state: The eigenstate to measure the population of.
        tag_suffix: Optional suffix appended to the tag.
        default_aggregation_method: How to combine values from multiple
            results.
    """

    _TAG = "occupation"

    def apply(
        self, *, state: State, hamiltonian: Operator, **kwargs: Any
    ) -> list:
        """Per-qudit <n_i> expectations."""
        return [
            self._projector_expectation(frozenset((i,)), state, hamiltonian)
            for i in range(state.n_qudits)
        ]


class Energy(_DefaultObservable):
    """Stores the energy of the system at the evaluation times.

    Calculated as the expectation value of the Hamiltonian,
    i.e. ``<φ(t)|H(t)|φ(t)>``.
    """

    _TAG = "energy"
    _AGGREGATION = AggregationMethod.MEAN

    def apply(
        self, *, state: State, hamiltonian: Operator, **kwargs: Any
    ) -> Any:
        """<H(t)> on the current state."""
        return hamiltonian.expect(state)


class EnergyVariance(_DefaultObservable):
    r"""Stores the variance of the Hamiltonian at the evaluation times.

    Calculated as ``<φ(t)|H(t)^2|φ(t)> - <φ(t)|H(t)|φ(t)>^2``.
    """

    _TAG = "energy_variance"
    _AGGREGATION = AggregationMethod.SKIP_WARN

    def apply(
        self, *, state: State, hamiltonian: Operator, **kwargs: Any
    ) -> Any:
        """<H^2> - <H>^2, without ever squaring the Hamiltonian."""
        # Tr[I (H state)] = <H^2> for kets and density matrices alike.
        h_state = hamiltonian.apply_to(state)
        identity = _identity_like(hamiltonian, state)
        return identity.expect(h_state) - hamiltonian.expect(state) ** 2


class EnergySecondMoment(_DefaultObservable):
    """Stores the expectation value of ``H(t)^2`` at evaluation times."""

    _TAG = "energy_second_moment"
    _AGGREGATION = AggregationMethod.MEAN

    def apply(
        self, *, state: State, hamiltonian: Operator, **kwargs: Any
    ) -> Any:
        """<H^2> via one Hamiltonian application."""
        h_state = hamiltonian.apply_to(state)
        return _identity_like(hamiltonian, state).expect(h_state)
