"""Callbacks and observables: the emulator's metrics pipeline.

API parity with reference
``pulser-core/pulser/backend/observable.py:40-242``. A ``Callback``
fires at every solver step; an ``Observable`` additionally computes a
value at its evaluation times and records it into ``Results`` under its
tag, with a declared cross-trajectory aggregation method.
"""

from __future__ import annotations

import uuid
from abc import ABC, abstractmethod
from collections.abc import Sequence
from enum import IntEnum
from typing import TYPE_CHECKING, Any

import numpy as np
from numpy.typing import ArrayLike, NDArray

from pulser_tpu_torch import profiling
from pulser_tpu_torch.backend.operator import Operator
from pulser_tpu_torch.backend.state import State

if TYPE_CHECKING:
    from pulser_tpu_torch.backend.config import EmulationConfig
    from pulser_tpu_torch.backend.results import Results

TIME_TOLERANCE = 1e-12


class Callback(ABC):
    """A hook invoked at every emulation step."""

    def __init__(self) -> None:
        """Initializes a Callback."""
        self._uuid: uuid.UUID = uuid.uuid4()

    @property
    def uuid(self) -> uuid.UUID:
        """A universal unique identifier for this instance."""
        return self._uuid

    @abstractmethod
    def __call__(
        self,
        config: EmulationConfig,
        t: float,
        state: State,
        hamiltonian: Operator,
        result: Results,
    ) -> None:
        """Invoked by the emulator after every time step.

        Args:
            config: The backend's configuration.
            t: Relative time in [0, 1].
            state: The state after this step.
            hamiltonian: The Hamiltonian at ``t``.
            result: Where a callback may record values.
        """


class AggregationMethod(IntEnum):
    """Defines how to combine values from multiple results."""

    SKIP = 0
    SKIP_WARN = 1
    MEAN = 2
    BAG_UNION = 3
    MEANSTD = 4


class Observable(Callback):
    """A quantity recorded into Results at chosen times.

    Args:
        evaluation_times: Relative times (in [0, 1]) at which to record;
            falls back to the config's ``default_evaluation_times`` when
            None.
        tag_suffix: Disambiguates the tag when one config carries
            several instances of the same observable type.
        default_aggregation_method: How values from several trajectories
            merge during ``Results.aggregate``.
    """

    evaluation_times: NDArray[np.floating[Any]] | None

    def __init__(
        self,
        *,
        default_aggregation_method: AggregationMethod,
        evaluation_times: Sequence[float] | None = None,
        tag_suffix: str | None = None,
    ):
        """Initializes the observable."""
        super().__init__()
        self.evaluation_times = (
            None
            if evaluation_times is None
            else self._validate_eval_times(evaluation_times)
        )
        self._tag_suffix = tag_suffix
        self._default_aggregation_method = default_aggregation_method

    @property
    def default_aggregation_method(self) -> AggregationMethod:
        """The cross-trajectory merge rule for this observable."""
        return self._default_aggregation_method

    @property
    @abstractmethod
    def _base_tag(self) -> str:
        pass

    @property
    def tag(self) -> str:
        """The key under which values land in the Results object."""
        suffix = "" if self._tag_suffix is None else f"_{self._tag_suffix}"
        return self._base_tag + suffix

    def _is_due(self, config: EmulationConfig, t: float, tol: float) -> bool:
        """Whether `t` matches this observable's evaluation times."""
        if self.evaluation_times is not None:
            return bool(
                config.is_time_in_evaluation_times(
                    t, self.evaluation_times, tol=tol
                )
            )
        return bool(config.is_evaluation_time(t, tol=tol))

    def __call__(
        self,
        config: EmulationConfig,
        t: float,
        state: State,
        hamiltonian: Operator,
        result: Results,
    ) -> None:
        """Records ``apply()``'s value when ``t`` is an evaluation time."""
        # Half a time step when the duration is known, else loose.
        tol = (
            (0.5 / result.total_duration)
            if result.total_duration
            else 1e-6
        )
        if self._is_due(config, t, tol):
            with profiling.phase(f"observable.{self._base_tag}"):
                value = self.apply(
                    config=config, state=state, hamiltonian=hamiltonian
                )
            result._store(observable=self, time=t, value=value)

    @abstractmethod
    def apply(
        self,
        *,
        config: EmulationConfig,
        state: State,
        hamiltonian: Operator,
    ) -> Any:
        """Computes this observable's value for one time step."""

    def _to_abstract_repr(self) -> dict[str, Any]:
        return {
            "observable": self._base_tag,
            "evaluation_times": self.evaluation_times,
            "tag_suffix": self._tag_suffix,
            "default_aggregation_method": (
                self._default_aggregation_method
            ),
            "uuid": str(self._uuid),
        }

    def __repr__(self) -> str:
        return f"{self.tag}:{self.uuid}"

    @staticmethod
    def _validate_eval_times(
        evaluation_times: ArrayLike | Sequence[float],
    ) -> NDArray[np.floating[Any]]:
        times = np.array(evaluation_times, dtype=float)
        if times.min(initial=0) < 0.0 or times.max(initial=0) > 1.0:
            raise ValueError(
                "All evaluation times must be between 0. and 1. "
                f"Instead, got {evaluation_times!r}."
            )
        gaps = np.diff(times)
        if np.any(np.abs(gaps) < TIME_TOLERANCE):
            raise ValueError(
                f"Evaluation times must be unique up to {TIME_TOLERANCE}"
                f" but {evaluation_times!r} has repeated values."
            )
        if np.any(gaps <= 0):
            raise ValueError(
                "Evaluation times must be in ascending order."
                f"Instead, got {evaluation_times!r}."
            )
        return times
