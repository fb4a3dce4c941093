"""Observable result storage, serialization and aggregation.

API parity with reference
``pulser-core/pulser/backend/results.py:52-530``.
"""

from __future__ import annotations

import collections.abc
import json
import typing
import uuid
import warnings
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Callable, Type, TypeVar, cast, overload

from pulser_tpu_torch.backend.aggregators import AGGREGATOR_MAPPING
from pulser_tpu_torch.backend.observable import AggregationMethod, Observable
from pulser_tpu_torch.backend.state import State
from pulser_tpu_torch.json.abstract_repr.serializer import AbstractReprEncoder
from pulser_tpu_torch.json.abstract_repr.validation import validate_abstract_repr
from pulser_tpu_torch.json.utils import stringify_qubit_ids

ResultsType = TypeVar("ResultsType", bound="Results")

#: Attributes that only existed on the deprecated SampledResult
_SAMPLED_RESULT_ATTRS = (
    "sampling_dist",
    "sampling_errors",
    "get_samples",
    "get_state",
    "plot_histogram",
    "n_samples",
    "evaluation_time",
    "meas_basis",
)

_SKIP_METHODS = (AggregationMethod.SKIP, AggregationMethod.SKIP_WARN)


@dataclass(repr=False)
class Results:
    """Time-tagged observable values, keyed by observable identity.

    Args:
        atom_order: The qudit ordering used in states and bitstrings.
        total_duration: The sequence duration (ns).
    """

    atom_order: tuple[str, ...]
    """The qudit ordering used in states and bitstrings."""
    total_duration: int
    """The sequence duration (ns)."""
    _results: dict[uuid.UUID, list[Any]] = field(init=False, repr=False)
    _times: dict[uuid.UUID, list[float]] = field(init=False, repr=False)
    _aggregation_methods: dict[uuid.UUID, AggregationMethod] = field(
        init=False, repr=False
    )
    _tagmap: dict[str, uuid.UUID] = field(init=False, repr=False)

    def __post_init__(self) -> None:
        self._results = {}
        self._times = {}
        self._tagmap = {}
        self._aggregation_methods = {}

    # --- Storage -------------------------------------------------------

    def _store_raw(
        self,
        *,
        uuid: uuid.UUID,
        tag: str,
        time: float,
        value: Any,
        aggregation_method: AggregationMethod,
    ) -> None:
        stored_times = self._times.setdefault(uuid, [])
        if time in stored_times:
            raise RuntimeError(
                f"A value is already stored for observable '{tag}'"
                f" at time {time}."
            )
        self._tagmap[tag] = uuid
        assert (
            stored_times == [] or stored_times[-1] < time
        ), "Evaluation times are not sorted."
        stored_times.append(time)
        self._results.setdefault(uuid, []).append(value)
        self._aggregation_methods[uuid] = aggregation_method
        assert len(stored_times) == len(self._results[uuid])

    def _store(
        self, *, observable: Observable, time: float, value: Any
    ) -> None:
        """Records one observable value at a relative time.

        Args:
            observable: The observable the value came from.
            time: The relative evaluation time.
            value: The computed value.
        """
        self._store_raw(
            uuid=observable.uuid,
            tag=observable.tag,
            time=time,
            value=value,
            aggregation_method=observable.default_aggregation_method,
        )

    @classmethod
    def from_final_bitstrings(
        cls: Type[ResultsType],
        atom_order: collections.abc.Sequence[str],
        total_duration: int,
        final_bitstrings: collections.abc.Mapping[str, int],
    ) -> ResultsType:
        """Wraps a final-time bitstring counter into a Results.

        The counts land under a synthesized BitStrings observable at
        t=1.0; read them back through ``final_bitstrings`` or
        ``get_result("bitstrings", 1.0)``.

        Args:
            atom_order: The qudit ordering of the bitstrings.
            total_duration: The sequence duration (ns).
            final_bitstrings: The counter to store.
        """
        from pulser_tpu_torch.backend.default_observables import BitStrings

        try:
            bitstrings = Counter(final_bitstrings)
        except TypeError:
            raise TypeError(
                "'final_bitstrings' is not a valid bitstrings counter; "
                f"got {final_bitstrings}"
            )

        obs = BitStrings(num_shots=sum(bitstrings.values()))
        # A fixed UUID keeps two instances with equal counts equal
        obs._uuid = uuid.UUID("00000000-0000-0000-0000-000000000000")

        res = cls(
            atom_order=tuple(atom_order), total_duration=total_duration
        )
        res._store(observable=obs, time=1.0, value=bitstrings)
        return res

    # --- Access --------------------------------------------------------

    def __getattr__(self, name: str) -> Any:
        if name in self._tagmap:
            return list(self._results[self._tagmap[name]])
        if name == "bitstring_counts":
            warnings.warn(
                "'bitstring_counts' is an attribute of the deprecated "
                "`SampledResult` class. Please favor accessing the "
                "bitstrings via 'final_bitstrings' instead.",
                category=FutureWarning,
                stacklevel=3,
            )
            return self.final_bitstrings
        if name in _SAMPLED_RESULT_ATTRS:
            raise AttributeError(
                f"{name} is available only in 'SampledResult', which has"
                " been deprecated and is being phased out."
            )
        raise AttributeError(f"{name!r} is not in the results.")

    @property
    def final_bitstrings(self) -> dict[str, int]:
        """The t=1.0 bitstring counts, when stored."""
        try:
            return cast(
                typing.Dict[str, int],
                self.get_result("bitstrings", time=1.0),
            )
        except ValueError:
            raise RuntimeError(
                "The final bitstrings are not available. Please make sure"
                " 'BitStrings()' at relative time t=1.0 is included in the"
                " observables of your emulator backend's configuration"
                " (when possible)."
            )

    @property
    def final_state(self) -> State:
        """The t=1.0 state, when stored."""
        try:
            return cast(State, self.get_result("state", time=1.0))
        except ValueError:
            raise RuntimeError(
                "The final state is not available. Please make sure "
                "'StateResult()' at relative time t=1.0 is included in the"
                " observables of your emulator backend's configuration"
                " (when possible)."
            )

    def get_result_tags(self) -> list[str]:
        """Every stored result tag."""
        return list(self._tagmap.keys())

    def get_result_times(
        self, observable: Observable | str
    ) -> list[float]:
        """The relative times an observable's values were stored at.

        Args:
            observable: The Observable instance, or its tag.
        """
        return list(self._times[self._find_uuid(observable)])

    def get_result(
        self, observable: Observable | str, time: float
    ) -> Any:
        """One stored value, by observable and time.

        Args:
            observable: The Observable instance, or its tag.
            time: The relative time to look up.
        """
        obs_uuid = self._find_uuid(observable)
        try:
            ind = self._times[obs_uuid].index(time)
        except (KeyError, ValueError):
            raise ValueError(
                f"{observable!r} is not available at time {time}."
            )
        return self._results[obs_uuid][ind]

    def get_tagged_results(self) -> dict[str, list[Any]]:
        """Tag -> full value series, for every stored observable."""
        return {
            tag: list(self._results[uuid_])
            for tag, uuid_ in self._tagmap.items()
        }

    def _find_uuid(self, observable: Observable | str) -> uuid.UUID:
        if isinstance(observable, Observable):
            if observable.uuid not in self._results:
                raise ValueError(
                    f"'{observable!r}' has not been stored in the results"
                )
            return observable.uuid
        try:
            return self._tagmap[observable]
        except KeyError:
            raise ValueError(
                f"{observable!r} is not an Observable instance "
                "nor a known observable tag in the results."
            )

    # --- Serialization --------------------------------------------------

    def _to_abstract_repr(self) -> dict:
        return {
            "atom_order": stringify_qubit_ids(self.atom_order),
            "total_duration": self.total_duration,
            "tagmap": {k: str(v) for k, v in self._tagmap.items()},
            "results": {
                str(k): v for k, v in self._results.items()
            },
            "times": {str(k): v for k, v in self._times.items()},
            "aggregation_methods": {
                str(k): v
                for k, v in self._aggregation_methods.items()
            },
        }

    @classmethod
    def _from_abstract_repr(cls, obj: dict) -> Results:
        from pulser_tpu_torch.json.abstract_repr.deserializer import (
            deserialize_complex,
        )

        results = cls(
            atom_order=tuple(obj["atom_order"]),
            total_duration=obj["total_duration"],
        )
        results._tagmap.update(
            (k, uuid.UUID(v)) for k, v in obj["tagmap"].items()
        )
        results._results.update(
            (uuid.UUID(k), deserialize_complex(v))
            for k, v in obj["results"].items()
        )
        results._times.update(
            (uuid.UUID(k), v) for k, v in obj["times"].items()
        )
        results._aggregation_methods.update(
            (uuid.UUID(k), AggregationMethod(v))
            for k, v in obj.get("aggregation_methods", {}).items()
        )
        return results

    def to_abstract_repr(self, skip_validation: bool = False) -> str:
        """Serializes into the abstract-repr JSON string.

        Arrays are flattened to lists (their original type is not
        recoverable).

        Args:
            skip_validation: Skip the schema check on the output.
        """
        abstr_str = json.dumps(
            self._to_abstract_repr(), cls=AbstractReprEncoder
        )
        if not skip_validation:
            validate_abstract_repr(abstr_str, "results")
        return abstr_str

    @classmethod
    def from_abstract_repr(cls, repr: str) -> Results:
        """Rebuilds a Results from its abstract-repr JSON string."""
        validate_abstract_repr(repr, "results")
        return cls._from_abstract_repr(json.loads(repr))

    # --- Aggregation ------------------------------------------------------

    @staticmethod
    def _common_tags(
        results_to_aggregate: typing.Sequence[Results],
    ) -> set[str]:
        """Tags present in every Results; validates the skips."""
        tag_sets = [
            set(x.get_result_tags()) for x in results_to_aggregate
        ]
        common_tags = set.intersection(*tag_sets)
        for results in results_to_aggregate:
            if results._results and not results._aggregation_methods:
                raise NotImplementedError(
                    "You're trying to aggregate results without"
                    " aggregation methods; this is not supported."
                )
            for tag, uid in results._tagmap.items():
                if tag in common_tags:
                    continue
                if (
                    results._aggregation_methods[uid].value
                    not in _SKIP_METHODS
                ):
                    raise ValueError(
                        "You're trying to aggregate incompatible results:"
                        f" result `{tag}` is not present in all results,"
                        " but it's not marked to be skipped."
                    )
        return common_tags

    @staticmethod
    def _check_compatible(
        results_to_aggregate: typing.Sequence[Results],
        common_tags: set[str],
    ) -> None:
        result_0 = results_to_aggregate[0]
        ref_methods = {
            tag: result_0._aggregation_methods[result_0._find_uuid(tag)]
            for tag in common_tags
        }
        for results in results_to_aggregate:
            methods = {
                tag: results._aggregation_methods[
                    results._find_uuid(tag)
                ]
                for tag in common_tags
            }
            if methods != ref_methods:
                raise ValueError(
                    "You're trying to aggregate incompatible results: "
                    "they do not all contain the same aggregation"
                    " functions."
                )
        if any(
            results.atom_order != result_0.atom_order
            for results in results_to_aggregate
        ):
            raise ValueError(
                "You're trying to aggregate incompatible results: "
                "they do not all have the same atom order."
            )
        if any(
            results.total_duration != result_0.total_duration
            for results in results_to_aggregate
        ):
            raise ValueError(
                "You're trying to aggregate incompatible results: "
                "they do not all have the same sequence duration."
            )

    @classmethod
    def aggregate(
        cls,
        results_to_aggregate: typing.Sequence[Results],
        **aggregation_functions: (
            Callable[[Any], Any] | AggregationMethod
        ),
    ) -> Results:
        """Folds several runs' Results into one.

        The per-tag default aggregators average values (BitStrings
        counters are joined); StateResult and EnergyVariance have no
        default and must be overridden or skipped.

        Warning:
            Looking results up by Observable *instance* only works when
            every input stored that exact instance; prefer tags.

        Args:
            results_to_aggregate: The Results to fold together.

        Keyword Args:
            aggregation_functions: Per-tag overrides — a callable over
                the list of values, or an AggregationMethod.

        Returns:
            The combined Results.
        """
        if len(results_to_aggregate) == 0:
            raise ValueError("No results to aggregate.")
        result_0 = results_to_aggregate[0]
        if len(results_to_aggregate) == 1:
            return result_0

        common_tags = cls._common_tags(results_to_aggregate)
        cls._check_compatible(results_to_aggregate, common_tags)

        aggregated = Results(
            atom_order=result_0.atom_order,
            total_duration=result_0.total_duration,
        )
        for tag in common_tags:
            default_method = result_0._aggregation_methods[
                result_0._tagmap[tag]
            ]
            method = aggregation_functions.get(tag, default_method)
            if method in _SKIP_METHODS:
                if method is AggregationMethod.SKIP_WARN:
                    with warnings.catch_warnings():
                        warnings.simplefilter("once")
                        warnings.warn(
                            f"Skipping aggregation of `{tag}`."
                        )
                continue
            fold: Any = (
                AGGREGATOR_MAPPING[method]
                if isinstance(method, AggregationMethod)
                else method
            )
            evaluation_times = result_0.get_result_times(tag)
            if any(
                results.get_result_times(tag) != evaluation_times
                for results in results_to_aggregate
            ):
                raise ValueError(
                    "The Results come from "
                    "incompatible simulations: "
                    f"the times for `{tag}` are not all the same."
                )

            uuids = {
                res._tagmap[tag] for res in results_to_aggregate
            }
            # Keep the shared UUID when there is one
            uid = uuids.pop() if len(uuids) == 1 else uuid.uuid4()

            for t in evaluation_times:
                aggregated._store_raw(
                    uuid=uid,
                    tag=tag,
                    time=t,
                    value=fold(
                        [
                            result.get_result(tag, t)
                            for result in results_to_aggregate
                        ]
                    ),
                    aggregation_method=default_method,
                )
        return aggregated

    def __str__(self) -> str:
        evaluation_times = {
            tag: self._times[uid] for tag, uid in self._tagmap.items()
        }
        cls_name = self.__class__.__name__
        return "\n".join(
            [
                cls_name,
                "-" * len(cls_name),
                f"Stored results: {self.get_result_tags()}",
                f"Evaluation times per result: {evaluation_times}",
                f"Atom order in states and bitstrings: {self.atom_order}",
                f"Total sequence duration: {self.total_duration} ns",
            ]
        )


class ResultsSequence(typing.Sequence[ResultsType]):
    """An immutable, indexable series of Results."""

    _results_seq: tuple[ResultsType, ...]

    @overload
    def __getitem__(self, key: int) -> ResultsType: ...

    @overload
    def __getitem__(self, key: slice) -> tuple[ResultsType, ...]: ...

    def __getitem__(
        self, key: int | slice
    ) -> ResultsType | tuple[ResultsType, ...]:
        return self._results_seq[key]

    def __len__(self) -> int:
        return len(self._results_seq)

    def __iter__(self) -> collections.abc.Iterator[ResultsType]:
        yield from self._results_seq
