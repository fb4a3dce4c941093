"""Observable result storage, trimmed to what the emulator's results need.

API parity with reference ``pulser-core/pulser/backend/results.py``;
serialization, aggregation and the observable classes are not ported
yet (see ROADMAP.md).
"""

from __future__ import annotations

import collections.abc
import typing
import uuid
from dataclasses import dataclass, field
from typing import Any, TypeVar, overload

ResultsType = TypeVar("ResultsType", bound="Results")


@dataclass(repr=False)
class Results:
    """Time-tagged values, keyed by observable tag.

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
    _tagmap: dict[str, uuid.UUID] = field(init=False, repr=False)

    def __post_init__(self) -> None:
        self._results = {}
        self._times = {}
        self._tagmap = {}

    def _store_raw(
        self, *, uuid: uuid.UUID, tag: str, time: float, value: Any
    ) -> None:
        """Records one observable value at a relative time."""
        stored_times = self._times.setdefault(uuid, [])
        if time in stored_times:
            raise RuntimeError(
                f"A value is already stored for observable '{tag}'"
                f" at time {time}."
            )
        self._tagmap[tag] = uuid
        stored_times.append(time)
        self._results.setdefault(uuid, []).append(value)

    def get_result_tags(self) -> list[str]:
        """Every stored result tag."""
        return list(self._tagmap.keys())

    def get_result(self, tag: str, time: float) -> Any:
        """One stored value, by observable tag and relative time."""
        try:
            obs_uuid = self._tagmap[tag]
            ind = self._times[obs_uuid].index(time)
        except (KeyError, ValueError):
            raise ValueError(f"{tag!r} is not available at time {time}.")
        return self._results[obs_uuid][ind]


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
