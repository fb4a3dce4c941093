"""Per-qubit phase references and usage tracking.

Behavioral parity with reference
``pulser-core/pulser/sequence/_basis_ref.py:22-99``: each qubit carries
a piecewise-constant phase reference (virtual-Z bookkeeping) plus the
last time it was addressed.
"""

from __future__ import annotations

from typing import Generator, Union

import numpy as np

_TWO_PI = 2 * np.pi


def _wrap(phi: float) -> float:
    """Folds a phase into [0, 2π)."""
    return phi % _TWO_PI


class _QubitRef:
    """A qubit's phase reference and last-used time."""

    def __init__(self) -> None:
        self.phase = _PhaseTracker(0)
        self._usage_times: set[int] = {0}

    @property
    def last_used(self) -> int:
        return max(self._usage_times)

    def increment_phase(self, phi: float) -> None:
        self.phase[self.last_used] = self.phase.last_phase + phi

    def update_last_used(self, new_t: int) -> None:
        self._usage_times.add(new_t)

    def truncate(self, t: int) -> None:
        self.phase.truncate(t)
        self._usage_times = {t_ for t_ in self._usage_times if t_ <= t}


class _PhaseTracker:
    """A piecewise-constant phase reference over (integer) time.

    Stored as time-ordered (time, phase) breakpoints; the phase between
    breakpoints is the value at the previous one.
    """

    def __init__(self, initial_phase: float):
        self._steps: list[tuple[int, float]] = [(0, _wrap(initial_phase))]

    @property
    def _times(self) -> list[int]:
        return [t for t, _ in self._steps]

    @property
    def last_time(self) -> int:
        return self._steps[-1][0]

    @property
    def last_phase(self) -> float:
        return self._steps[-1][1]

    def changes(
        self,
        ti: Union[float, int],
        tf: Union[float, int],
        time_scale: float = 1.0,
    ) -> Generator[tuple[float, float], None, None]:
        """Phase changes within ]ti, tf]."""
        lo, hi = np.searchsorted(
            self._times, (ti * time_scale, tf * time_scale), side="right"
        )
        for i in range(lo, hi):
            jump = self._steps[i][1] - self._steps[i - 1][1]
            yield (self._steps[i][0] / time_scale, jump)

    def truncate(self, threshold: int) -> None:
        self._steps = [(t, p) for t, p in self._steps if t <= threshold]

    def __setitem__(self, t: int, phi: float) -> None:
        entry = (t, _wrap(phi))
        times = self._times
        if t in times:
            self._steps[times.index(t)] = entry
        else:
            at = int(np.searchsorted(times, t, side="right"))
            self._steps.insert(at, entry)

    def __getitem__(self, t: int) -> float:
        at = int(np.searchsorted(self._times, t, side="right")) - 1
        return self._steps[at][1]
