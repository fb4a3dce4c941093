"""Phase timing, counters and device tracing hooks.

Port of ``pulser_tpu/profiling.py``. The interesting structure of a run
is host-side phases (trajectory draws, plan building, staging, sampling)
against the device's work, so this module provides:

- :class:`phase` — a context manager accumulating wall-clock per named
  phase into a global registry (:func:`phase_report`), and doubling as
  a ``torch.profiler.record_function`` range while a profiler records,
  so the phases show up on its timeline. Phases opened inside a phase on
  the same thread are its children: the report gives each phase's
  total and its self time (the total less what its children cover);
- :func:`count` — named counts in the same registry
  (:func:`counter_report`): the program's synchronizing reads
  (``sync.<layer>.<site>``, one per host call that waits for the card),
  its kernel launches (``kernels.<kernel>.launches``) and the bytes it
  exchanges between ranks (``comm.exchanged_bytes``,
  ``comm.gathered_bytes``);
- :func:`trace` — a context manager around ``torch.profiler.profile``
  writing a Chrome trace into a directory.

A phase's time is host wall time: a phase around an asynchronous launch
ends when the launch returns, so it does not include the device's time
unless the code inside it waits for the device (a fetch or a
synchronize). Overhead with no profiler recording is two
``perf_counter`` calls, a check for a profiler and one lock per phase,
and one lock per count.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Any, Iterator

import torch

__all__ = [
    "count",
    "counter_report",
    "phase",
    "phase_report",
    "reset_phases",
    "trace",
]

_lock = threading.Lock()
_totals: dict[str, float] = defaultdict(float)
_children: dict[str, float] = defaultdict(float)
_counts: dict[str, int] = defaultdict(int)
_counters: dict[str, int] = defaultdict(int)
#: Each thread's open phases, innermost last (``stack``).
_open = threading.local()


class phase:
    """Times a named phase and, while a profiler records, marks it on
    the profiler's timeline: ``with phase(name): ...``."""

    __slots__ = ("_name", "_cell", "_mark", "_start")

    def __init__(self, name: str) -> None:
        self._name = name

    def __enter__(self) -> None:
        # The seconds of the phases closed inside this one
        self._cell = [0.0]
        _open.__dict__.setdefault("stack", []).append(self._cell)
        # A range costs many times the rest of a phase: only when
        # something records it
        self._mark = None
        if torch.autograd._profiler_enabled():
            self._mark = torch.profiler.record_function(self._name)
            self._mark.__enter__()
        self._start = time.perf_counter()

    def __exit__(self, *exc: Any) -> None:
        elapsed = time.perf_counter() - self._start
        if self._mark is not None:
            self._mark.__exit__(*exc)
        stack, cell = _open.stack, self._cell
        # The innermost cell unless a phase was left open across a
        # generator's yield and closed later
        i = len(stack) - 1
        while stack[i] is not cell:
            i -= 1
        del stack[i]
        if i:
            stack[i - 1][0] += elapsed
        with _lock:
            _totals[self._name] += elapsed
            _children[self._name] += cell[0]
            _counts[self._name] += 1


def phase_report(reset: bool = False) -> dict[str, dict[str, float]]:
    """Accumulated wall-clock per phase: {name: {total_s, self_s,
    calls}}; ``self_s`` is ``total_s`` less the time of the phases
    opened inside it on the same thread."""
    with _lock:
        report = {
            name: {
                "total_s": _totals[name],
                "self_s": _totals[name] - _children[name],
                "calls": float(_counts[name]),
            }
            for name in _totals
        }
        if reset:
            _totals.clear()
            _children.clear()
            _counts.clear()
    return report


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name``."""
    with _lock:
        _counters[name] += n


def counter_report(reset: bool = False) -> dict[str, int]:
    """The counters: {name: count}."""
    with _lock:
        report = dict(_counters)
        if reset:
            _counters.clear()
    return report


def reset_phases() -> None:
    """Clears the accumulated phase timings and the counters."""
    phase_report(reset=True)
    counter_report(reset=True)


@contextlib.contextmanager
def trace(log_dir: str, device: Any = None) -> Iterator[None]:
    """Captures a trace of the block and writes it into ``log_dir`` as a
    Chrome trace (``trace.json``).

    Args:
        log_dir: The directory to write into (created if absent).
        device: ``None`` or a CUDA device records the CPU and CUDA
            activities; ``"cpu"`` records the CPU alone.

    Raises:
        RuntimeError: ``device`` is None and no CUDA device is visible
            (as every entry point of the package, it does not move to
            the CPU on its own).
    """
    from pulser_tpu_torch.ops.solver import _resolve_device

    activities = [torch.profiler.ProfilerActivity.CPU]
    if _resolve_device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
