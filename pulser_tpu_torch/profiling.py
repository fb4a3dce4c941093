"""Phase timing and device tracing hooks.

Port of ``pulser_tpu/profiling.py``. The interesting structure of a run
is host-side phases (trajectory draws, plan building, staging, sampling)
against the device's work, so this module provides:

- :func:`phase` — a context manager accumulating wall-clock per named
  phase into a global registry (:func:`phase_report`), and doubling as
  a ``torch.profiler.record_function`` range so the phases show up on
  the timeline when a trace is active;
- :func:`trace` — a context manager around ``torch.profiler.profile``
  writing a Chrome trace into a directory.

A phase's time is host wall time: a phase around an asynchronous launch
ends when the launch returns, so it does not include the device's time
unless the code inside it waits for the device (a fetch or a
synchronize). Overhead when unused is two ``perf_counter`` calls and
one ``record_function`` range per phase.
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
    "phase",
    "phase_report",
    "reset_phases",
    "trace",
]

_lock = threading.Lock()
_totals: dict[str, float] = defaultdict(float)
_counts: dict[str, int] = defaultdict(int)


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """Times a named phase and marks it on the profiler's timeline."""
    start = time.perf_counter()
    with torch.profiler.record_function(name):
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            with _lock:
                _totals[name] += elapsed
                _counts[name] += 1


def phase_report(reset: bool = False) -> dict[str, dict[str, float]]:
    """Accumulated wall-clock per phase: {name: {total_s, calls}}."""
    with _lock:
        report = {
            name: {
                "total_s": _totals[name],
                "calls": float(_counts[name]),
            }
            for name in _totals
        }
        if reset:
            _totals.clear()
            _counts.clear()
    return report


def reset_phases() -> None:
    """Clears the accumulated phase timings."""
    phase_report(reset=True)


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
