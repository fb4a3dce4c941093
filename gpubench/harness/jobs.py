"""Runs one job through the program's public entries.

A traffic file's ``entry`` names the file ``entries/<entry>.py`` whose
``run(runner, job)`` takes a job from its drawn values to its outputs in
host memory, through the program's public API. The runner holds what
every entry shares: the program's package, the configuration's
parametrized sequence and noise model, and the spans.

Each step is a span (host wall time, and a ``record_function`` range
that names it on the trace) so the per-layer metrics can read them.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import numpy as np
import torch

from gpubench.harness import sequence as seqmod


class Spans:
    """Host wall time of named spans, summed per name."""

    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    @contextmanager
    def __call__(self, name: str):
        start = time.perf_counter()
        with torch.profiler.record_function(f"gpubench.{name}"):
            try:
                yield
            finally:
                self.total[name] += time.perf_counter() - start
                self.count[name] += 1

    def reset(self):
        self.total.clear()
        self.count.clear()


class Runner:
    """Runs a cell's jobs on ``device`` (``"cuda"``; ``"cpu"`` in tests)."""

    def __init__(self, cell, device: str, spans: Spans):
        import pulser_tpu_torch as P

        self.P = P
        self.config, self.traffic, self.device = cell.config, cell.traffic, device
        self.spans = spans
        self.entry = cell.module("entries", self.traffic["entry"])
        self.parametrized = seqmod.sequence(
            P, self.config, tuple(self.traffic.get("draws", {}))
        )
        self.noise = seqmod.noise_model(P, self.config)

    def run(self, job: dict) -> dict:
        """Runs ``job`` and returns its outputs, all in host memory."""
        return self.entry.run(self, job)

    def build(self, job: dict):
        """``build(**values)`` of the parametrized sequence, as a span."""
        with self.spans("sequence"):
            return self.parametrized.build(**seqmod.build_values(job["params"]))

    def evaluation_times(self, duration_ns: int) -> np.ndarray:
        """The configuration's count of evenly spaced evaluation times
        (µs) over ``duration_ns``."""
        return np.linspace(0.0, duration_ns * 1e-3, int(self.config["evaluation_times"]))
