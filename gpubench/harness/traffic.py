"""The one generator of jobs: reads a traffic file's parameters.

A traffic file gives:

- ``entry``: how a job enters the program (``entries/<entry>.py``);
- ``draws``: ``{name: [low, high]}``, each job's value of the
  configuration's ``name`` (2π rad/µs), uniform over the range;
- ``strata``: the draws come from a fixed set of this many points, the
  stratum midpoints of the first draw paired with a rank-1 lattice for
  the others, so that every seed does the same set of work; the seed
  orders each pass over the set and draws each job's seed for numpy's
  global generator (which the Pulser API draws its shots from);
- ``warmup_jobs``: jobs run before the window (from the same set);
- ``check_jobs``: completed jobs the reference checks.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

#: Streams of one ``--seed``: the window's jobs, the warm-up's, the
#: sample the reference checks.
WINDOW, WARMUP, CHECK = 0, 1, 2
#: The lattice generators of the second and later draws.
_LATTICE = (0.6180339887498949, 0.7548776662466927, 0.5698402909980532)


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence([seed, stream])))


def points(traffic: dict) -> list[dict]:
    """The fixed set of parameter points, in 2π rad/µs."""
    draws = traffic.get("draws", {})
    k = int(traffic.get("strata", 1))
    u0 = (np.arange(k) + 0.5) / k
    out = [dict() for _ in range(k)]
    for j, (name, (lo, hi)) in enumerate(sorted(draws.items())):
        u = u0 if j == 0 else (u0 * k * _LATTICE[j - 1] + 0.5) % 1.0
        for i in range(k):
            out[i][name] = float(lo + (hi - lo) * u[i])
    return out


def jobs(traffic: dict, seed: int, stream: int = WINDOW) -> Iterator[dict]:
    """Endless jobs of ``seed``: ``{"index", "params", "np_seed"}``."""
    g = rng(seed, stream)
    pts = points(traffic)
    index = 0
    while True:
        for i in g.permutation(len(pts)):
            yield {
                "index": index,
                "params": dict(pts[i]),
                "np_seed": int(g.integers(0, 2**31)),
            }
            index += 1


def first(traffic: dict, seed: int, count: int, stream: int = WINDOW) -> list[dict]:
    it = jobs(traffic, seed, stream)
    return [next(it) for _ in range(count)]


class CheckSample:
    """The completed jobs the reference checks, drawn from the seed as
    the window goes, so that only they are kept: the last one, and a
    uniform sample of ``check_jobs - 1`` of the others (a reservoir)."""

    def __init__(self, traffic: dict, seed: int):
        self.size = max(int(traffic.get("check_jobs", 1)) - 1, 0)
        self.rng = rng(seed, CHECK)
        self.seen = 0
        self.kept: list = []
        self.last = None

    def offer(self, job: dict, outputs: dict) -> None:
        """Takes a completed job with its outputs."""
        if self.last is not None:
            if len(self.kept) < self.size:
                self.kept.append(self.last)
            elif self.size:
                i = int(self.rng.integers(0, self.seen + 1))
                if i < self.size:
                    self.kept[i] = self.last
            self.seen += 1
        self.last = dict(job, outputs=outputs)

    def picked(self) -> list[dict]:
        """The sampled jobs in the order they ran, each with ``outputs``."""
        tail = [] if self.last is None else [self.last]
        return sorted(self.kept, key=lambda j: j["index"]) + tail
