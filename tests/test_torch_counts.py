"""The one-pass tally of drawn outcomes (``simulation._counts_of``)
against the per-entry loop it replaces, kept here verbatim as its plain
reference.

Both draw the SPAM flips from numpy's global generator, so each case
compares, from one seed: the Counters of every evaluation time, their
iteration order, the type of every count and the generator's next draw.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest

from pulser_tpu_torch.emulator import simulation as sim
from pulser_tpu_torch.result import _labels_of

SPAM = {"epsilon": 0.01, "epsilon_prime": 0.05}
ERRORS = {
    "none": None,
    "zero": {"epsilon": 0.0, "epsilon_prime": 0.0},
    "spam": SPAM,
}


def _counts_of_per_entry(idx, offs, n_times, width, meas_errors):
    """The per-entry tally as the port had it: one ``np.unique``, label
    pass and ``Counter.update`` for each entry."""
    bit_pos = np.arange(width - 1, -1, -1)
    bits = (idx[:, None] >> bit_pos) & 1
    if meas_errors is not None and (
        meas_errors["epsilon"] != 0.0 or meas_errors["epsilon_prime"] != 0.0
    ):
        flip_probs = np.where(
            bits == 1, meas_errors["epsilon_prime"], meas_errors["epsilon"]
        )
        flips = np.random.uniform(size=bits.shape) < flip_probs
        bits = bits ^ flips
    codes = bits @ (1 << bit_pos)
    total_count = np.array([Counter() for _ in range(n_times)])
    for e in range(len(offs) - 1):
        vals, cnts = np.unique(
            codes[offs[e] : offs[e + 1]], return_counts=True
        )
        total_count[e % n_times].update(
            dict(zip(_labels_of(vals, width), cnts.tolist()))
        )
    return total_count


def _ns(kind: str, n_real: int, n_times: int, g) -> np.ndarray:
    """Shots per entry (realization-major, time-minor): the same for
    every entry, varied with zeros, or ``samples_per_run`` times each
    realization's repetitions, as a merged batch asks."""
    if kind == "equal":
        return np.full(n_real * n_times, 5)
    if kind == "zeros":
        return g.integers(0, 7, size=n_real * n_times)
    reps = g.integers(1, 4, size=n_real)
    return np.repeat(5 * reps, n_times)


def _draws(kind: str, width: int, size: int, g) -> np.ndarray:
    """Outcome indices: a few favoured outcomes with a sparse tail, or
    uniform over the ``2**width`` outcomes."""
    if kind == "uniform":
        return g.integers(0, 2**width, size=size)
    favoured = g.integers(0, 2**width, size=4)
    idx = favoured[g.integers(0, 4, size=size)]
    tail = g.random(size) < 0.2
    idx[tail] = g.integers(0, 2**width, size=int(tail.sum()))
    return idx


def _assert_same(idx, offs, n_times, width, meas_errors, seed=11):
    """The tally and its reference from one seed: equal Counters in the
    same order, Python int counts, the generator at the same point."""
    np.random.seed(seed)
    want = _counts_of_per_entry(idx, offs, n_times, width, meas_errors)
    want_next = np.random.rand()
    np.random.seed(seed)
    got = sim._counts_of(idx, offs, n_times, width, meas_errors)
    assert np.random.rand() == want_next
    assert isinstance(got, np.ndarray) and got.shape == (n_times,)
    for have, ref in zip(got, want):
        assert type(have) is Counter
        assert have == ref
        assert list(have) == list(ref)
        assert all(type(v) is int for v in have.values())
    return got


@pytest.mark.parametrize("draws", ["peaked", "uniform"])
@pytest.mark.parametrize("errors", list(ERRORS))
@pytest.mark.parametrize("ns", ["equal", "zeros", "reps"])
@pytest.mark.parametrize("n_times", [1, 3, 101])
@pytest.mark.parametrize("width", [1, 2, 10, 16, 29])
def test_one_pass_tally_equals_the_per_entry_loop(
    width, n_times, ns, errors, draws
):
    g = np.random.default_rng([width, n_times, len(ns), len(errors)])
    n_real = 4
    offs = np.concatenate(([0], np.cumsum(_ns(ns, n_real, n_times, g))))
    idx = _draws(draws, width, int(offs[-1]), g)
    _assert_same(idx, offs, n_times, width, ERRORS[errors])


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_spd16_shaped_job_tallies_as_the_per_entry_loop(dtype):
    """A job of spd16's shape: 20 realizations at 101 times, 50 shots
    each, peaked over 2^16 outcomes, under Pulser's default SPAM; the
    card's sampler returns int32 indices, the host's int64."""
    g = np.random.default_rng(16)
    offs = np.arange(0, 20 * 101 * 50 + 1, 50)
    idx = _draws("peaked", 16, int(offs[-1]), g).astype(dtype)
    got = _assert_same(idx, offs, 101, 16, SPAM)
    assert sum(sum(c.values()) for c in got) == offs[-1]


@pytest.mark.parametrize("width", [1, 10, 16])
def test_an_index_past_the_last_outcome_keeps_its_low_bits(width):
    """``searchsorted`` can return ``2**width`` for a uniform beyond a
    row's last cumulative weight; the tally keeps its low ``width``
    bits, as the per-entry loop does."""
    g = np.random.default_rng(width)
    offs = np.array([0, 6, 6, 10])
    idx = g.integers(0, 2**width, size=10)
    idx[[0, 7]] = 2**width
    for errors in ERRORS.values():
        _assert_same(idx, offs, 3, width, errors)


def test_widths_above_62_label_through_the_format_fallback():
    """Codes too wide for ``_labels_of``'s bit table take its ``format``
    fallback, in the tally as in the per-entry loop."""
    g = np.random.default_rng(63)
    offs = np.array([0, 4, 9, 12, 12])
    idx = g.integers(0, 2**63 - 1, size=12, dtype=np.int64)
    idx[3] = idx[5] = idx[10]
    for errors in ERRORS.values():
        got = _assert_same(idx, offs, 2, 63, errors)
        assert all(len(label) == 63 for c in got for label in c)


def test_a_job_with_no_draws_gives_empty_counters():
    offs = np.zeros(7, dtype=np.int64)
    got = _assert_same(np.zeros(0, dtype=np.int64), offs, 3, 5, SPAM)
    assert [len(c) for c in got] == [0, 0, 0]
