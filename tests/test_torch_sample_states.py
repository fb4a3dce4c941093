"""The shot sampler of the trajectory-batched kets (``kernels.
sample_states``) in its plain PyTorch version, on the CPU, against the
host pass it replaces on the card (``simulation._sample_ket_states``).

Both draw every uniform from numpy's global generator in the same order
(the shots, then the SPAM flips), so the outcome indices, the counts and
the generator's next draw are compared one for one. The card's kernel is
held to this plain version in ``tests/test_torch_kernels_cuda.py``.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest
import torch

import chip_smoke
import pulser_tpu_torch.ops.kernels as K
from pulser_tpu_torch.emulator import simulation as sim
from pulser_tpu_torch.ops.solver import BatchedKets

torch.set_num_threads(1)

SPAM = {"epsilon": 0.01, "epsilon_prime": 0.05}


def _kets(n: int, seed: int) -> tuple[BatchedKets, list[int]]:
    """Random kets (trajectory 0 peaked, zero tails) as the batched
    kernel leaves them, and the evaluation times' indices: five times
    over four segments, two of them reading the same segment."""
    planes, seg_of, _, _ = chip_smoke.random_sample_inputs(n, seed, "cpu")
    return BatchedKets(planes, seg_of.numpy()), [0, 1, 2, 3, 4]


def _both(kets, time_index, renormalize, reverse, ns, n, spam, monkeypatch):
    """The host pass on the fetched states and the plain sampler on the
    kets, each from numpy seed 5: ``(host, plain)`` tuples of (outcome
    indices, counts, the generator's next draw)."""
    drawn = []
    counts_of = sim._counts_of

    def keep(idx, *rest):
        drawn.append(idx.copy())
        return counts_of(idx, *rest)

    monkeypatch.setattr(sim, "_counts_of", keep)
    out = []
    n_times = len(time_index)
    for sample, states in (
        (sim._sample_ket_states, kets.fetch()),
        (sim._sample_batched_kets, kets),
    ):
        np.random.seed(5)
        counts = sample(
            states, renormalize, time_index, reverse, ns, n_times, n, spam
        )
        out.append((drawn[-1], counts, np.random.rand()))
    return out


@pytest.mark.parametrize("spam", [False, True], ids=["no_spam", "spam"])
@pytest.mark.parametrize("renormalize", [False, True], ids=["raw", "renorm"])
@pytest.mark.parametrize("reverse", [False, True], ids=["digital", "gr"])
@pytest.mark.parametrize("n", [10, 12])
def test_plain_sampler_draws_the_host_passes_outcomes(
    n, reverse, renormalize, spam, monkeypatch
):
    """Random float32 states a few percent off their norm and a peaked
    AFM-like state, with zero weights at both ends of each row: the same
    outcome indices, the same counts in the same order, the generator at
    the same draw; a uniform just below 1 draws a positive weight."""
    kets, time_index = _kets(n, 100 + n)
    ns = [40 + e % 5 for e in range(3 * len(time_index))]
    (h_idx, h_counts, h_next), (p_idx, p_counts, p_next) = _both(
        kets, time_index, renormalize, reverse, ns, n,
        SPAM if spam else None, monkeypatch,
    )
    assert np.array_equal(p_idx, h_idx)
    assert [list(c.items()) for c in p_counts] == [
        list(c.items()) for c in h_counts
    ]
    assert p_next == h_next
    assert sum(sum(c.values()) for c in p_counts) == sum(ns)
    # No draw lands on the zero-weight ends of a row
    assert p_idx.min() >= 3 and p_idx.max() < (1 << n) - 3
    if not spam:
        # The peaked state's draws are nearly all one of the Néel states
        neel = {int("01" * (n // 2), 2), int("10" * (n // 2), 2)}
        if reverse:
            neel = {(1 << n) - 1 - i for i in neel}
        first = p_idx[: sum(ns[: len(time_index)])]
        assert np.isin(first, list(neel)).mean() > 0.9


def test_plain_sampler_caps_a_uniform_above_a_rows_rounded_total(
    monkeypatch,
):
    """A state whose host row of cumulative weights ends below 1, and
    uniforms on both sides of that total: the plain sampler draws what
    the host pass draws, the one above the total the row's last outcome
    of positive weight (its last outcomes have none)."""
    n = 10
    g = np.random.default_rng(0)
    for _ in range(200):
        planes = g.gamma(0.3, size=(1, 1, 2, 1 << n)).astype(np.float32)
        planes[..., -3:] = 0.0
        re, im = planes[0, 0].astype(np.float64)
        w = np.abs(re + 1j * im) ** 2  # the host pass's weights
        cum = np.cumsum(w / np.add.accumulate(w)[-1])
        if cum[-1] < 1.0:
            break
    assert cum[-1] < 1.0
    above = (float(cum[-1]) + 1.0) / 2
    rnd = np.concatenate([g.random(7) * float(cum[-1]), [above]])
    monkeypatch.setattr(np.random, "rand", lambda size: rnd.copy())
    kets = BatchedKets(torch.from_numpy(planes), np.array([0]))
    want = sim._sample_ket_states(
        kets.fetch(), False, [0], False, [len(rnd)], 1, n, None
    )[0]
    got = sim._sample_batched_kets(
        kets, False, [0], False, [len(rnd)], 1, n, None
    )[0]
    assert got == want
    assert got[format((1 << n) - 4, f"0{n}b")] >= 1
    assert sum(got.values()) == len(rnd)


def test_plain_sampler_counts_the_indices_it_fetches_and_no_launch():
    """On CPU tensors the wrapper runs the plain version: no launch is
    counted; the route counts one staging, one fetch and the indices'
    bytes."""
    from pulser_tpu_torch import profiling

    kets, time_index = _kets(10, 3)
    ns = [30] * (3 * len(time_index))
    offs = np.concatenate(([0], np.cumsum(ns)))
    profiling.counter_report(reset=True)
    before = K.launches("sample_states")
    idx = kets.draw(
        time_index, offs, np.random.default_rng(1).random(offs[-1]),
        renormalize=True, reverse=True,
    )
    report = profiling.counter_report(reset=True)
    assert K.launches("sample_states") == before
    assert idx.dtype == np.int64 and idx.shape == (offs[-1],)
    assert report["traj.fetched_bytes"] == offs[-1] * 4
    assert report["sync.solver.fetch"] == report["sync.solver.stage"] == 1


def test_plain_sampler_equals_a_searchsorted_of_the_weights():
    """The plain version alone, on one row: its draws are a
    searchsorted of the float64 cumulative weights (no uniform of this
    seed but the last, 1 − 2^-53, lies within 1e-12 of one), capped at
    the last outcome of positive weight."""
    planes, seg_of, offs, u = chip_smoke.random_sample_inputs(11, 9, "cpu")
    got = K.sample_states_reference(
        planes, seg_of, offs, u, renormalize=False, reverse=False
    )
    re, im = planes[1, seg_of[3]].double()
    w = (re * re + im * im).numpy()
    cum = np.cumsum(w / w.sum())
    e = 1 * len(seg_of) + 3
    sl = slice(int(offs[e]), int(offs[e + 1]))
    uu = u[sl].numpy()
    assert np.min(np.abs(cum[:, None] - uu[None, :-1])) > 1e-12
    want = np.minimum(np.searchsorted(cum, uu), np.searchsorted(cum, cum[-1]))
    assert np.array_equal(got[sl].numpy(), want)
    assert Counter(got[sl].tolist()).most_common(1)[0][1] <= 3
