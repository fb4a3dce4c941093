"""Utility functions for bitstring sampling.

Matches the cumsum+searchsorted sampler of the reference
(``pulser-core/pulser/math/multinomial.py:18``), on the global numpy RNG.
"""

from __future__ import annotations

import numpy as np


def multinomial(n_samples: int, probabilities: np.ndarray) -> np.ndarray:
    """Multinomial samples from the distribution given by `probabilities`.

    Unlike ``np.random.multinomial``, this doesn't assert that the
    probabilities sum to 1, and returns the indices of the samples instead
    of aggregated counts. Uses the global numpy RNG for drop-in seeded
    compatibility with the reference.

    Args:
        n_samples: Number of samples to return.
        probabilities: Probability distribution. Must sum to 1.

    Returns:
        Indices of samples with replacement.
    """
    rnd = np.random.rand(n_samples)
    cumsums = np.cumsum(probabilities)
    return np.searchsorted(cumsums, rnd)
