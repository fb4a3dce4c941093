"""The measurement-result base class of the coherent emulator.

API parity with the reference ``pulser-core/pulser/result.py`` (the
deprecated ``Result`` kept for the legacy emulator pipeline), trimmed to
what :class:`~pulser_tpu_torch.emulator.sim_result.TorchResult` needs.
"""

from __future__ import annotations

import warnings
from abc import ABC, abstractmethod
from collections import Counter
from dataclasses import dataclass, field
from typing import Any

import numpy as np

import pulser_tpu_torch.backend.results as backend_results

__all__ = ["Result"]


def _labels_of(indices: np.ndarray, width: int) -> list[str]:
    """Basis-state indices -> zero-padded bitstring labels."""
    return [format(int(i), f"0{width}b") for i in indices]


def _support(weights: np.ndarray, width: int) -> dict[str, float]:
    """{bitstring: probability} over the nonzero entries only."""
    nz = np.flatnonzero(weights)
    return dict(zip(_labels_of(nz, width), weights[nz].tolist()))


def multinomial(n_samples: int, probabilities: np.ndarray) -> np.ndarray:
    """Indices of ``n_samples`` draws from ``probabilities``.

    Matches the cumsum+searchsorted sampler of the reference
    (``pulser-core/pulser/math/multinomial.py:18``) and uses the global
    numpy RNG, so seeded draws agree with it.
    """
    rnd = np.random.rand(n_samples)
    return np.searchsorted(np.cumsum(probabilities), rnd)


@dataclass
class Result(ABC, backend_results.Results):
    """A single-time observable outcome (deprecated container).

    Subclasses supply a weight vector over the 2**n computational
    basis states via :meth:`_weights`; the distribution views and
    sampling derive from it.
    """

    meas_basis: str
    total_duration: int = field(default=0, init=False, repr=False)

    def __post_init__(self) -> None:
        warnings.warn(
            f"The '{type(self).__name__}' class has been deprecated. "
            "Please prefer storing a result in a 'Results' instance via "
            "the appropriate observable or via "
            "'Results.from_final_bitstrings()' when adequate.",
            DeprecationWarning,
            stacklevel=3,
        )
        super().__post_init__()

    @abstractmethod
    def _weights(self) -> np.ndarray:
        """The sampling rate for every state in an ordered array."""

    @property
    @abstractmethod
    def sampling_errors(self) -> dict[str, float]:
        """The sampling error associated to each bitstring's rate."""

    @property
    def _size(self) -> int:
        return len(self.atom_order)

    @property
    def sampling_dist(self) -> dict[str, float]:
        """Probability per observed bitstring."""
        return _support(self._weights(), self._size)

    def get_samples(self, n_samples: int) -> Counter[str]:
        """Draws bitstrings from this result's distribution.

        Args:
            n_samples: How many draws to make.

        Returns:
            The drawn bitstrings, as a Counter.
        """
        draws = multinomial(n_samples, self._weights())
        return Counter(_labels_of(np.asarray(draws), self._size))

    def get_state(self) -> Any:
        """The underlying quantum state, when one is available."""
        raise NotImplementedError(
            f"`{self.__class__.__name__}.get_state()` is not implemented."
        )

    def __str__(self) -> str:
        return self.__repr__()
