"""Legacy measurement-result containers.

API parity with the reference ``pulser-core/pulser/result.py`` (the
deprecated ``Result``/``SampledResult`` pair kept for the legacy
emulator pipeline), with the bar plot of the bitstring distribution.
"""

from __future__ import annotations

import collections.abc
import uuid
import warnings
from abc import ABC, abstractmethod
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Type

import numpy as np

import pulser_tpu_torch.backend.results as backend_results
from pulser_tpu_torch.backend.default_observables import BitStrings
from pulser_tpu_torch.math.multinomial import multinomial

__all__ = ["Result", "SampledResult"]


def _labels_of(indices: np.ndarray, width: int) -> list[str]:
    """Basis-state indices -> zero-padded bitstring labels.

    Equal item for item to ``format(int(i), f"0{width}b")``, which it
    falls back to where a bit table of int64 cannot make the labels:
    widths above 62, and indices outside ``[0, 2**width)`` (``format``
    widens the label of ``2**width``, which ``searchsorted`` gives a
    uniform beyond the last cumulative weight).
    """
    idx = np.asarray(indices)
    if width > 62 or not idx.size or idx.min() < 0 or idx.max() >> width:
        return [format(int(i), f"0{width}b") for i in idx]
    shifts = np.arange(width - 1, -1, -1, dtype=np.int64)
    bits = (idx.astype(np.int64).reshape(-1, 1) >> shifts) & 1
    table = (bits + ord("0")).astype(np.uint8)
    return table.view(f"S{width}").ravel().astype(str).tolist()


def _counts_to_weights(counts: dict[str, int], width: int) -> np.ndarray:
    """Normalized weight vector over all 2**width basis states."""
    weights = np.zeros(2**width)
    if counts:
        idx = np.array([int(b, 2) for b in counts], dtype=np.int64)
        vals = np.fromiter(counts.values(), dtype=float, count=len(counts))
        np.add.at(weights, idx, vals)
    total = weights.sum()
    return weights / total if total else weights


def _binomial_sem(p: float, n: int) -> float:
    """Standard error of the mean of a Bernoulli rate estimate."""
    return float(np.sqrt(p * (1 - p) / n))


# A fixed observable UUID makes two SampledResults with equal counts
# compare equal (the auto-generated per-instance UUID would not).
_SHARED_BITSTRINGS_UUID = uuid.UUID(int=0)

_MOVED_TO_BACKEND = {
    "Results": "ResultsSequence",
    "ResultType": "ResultsType",
}


def __getattr__(name: str) -> Any:
    try:
        new_name = _MOVED_TO_BACKEND[name]
    except KeyError:
        raise AttributeError(
            f"Module {__name__!r} has no attribute {name!r}."
        ) from None
    warnings.warn(
        f"The 'pulser.result.{name}' class has been renamed to "
        f"'{new_name}' and moved to 'pulser.backend.results'. "
        f"Importing it as '{name}' from 'pulser.results' is deprecated.",
        DeprecationWarning,
        stacklevel=3,
    )
    return getattr(backend_results, new_name)


def _support(weights: np.ndarray, width: int) -> dict[str, float]:
    """{bitstring: probability} over the nonzero entries only."""
    nz = np.flatnonzero(weights)
    return dict(zip(_labels_of(nz, width), weights[nz].tolist()))


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
        draws = np.asarray(multinomial(n_samples, self._weights()))
        # Each outcome labelled once, in the order of its first draw: the
        # Counter's contents and iteration order are those of counting
        # the label of every draw
        outcomes, first, counts = np.unique(
            draws, return_index=True, return_counts=True
        )
        order = np.argsort(first)
        labels = _labels_of(outcomes[order], self._size)
        return Counter(dict(zip(labels, counts[order].tolist())))

    def get_state(self) -> Any:
        """The underlying quantum state, when one is available."""
        raise NotImplementedError(
            f"`{self.__class__.__name__}.get_state()` is not implemented."
        )

    def plot_histogram(
        self,
        min_rate: float = 0.001,
        max_n_bitstrings: int | None = None,
        show: bool = True,
    ) -> None:
        """Bar-plots the bitstring distribution.

        Args:
            min_rate: Bitstrings rarer than this are left out.
            max_n_bitstrings: Cap on how many bitstrings are shown.
            show: Whether to call `plt.show()` before returning.
        """
        import matplotlib.pyplot as plt

        dist = self.sampling_dist
        order = sorted(dist, key=dist.get, reverse=True)
        kept = [b for b in order[:max_n_bitstrings] if dist[b] >= min_rate]
        plt.bar(kept, [dist[b] for b in kept])
        plt.xticks(rotation="vertical")
        plt.ylabel("Probability")
        if show:
            plt.show()

    def __str__(self) -> str:
        return self.__repr__()

    @classmethod
    def from_final_bitstrings(
        cls: Type[Result],
        atom_order: collections.abc.Sequence[str],
        total_duration: int,
        final_bitstrings: collections.abc.Mapping[str, int],
    ) -> Result:
        """[Not Implemented] Creates a Result from final bitstrings."""
        raise NotImplementedError(
            f"'{cls.__name__}.from_final_bitstrings()' is not implemented."
        )


@dataclass
class SampledResult(Result):
    """A run's outcome, given as measured-bitstring counts.

    Args:
        atom_order: Which atom each bitstring position refers to.
        meas_basis: The measurement basis.
        bitstring_counts: How many times each bitstring came up.
        evaluation_time: The relative sampling time, in [0, 1].
    """

    bitstring_counts: dict[str, int]
    evaluation_time: float = 1.0

    def __post_init__(self) -> None:
        super().__post_init__()
        self.n_samples = sum(self.bitstring_counts.values())
        via_obs = BitStrings(num_shots=self.n_samples)
        via_obs._uuid = _SHARED_BITSTRINGS_UUID
        self._store(
            observable=via_obs,
            time=self.evaluation_time,
            value=Counter(self.bitstring_counts),
        )

    def _weights(self) -> np.ndarray:
        return _counts_to_weights(self.bitstring_counts, self._size)

    @property
    def sampling_errors(self) -> dict[str, float]:
        """Standard error of the mean of each bitstring's rate."""
        return {
            bitstr: _binomial_sem(p, self.n_samples)
            for bitstr, p in self.sampling_dist.items()
        }

    def get_samples(self, n_samples: int) -> Counter[str]:
        """Resamples from the distribution derived from the counts.

        Warning:
            To get the actual samples, read ``bitstring_counts``.
        """
        warnings.warn(
            "'SampledResult.get_samples()' resamples a sampling"
            " distribution derived from the original 'bitstring_counts'.",
            stacklevel=2,
        )
        return super().get_samples(n_samples)
