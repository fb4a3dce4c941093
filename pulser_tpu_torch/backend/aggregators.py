"""Aggregation functions for use in `Results.aggregate`.

API parity with reference
``pulser-core/pulser/backend/aggregators.py:80-188``: torch tensors and
numpy arrays stack along a new first axis.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Sequence, TypeVar, cast

import numpy as np
import torch

from pulser_tpu_torch.backend.observable import AggregationMethod

T = TypeVar(
    "T",
    float,
    "list[float]",
    "list[list[float]]",
    complex,
    "list[complex]",
    "list[list[complex]]",
    "torch.Tensor",
    np.ndarray,
)


def _assert_values_not_empty(values: list[T]) -> None:
    """Validates that ``values`` is a non-empty list."""
    if not isinstance(values, list):
        raise ValueError("Need to supply a list of values to process.")
    if values == []:
        raise ValueError("Cannot process 0 samples.")


def _validate_sequence_elements(elt: Sequence) -> None:
    """Validates the nested structure of a sequence element."""
    if elt == []:
        raise ValueError("Cannot process list of empty lists.")
    if not isinstance(elt[0], (float, complex, list)):
        raise ValueError(
            f"Cannot process list of lists of {type(elt[0])}."
        )
    if isinstance(elt[0], list):
        if len(elt[0]) == 0:
            raise ValueError(
                "Cannot process list of matrices with empty columns."
            )
        if not isinstance(elt[0][0], (float, complex)):
            raise ValueError(
                f"Cannot process list of matrices of {type(elt[0][0])}."
            )


def _std_aggregator(values: list[T]) -> T:
    """The standard deviation over the first dim of the given results."""
    _assert_values_not_empty(values)
    elt = values[0]
    if isinstance(elt, torch.Tensor):
        return torch.stack(values).std(0, correction=1)
    if isinstance(elt, np.ndarray):
        return cast(np.ndarray, np.stack(values).std(axis=0, ddof=1))
    if isinstance(elt, float):
        return float(np.std(values, ddof=1))
    if isinstance(elt, complex):
        return complex(np.std(values, ddof=1))
    if not isinstance(elt, Sequence):
        raise ValueError(
            f"Std aggregator cannot process data of type {type(elt)}."
        )
    _validate_sequence_elements(elt)
    return list(np.std(values, axis=0, ddof=1).tolist())


def _mean_aggregator(values: list[T]) -> T:
    """The mean over the first dimension of the given results."""
    _assert_values_not_empty(values)
    elt = values[0]
    if isinstance(elt, torch.Tensor):
        return torch.stack(values).mean(0)
    if isinstance(elt, np.ndarray):
        return cast(np.ndarray, np.stack(values).mean(axis=0))
    if isinstance(elt, float):
        return float(np.mean(values))
    if isinstance(elt, complex):
        return complex(np.mean(values))
    if not isinstance(elt, Sequence):
        raise ValueError(
            f"Mean aggregator cannot process data of type {type(elt)}."
        )
    _validate_sequence_elements(elt)
    return list(np.mean(values, axis=0).tolist())


def _mean_std_aggregator(values: list[T]) -> tuple[T, T]:
    """(mean, std) over the first dimension of the given results."""
    mean = _mean_aggregator(values)
    std = _std_aggregator(values)
    return (mean, std)


def _bag_union_aggregator(values: list[Counter]) -> Counter:
    """Joins a list of Counter objects."""
    return sum(map(Counter, values), start=Counter())


AGGREGATOR_MAPPING: dict[AggregationMethod, Callable] = {
    AggregationMethod.MEAN: _mean_aggregator,
    AggregationMethod.BAG_UNION: _bag_union_aggregator,
    AggregationMethod.MEANSTD: _mean_std_aggregator,
}
