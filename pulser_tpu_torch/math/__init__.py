"""Math and array functions dispatching between numpy and torch.

Upstream Pulser's design (``pulser-core/pulser/math/__init__.py:49-273``):
every function keeps concrete host values in numpy and switches to torch
whenever a tensor flows through.
"""

from __future__ import annotations

from collections.abc import Sequence
from typing import Any

import numpy as np
import scipy.fft
import scipy.spatial.distance
import torch

from pulser_tpu_torch.math.abstract_array import (
    AbstractArray as AbstractArray,
    AbstractArrayLike as AbstractArrayLike,
    TensorLike as TensorLike,
)


def _unary(np_fn: Any, torch_fn: Any) -> Any:
    def fn(a: AbstractArrayLike, /) -> AbstractArray:
        a = AbstractArray(a)
        if a.is_tensor:
            return AbstractArray(torch_fn(a.as_tensor()))
        return AbstractArray(np_fn(a.as_array()))

    fn.__name__ = np_fn.__name__
    fn.__qualname__ = np_fn.__name__
    return fn


exp = _unary(np.exp, torch.exp)
sqrt = _unary(np.sqrt, torch.sqrt)
log2 = _unary(np.log2, torch.log2)
log = _unary(np.log, torch.log)
sin = _unary(np.sin, torch.sin)
cos = _unary(np.cos, torch.cos)
tan = _unary(np.tan, torch.tan)
tanh = _unary(np.tanh, torch.tanh)
ceil = _unary(np.ceil, torch.ceil)
floor = _unary(np.floor, torch.floor)


def pad(
    a: AbstractArrayLike,
    pad_width: tuple | int,
    mode: str = "constant",
    constant_values: tuple | int | float = 0,
) -> AbstractArray:
    """Pads an array (1D), supporting 'constant' and 'edge' modes."""
    a = AbstractArray(a)
    if a.is_tensor:
        t = a.as_tensor()
        before, after = (
            (pad_width, pad_width)
            if isinstance(pad_width, int)
            else tuple(pad_width)
        )
        if mode == "edge":
            parts = [
                t[:1].expand(before),
                t,
                t[-1:].expand(after),
            ]
        else:
            c0, c1 = (
                (constant_values, constant_values)
                if np.isscalar(constant_values)
                else tuple(constant_values)  # type: ignore[arg-type]
            )
            parts = [
                torch.full((before,), c0, dtype=t.dtype, device=t.device),
                t,
                torch.full((after,), c1, dtype=t.dtype, device=t.device),
            ]
        return AbstractArray(torch.cat(parts))
    kwargs = (
        dict(constant_values=constant_values) if mode == "constant" else {}
    )
    return AbstractArray(
        np.pad(a.as_array(), pad_width, mode, **kwargs)  # type: ignore
    )


def fft(a: AbstractArrayLike) -> AbstractArray:
    """Fast Fourier transform."""
    a = AbstractArray(a)
    if a.is_tensor:
        return AbstractArray(torch.fft.fft(a.as_tensor()))
    return AbstractArray(scipy.fft.fft(a.as_array()))


def ifft(a: AbstractArrayLike) -> AbstractArray:
    """Inverse fast Fourier transform."""
    a = AbstractArray(a)
    if a.is_tensor:
        return AbstractArray(torch.fft.ifft(a.as_tensor()))
    return AbstractArray(scipy.fft.ifft(a.as_array()))


def fftfreq(n: int) -> AbstractArray:
    """The FFT sample frequencies for n samples."""
    return AbstractArray(scipy.fft.fftfreq(n))


def round(a: AbstractArrayLike, decimals: int = 0) -> AbstractArray:
    """Round to the given number of decimals."""
    return AbstractArray(a).__round__(decimals)


def mean(a: AbstractArrayLike, axis: int | None = None) -> AbstractArray:
    """Arithmetic mean along the given axis."""
    a = AbstractArray(a)
    if a.is_tensor:
        t = a.as_tensor()
        return AbstractArray(t.mean() if axis is None else t.mean(axis))
    return AbstractArray(np.mean(a.as_array(), axis=axis))


def sum(a: AbstractArrayLike) -> AbstractArray:
    """Sum of all elements."""
    a = AbstractArray(a)
    if a.is_tensor:
        return AbstractArray(torch.sum(a.as_tensor()))
    return AbstractArray(np.sum(a.as_array()))


def cumsum(a: AbstractArrayLike, axis: int = 0) -> AbstractArray:
    """Cumulative sum along an axis."""
    a = AbstractArray(a)
    if a.is_tensor:
        return AbstractArray(torch.cumsum(a.as_tensor(), axis))
    return AbstractArray(np.cumsum(a.as_array(), axis=axis))


def diff(a: AbstractArrayLike) -> AbstractArray:
    """First discrete difference."""
    a = AbstractArray(a)
    if a.is_tensor:
        return AbstractArray(torch.diff(a.as_tensor()))
    return AbstractArray(np.diff(a.as_array()))


def clip(
    a: AbstractArrayLike, a_min: TensorLike, a_max: TensorLike
) -> AbstractArray:
    """Clip values to [a_min, a_max] (bounds may be tensors)."""
    a = AbstractArray(a)
    if a.is_tensor or any(
        isinstance(b, torch.Tensor) for b in (a_min, a_max)
    ):
        t = a.as_tensor()
        lo, hi = (
            torch.as_tensor(b, dtype=t.dtype, device=t.device)
            for b in (a_min, a_max)
        )
        return AbstractArray(torch.clamp(t, lo, hi))
    return AbstractArray(np.clip(a.as_array(), a_min, a_max))


def pdist(a: AbstractArrayLike) -> AbstractArray:
    """Pairwise distances between the rows of a 2D array."""
    a = AbstractArray(a)
    if a.is_tensor:
        return AbstractArray(torch.pdist(a.as_tensor()))
    return AbstractArray(scipy.spatial.distance.pdist(a.as_array()))


def dot(a: AbstractArrayLike, b: AbstractArrayLike) -> AbstractArray:
    """Dot product of two 1D arrays."""
    a, b = map(AbstractArray, (a, b))
    if a.is_tensor or b.is_tensor:
        ta, tb = a.as_tensor(), b.as_tensor()
        dtype = torch.promote_types(ta.dtype, tb.dtype)
        return AbstractArray(torch.dot(ta.to(dtype), tb.to(dtype)))
    return AbstractArray(np.dot(a.as_array(), b.as_array()))


def concatenate(arrs: Sequence[AbstractArrayLike]) -> AbstractArray:
    """Concatenate arrays along the first axis."""
    abst_arrs = tuple(map(AbstractArray, arrs))
    if any(a.is_tensor for a in abst_arrs):
        return AbstractArray(torch.cat([a.as_tensor() for a in abst_arrs]))
    return AbstractArray(np.concatenate([a.as_array() for a in abst_arrs]))


def vstack(arrs: Sequence[AbstractArrayLike]) -> AbstractArray:
    """Stack arrays vertically."""
    abst_arrs = tuple(map(AbstractArray, arrs))
    if any(a.is_tensor for a in abst_arrs):
        return AbstractArray(
            torch.vstack([a.as_tensor() for a in abst_arrs])
        )
    return AbstractArray(np.vstack([a.as_array() for a in abst_arrs]))


def hstack(arrs: Sequence[AbstractArrayLike]) -> AbstractArray:
    """Stack arrays horizontally."""
    abst_arrs = tuple(map(AbstractArray, arrs))
    if any(a.is_tensor for a in abst_arrs):
        return AbstractArray(
            torch.hstack([a.as_tensor() for a in abst_arrs])
        )
    return AbstractArray(np.hstack([a.as_array() for a in abst_arrs]))


def flatten(a: AbstractArrayLike) -> AbstractArray:
    """Flatten to 1D."""
    a = AbstractArray(a)
    if a.is_tensor:
        return AbstractArray(a.as_tensor().flatten())
    return AbstractArray(a.as_array().flatten())
