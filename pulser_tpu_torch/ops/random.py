"""Counter-based threefry2x32 random numbers, bit-exact to ``jax.random``.

The quantum-jump solver draws its jump thresholds and channel selectors
from per-trajectory seeds exactly as the JAX package does
(``pulser_tpu/ops/solver.py::_mcwf_uniforms_dev``), so a seeded run of
the port reproduces the reference trajectory for trajectory. This module
is the only random-number source of that path: it reimplements the
threefry2x32 hash (20 rounds) with JAX's key derivation and counter
layout under ``jax_threefry_partitionable`` (the default from JAX 0.5):

- ``split(key, num)`` hashes the 64-bit counters ``0 .. num-1`` as
  ``(hi, lo)`` word pairs and returns each hash pair as a new key;
- ``random_bits(key, shape)`` hashes the flat C-order index of each
  element the same way and XORs the two output words;
- ``uniform`` keeps the top 23 bits as a float32 mantissa in [1, 2) and
  subtracts 1; in float64 it joins the two hash words into 64 bits
  (first word high) and keeps the top 52.

Keys are ``(..., 2)`` ``uint32`` numpy arrays. Everything is vectorized
over leading key axes, so a whole trajectory batch is drawn in one pass
and shipped to the device in one copy.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(
    k1: np.ndarray, k2: np.ndarray, x1: np.ndarray, x2: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """The threefry2x32 hash of counter words ``(x1, x2)`` under key
    ``(k1, k2)``; all ``uint32`` and broadcast together."""
    k1, k2, x1, x2 = np.broadcast_arrays(
        *(np.asarray(a, dtype=np.uint32) for a in (k1, k2, x1, x2))
    )
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    # uint32 additions wrap by design (0-d arrays would warn)
    with np.errstate(over="ignore"):
        x = [x1 + ks[0], x2 + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r)
                x[1] = x[0] ^ x[1]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def PRNGKey(seed: int | np.ndarray) -> np.ndarray:
    """``jax.random.PRNGKey`` for 32-bit seeds: the key ``(0, seed)``.

    Args:
        seed: One seed or an array of seeds (taken modulo 2^32).

    Returns:
        ``seed.shape + (2,)`` ``uint32`` keys.
    """
    lo = np.asarray(seed).astype(np.int64) & 0xFFFFFFFF
    lo = lo.astype(np.uint32)
    return np.stack([np.zeros_like(lo), lo], axis=-1)


def _counters(shape: tuple[int, ...]) -> tuple[np.ndarray, np.ndarray]:
    """The (hi, lo) words of the flat C-order index of each element."""
    flat = np.arange(int(np.prod(shape, dtype=np.int64)), dtype=np.uint64)
    hi = (flat >> np.uint64(32)).astype(np.uint32).reshape(shape)
    lo = (flat & np.uint64(0xFFFFFFFF)).astype(np.uint32).reshape(shape)
    return hi, lo


def _hash(key: np.ndarray, shape: tuple[int, ...]) -> tuple[np.ndarray, ...]:
    """Both hash words of every counter of ``shape``, per key:
    ``key.shape[:-1] + shape`` each."""
    key = np.asarray(key, dtype=np.uint32)
    lead = key.shape[:-1]
    pad = (slice(None),) * len(lead) + (None,) * len(shape)
    hi, lo = _counters(shape)
    if not shape:  # a scalar draw hashes the counter (0, 0)
        hi = lo = np.zeros((), np.uint32)
    return threefry2x32(key[..., 0][pad], key[..., 1][pad], hi, lo)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split``: ``num`` new keys per key.

    Returns:
        ``key.shape[:-1] + (num, 2)`` ``uint32`` keys.
    """
    b1, b2 = _hash(key, (num,))
    return np.stack([b1, b2], axis=-1)


def random_bits(key: np.ndarray, shape: tuple[int, ...] = ()) -> np.ndarray:
    """32 random bits per element: ``key.shape[:-1] + shape`` ``uint32``."""
    b1, b2 = _hash(key, tuple(shape))
    return b1 ^ b2


def uniform(
    key: np.ndarray, shape: tuple[int, ...] = (), dtype: type = np.float32
) -> np.ndarray:
    """``jax.random.uniform(key, shape, dtype)`` in [0, 1), for float32
    or float64."""
    if np.dtype(dtype) == np.float64:
        b1, b2 = _hash(key, tuple(shape))
        bits = (b1.astype(np.uint64) << np.uint64(32)) | b2.astype(np.uint64)
        mant = (bits >> np.uint64(12)) | np.uint64(0x3FF0000000000000)
        return mant.view(np.float64) - 1.0
    bits = random_bits(key, shape)
    mant = (bits >> np.uint32(9)) | np.uint32(0x3F800000)
    return mant.view(np.float32) - np.float32(1.0)
