"""The port's threefry2x32 generator against ``jax.random``, bit for bit.

The quantum-jump path draws its thresholds and channel selectors with
:mod:`pulser_tpu_torch.ops.random`, which must reproduce JAX's keys and
float32 uniforms exactly (the partitionable threefry layout, the
default of the JAX in use) so that seeded runs of the port match
``pulser_tpu`` trajectory for trajectory.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from pulser_tpu.ops import solver as jax_solver

from pulser_tpu_torch.ops import random as prng
from pulser_tpu_torch.ops import solver as torch_solver

torch.set_num_threads(1)

SEEDS = [0, 1, 77, 12345, 2**31 - 1]


def _jax_key(seed: int) -> jax.Array:
    return jax.random.PRNGKey(jnp.asarray(seed, dtype=jnp.uint32))


def test_threefry_partitionable_is_the_jax_default():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_match(seed):
    key = _jax_key(seed)
    assert np.array_equal(prng.PRNGKey(seed), np.asarray(key))
    for num in (1, 2, 3, 5):
        assert np.array_equal(
            prng.split(prng.PRNGKey(seed), num),
            np.asarray(jax.random.split(key, num)),
        )


@pytest.mark.parametrize("shape", [(), (4, 6, 2), (3,), (5, 7)])
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_matches(seed, shape):
    key = jax.random.split(jax.random.split(_jax_key(seed), 1)[0], 3)[2]
    want = np.asarray(jax.random.uniform(key, shape, dtype=jnp.float32))
    got = prng.uniform(np.asarray(key), shape)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got, want)


def test_vectorized_over_keys():
    seeds = np.array([3, 4, 5])
    got = prng.uniform(prng.split(prng.PRNGKey(seeds), 1)[:, 0], (2, 3))
    for i, s in enumerate(seeds):
        key = jax.random.split(_jax_key(int(s)), 1)[0]
        assert np.array_equal(
            got[i],
            np.asarray(jax.random.uniform(key, (2, 3), dtype=jnp.float32)),
        )


@pytest.mark.parametrize("seeds", [[11, 22, 33], [0, 2**31 - 1]])
def test_mcwf_uniforms_match_pulser_tpu(seeds):
    seg_shape = (3, 7)
    r0, us = torch_solver._mcwf_uniforms(seeds, seg_shape)
    r0_j, us_j = jax_solver._mcwf_uniforms(seeds, seg_shape, np.float32)
    assert np.array_equal(r0, np.asarray(r0_j))
    assert np.array_equal(us, np.asarray(us_j))
    assert us.shape == (len(seeds),) + seg_shape + (2,)
