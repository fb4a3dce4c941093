"""Both native plan builders are built once, under a lock, at collection.

The JAX package compiles its plan builder lazily into a fixed temporary
name, so two test workers that build it at once race on that name: the
loser's rename fails, the warning it raises fails its test, and the
loader then keeps that worker on the Python fallback, whose step sizes
differ from the native builder's in the last bits. Importing this module
builds and loads both libraries (the JAX package's and the port's) under
an exclusive file lock keyed by the JAX library's path, so the first
worker to collect builds them and every other one finds them; a loader
that gave up while another worker was building is cleared and loaded
again.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import tempfile
import warnings

import numpy as np
import pytest

import pulser_tpu.native as jax_native
import pulser_tpu_torch.native as torch_native
from pulser_tpu.ops import solver as jax_solver
from pulser_tpu_torch.ops import solver as torch_solver

_LOADERS = (jax_native, torch_native)


def _load_both() -> list[str]:
    """Builds (if needed) and loads both libraries under the lock;
    returns the warnings the loaders raised."""
    key = hashlib.sha256(jax_native._so_path().encode()).hexdigest()[:16]
    lock_path = os.path.join(
        tempfile.gettempdir(), f"pulser_tpu_native_{key}.lock"
    )
    with open(lock_path, "w") as lock, warnings.catch_warnings(
        record=True
    ) as caught:
        warnings.simplefilter("always")
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            for mod in _LOADERS:
                mod._load()
                if mod._load_failed and os.path.exists(mod._so_path()):
                    mod._load_failed = False
                    mod._load()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return [str(w.message) for w in caught]


_WARNINGS = _load_both()

needs_gxx = pytest.mark.skipif(
    shutil.which("g++") is None, reason="no g++ to build the libraries"
)


@needs_gxx
@pytest.mark.parametrize("mod", _LOADERS, ids=["pulser_tpu", "port"])
def test_library_is_loaded(mod):
    assert mod._load() is not None
    assert os.path.exists(mod._so_path())


@needs_gxx
@pytest.mark.parametrize("mod", _LOADERS, ids=["pulser_tpu", "port"])
def test_loader_did_not_fall_back(mod):
    assert not mod._load_failed
    assert not [w for w in _WARNINGS if "native runtime" in w], _WARNINGS


@needs_gxx
def test_plan_builders_agree():
    """One plan through both packages' ``build_plan`` (both native):
    every array equal, bit for bit."""
    rng = np.random.default_rng(4)
    n, k = 3, 301
    knots = np.linspace(0.0, 0.3, k)
    amp = rng.uniform(0, 6, (1, n, k)) * np.exp(
        1j * rng.uniform(0, 1, (1, n, k))
    )
    det = rng.uniform(-5, 5, (1, n, k))
    evals = np.array([0.05, 0.1234567, 0.3])
    kw = dict(max_step=1.7e-3, coarsen=True, breakpoints=knots[[50, 200]])
    coeffs = {"amp": amp, "det": det}
    a = jax_solver.build_plan(knots, coeffs, evals, **kw)
    b = torch_solver.build_plan(knots, coeffs, evals, **kw)
    for name in ("dts", "store_idx", "grid", "eval_times", "eval_map",
                 "seg_map", "seg_dts", "eval_det_cum"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), name)
    assert a.stage_arrays.keys() == b.stage_arrays.keys()
    for name in a.stage_arrays:
        np.testing.assert_array_equal(
            a.stage_arrays[name], b.stage_arrays[name]
        )
