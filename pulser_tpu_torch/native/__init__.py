"""Native (C++) runtime components, loaded through ctypes.

The shared object is compiled lazily from the checked-in sources on
first use (g++, cached in the package's ``build/`` directory keyed by a
content hash) and every entry point has a pure-Python fallback, so the
package works on hosts without a toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import warnings

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "plan_builder.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "build")

_lib: ctypes.CDLL | None = None
_load_failed = False


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"_plan_builder_{digest}.so")


def _load() -> ctypes.CDLL | None:
    """Compiles (if needed) and loads the native runtime library."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    so = _so_path()
    if not os.path.exists(so):
        tmp = f"{so}.{os.getpid()}.tmp"
        try:
            os.makedirs(_BUILD_DIR, exist_ok=True)
            subprocess.run(
                [
                    "g++",
                    "-O3",
                    "-shared",
                    "-fPIC",
                    "-std=c++17",
                    _SRC,
                    "-o",
                    tmp,
                ],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, so)
        except (OSError, subprocess.CalledProcessError) as e:
            _load_failed = True
            warnings.warn(
                "Could not build the native runtime library;"
                f" falling back to the Python implementation ({e}).",
                stacklevel=2,
            )
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        _load_failed = True
        return None

    c_double_p = ctypes.POINTER(ctypes.c_double)
    c_int32_p = ctypes.POINTER(ctypes.c_int32)
    lib.pt_grid_capacity.restype = ctypes.c_int64
    lib.pt_grid_capacity.argtypes = [
        c_double_p,
        ctypes.c_int64,
        c_double_p,
        ctypes.c_int64,
        ctypes.c_double,
    ]
    lib.pt_build_grid.restype = ctypes.c_int64
    lib.pt_build_grid.argtypes = [
        c_double_p,
        ctypes.c_int64,
        c_double_p,
        ctypes.c_int64,
        ctypes.c_double,
        c_double_p,
        ctypes.c_int64,
    ]
    lib.pt_store_indices.restype = ctypes.c_int64
    lib.pt_store_indices.argtypes = [
        c_double_p,
        ctypes.c_int64,
        c_double_p,
        ctypes.c_int64,
        c_int32_p,
    ]
    lib.pt_merge_eval_times.restype = ctypes.c_int64
    lib.pt_merge_eval_times.argtypes = [
        c_double_p,
        ctypes.c_int64,
        ctypes.c_double,
        c_double_p,
        c_int32_p,
    ]
    _lib = lib
    return _lib


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def merge_eval_times(
    eval_times: np.ndarray, tol: float = 1e-9
) -> tuple[np.ndarray, np.ndarray] | None:
    """Native near-duplicate merge; None when unavailable."""
    lib = _load()
    if lib is None:
        return None
    evals = np.ascontiguousarray(eval_times, dtype=np.float64)
    uniq = np.empty_like(evals)
    emap = np.empty(len(evals), dtype=np.int32)
    n = lib.pt_merge_eval_times(
        _dptr(evals), len(evals), tol, _dptr(uniq), _iptr(emap)
    )
    return uniq[:n].copy(), emap


def build_grid(
    knots: np.ndarray, eval_times: np.ndarray, max_step: float
) -> tuple[np.ndarray, np.ndarray] | None:
    """Native integration-grid + store-index construction.

    Args:
        knots: Ascending coefficient sample times.
        eval_times: Unique ascending evaluation times (already merged).
        max_step: Maximum step size; longer intervals are subdivided.

    Returns:
        ``(grid, store_idx)`` or ``None`` when the native library is
        unavailable (callers fall back to the Python implementation).
    """
    lib = _load()
    if lib is None:
        return None
    k = np.ascontiguousarray(knots, dtype=np.float64)
    e = np.ascontiguousarray(eval_times, dtype=np.float64)
    cap = lib.pt_grid_capacity(
        _dptr(k), len(k), _dptr(e), len(e), float(max_step)
    )
    grid = np.empty(int(cap), dtype=np.float64)
    n = lib.pt_build_grid(
        _dptr(k),
        len(k),
        _dptr(e),
        len(e),
        float(max_step),
        _dptr(grid),
        int(cap),
    )
    if n < 0:
        return None
    grid = grid[:n].copy()
    store_idx = np.empty(max(n - 1, 0), dtype=np.int32)
    rc = lib.pt_store_indices(
        _dptr(grid), n, _dptr(e), len(e), _iptr(store_idx)
    )
    if rc != 0:
        return None
    return grid, store_idx
