"""Reference state of the XY16 run, computed by ``pulser_tpu``.

XY16 is Pulser's own state preparation with the SLM mask in XY mode, at
the flagship statevector size (``chip_smoke.xy16_build``, built here with
``pulser_tpu``): a 4×4 square at 10 µm on ``MockDevice``, the magnetic
field along z (30 G), the ``mw_global`` channel, the SLM mask on the 8
atoms of one checkerboard colour, a 48 ns π pulse
(``ConstantPulse(48, π/0.048, 0, 0)``) that the mask holds off the
masked atoms, then 1000 ns of free exchange, 51 evaluation times on the
nanosecond grid. The JAX package runs its lab-frame sesolve (the XY
flip-flop term with ``(2, 16, 16)`` couplings interpolated by ``int_w``,
1 ns RK4 steps) in double precision on the CPU.

Writes ``tests/goldens/xy16_final.npz``: the final state (complex128),
the evaluation times, the norm and the mean number of ``d`` excitations
(of the normalized state) at each of them, the RK4 step count, the CPU
seconds of the run and the repository commit it ran at. The XY term
conserves the number of ``d`` excitations exactly, but the 1 ns RK4
step (λ_max·h ≈ 0.43) damps each excitation sector by its own amount:
the norm falls to 0.996 and the mean moves by 4e-3 over the free
exchange, in the JAX package as in the port, so the card is held to
these figures, not to exact conservation. ``chip_smoke.py`` holds the PyTorch
port's XY16 run on the card against it.

Run from the repository root (236 CPU s, 79 s wall, at commit 41b6f73)::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/xy_references.py
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

os.environ.setdefault("PULSER_TPU_DISABLE_SHARDING", "1")

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import chip_smoke  # noqa: E402
import pulser_tpu as tpu  # noqa: E402
from pulser_tpu.emulator import TpuEmulator  # noqa: E402
from pulser_tpu.ops import solver as jax_solver  # noqa: E402

OUT = os.path.join(_ROOT, "tests", "goldens", "xy16_final.npz")


def d_excitations(states: np.ndarray) -> np.ndarray:
    """Mean number of ``d`` excitations of each normalized ``(T, 2^16)``
    state (``d`` is basis index 1: a set bit)."""
    probs = np.abs(states) ** 2
    ones = np.array([bin(i).count("1") for i in range(states.shape[1])])
    return (probs @ ones) / probs.sum(axis=1)


def main() -> None:
    commit = subprocess.run(
        ["git", "rev-parse", "--short", "HEAD"], cwd=_ROOT,
        capture_output=True, text=True,
    ).stdout.strip()
    emu = TpuEmulator.from_sequence(
        chip_smoke.xy16_build(tpu),
        evaluation_times=chip_smoke.XY16_EVAL_TIMES,
    )
    t0 = time.process_time()
    w0 = time.perf_counter()
    res = emu.run()
    states = np.stack([np.asarray(s.full()).ravel() for s in res.states])
    final = states[-1]
    cpu_s = time.process_time() - t0
    wall_s = time.perf_counter() - w0
    info = dict(jax_solver.last_solve_info)
    assert info["ip"] is False, info
    np.savez_compressed(
        OUT,
        final=final.astype(np.complex128),
        eval_times=chip_smoke.XY16_EVAL_TIMES,
        norms=np.linalg.norm(states, axis=1),
        d_excitations=d_excitations(states),
        n_steps=info["n_steps"],
        cpu_seconds=cpu_s,
        wall_seconds=wall_s,
        commit=commit,
    )
    print(
        f"XY16: {info['n_steps']} steps, norm {np.linalg.norm(final):.12f},"
        f" {cpu_s:.1f} CPU s ({wall_s:.1f} s wall) at {commit} -> {OUT}"
    )


if __name__ == "__main__":
    main()
