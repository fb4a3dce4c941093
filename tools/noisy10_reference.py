"""Reference figures of the noisy 10-atom run, computed by ``pulser_tpu``.

``chip_smoke.py`` holds the PyTorch port's noisy main path against the
numbers this script prints: the BASELINE's noisy configuration
(``bench.py::build_noisy_10atom``: SPAM + doppler + amplitude with laser
waist + dephasing, 100 trajectories, 10 samples per run), run by
``TpuEmulator`` after ``np.random.seed(1234)`` with
``evaluation_times="Minimal"``, on the row-batched quantum-jump kernel
(Pallas interpreter on the CPU, single precision). Printed:

- the trajectory-averaged Rydberg population of each atom at the final
  time, from the per-trajectory states of that same solve (same seeds
  and draws, recomputed by ``mcsolve_rk4_batched``);
- the final-time bitstring counts.

Run from the repository root (takes a few minutes on a CPU)::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/noisy10_reference.py
"""

from __future__ import annotations

import json
import os
import sys

os.environ.setdefault("PULSER_TPU_PALLAS_INTERPRET", "1")
os.environ.setdefault("PULSER_TPU_DISABLE_SHARDING", "1")
os.environ.setdefault("PULSER_TPU_MCWF_ROWS", "1")

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
from pulser_tpu.emulator import TpuEmulator  # noqa: E402
from pulser_tpu.emulator import simulation as jax_sim  # noqa: E402
from pulser_tpu.ops import solver as jax_solver  # noqa: E402

SEED = 1234


def main() -> None:
    seq, noise = bench.build_noisy_10atom()
    captured = {}
    fused = jax_sim._solver_mod.mcsolve_rows_codes

    def record(*args, **kwargs):
        captured["args"], captured["kwargs"] = args, kwargs
        return fused(*args, **kwargs)

    jax_sim._solver_mod.mcsolve_rows_codes = record
    try:
        np.random.seed(SEED)
        emu = TpuEmulator.from_sequence(
            seq, noise_model=noise, evaluation_times="Minimal"
        )
        res = emu.run()
    finally:
        jax_sim._solver_mod.mcsolve_rows_codes = fused
    info = dict(jax_solver.last_solve_info)
    assert info.get("kind") == "mcwf_rows_pallas", info

    psi0, plans, diags, pairs, d, n, cops, seeds, _ = captured["args"]
    kw = {
        k: v for k, v in captured["kwargs"].items() if k in ("dtype", "ip")
    }
    states = jax_solver.mcsolve_rk4_batched(
        psi0, plans, diags, pairs, d, n, cops, seeds, mesh=None, **kw
    )  # (B, n_eval, dim)
    probs = np.abs(np.asarray(states[:, -1], np.complex128)) ** 2
    idx = np.arange(probs.shape[1])
    # Ground-rydberg basis order: qubit q's |r> is bit n-1-q == 0
    ryd = np.stack([((idx >> (n - 1 - q)) & 1) == 0 for q in range(n)])
    pops = (probs @ ryd.T.astype(float)).mean(axis=0)
    print(
        json.dumps(
            {
                "seed": SEED,
                "n_steps": info["n_steps"],
                "rydberg_populations": [float(p) for p in pops],
                "final_counts": dict(
                    sorted(res[-1].bitstring_counts.items())
                ),
            }
        )
    )


if __name__ == "__main__":
    main()
