"""Reference figures of the SPD16 run, computed by ``pulser_tpu``.

SPD16 is the 16-atom AFM sweep of ``bench.py`` (``build_afm_sequence``:
a 4x4 square at 6 µm on ``MockDevice``, 252/2700/252 ns, Ω = 2π·2,
δ from −2π·6 to 2π·2) under SPD10's noise (``tools/spd10_reference.py``):
SPAM (prep 0.005, false positive 0.01, false negative 0.02), doppler at
50 µK and amplitude noise (σ 0.02, laser waist 175 µm), built by
``chip_smoke.spd16_sequence`` with the JAX package's namespace:
``chip_smoke.SPD16_RUNS`` (20) trajectories of 50 samples, 1000 shots.
It has no collapse operators, so the trajectories integrate as one
pure-state batch: the JAX package's ``sesolve_rk4_batched`` on its
default route (the vmapped XLA scan over the trajectories' states of
2^16 amplitudes) and one vectorized sampling pass on the host. With 100
trajectories that scan takes over 90 minutes on a CPU, hence 20.

``chip_smoke.py`` holds the PyTorch port's run against the JSON this
script prints (stored as ``tests/goldens/spd16_reference.json``):
``TpuEmulator`` after ``np.random.seed(1234)`` with
``evaluation_times="Minimal"``, single precision, on the CPU:

- the RK4 step count of the plan;
- the Rydberg population of each atom at the final time, per trajectory
  (20 × 16) and averaged over the trajectories, from the renormalized
  states of that same solve;
- the final-time bitstring counts.

Run from the repository root (about twenty minutes on a CPU)::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/spd16_reference.py \\
        > tests/goldens/spd16_reference.json
"""

from __future__ import annotations

import json
import os
import sys

os.environ.setdefault("PULSER_TPU_DISABLE_SHARDING", "1")
os.environ.pop("PULSER_TPU_PALLAS_INTERPRET", None)
os.environ.pop("PULSER_TPU_SESOLVE_PALLAS_BATCHED", None)

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
import pulser_tpu as tpu  # noqa: E402
from pulser_tpu.emulator import TpuEmulator  # noqa: E402
from pulser_tpu.emulator import simulation as jax_sim  # noqa: E402

SEED = 1234


def main() -> None:
    seq, noise = chip_smoke.spd16_sequence(tpu)
    captured = {}
    solve = jax_sim.sesolve_rk4_batched

    def record(*args, **kwargs):
        captured["plans"], captured["n"] = args[1], args[5]
        captured["states"] = np.asarray(solve(*args, **kwargs))
        return captured["states"]

    jax_sim.sesolve_rk4_batched = record
    try:
        np.random.seed(SEED)
        emu = TpuEmulator.from_sequence(
            seq, noise_model=noise, evaluation_times="Minimal"
        )
        assert emu._can_batch_trajectories()
        res = emu.run()
    finally:
        jax_sim.sesolve_rk4_batched = solve

    n = captured["n"]
    probs = np.abs(captured["states"][:, -1].astype(np.complex128)) ** 2
    probs /= probs.sum(axis=1, keepdims=True)  # as run() renormalizes
    idx = np.arange(probs.shape[1])
    # Ground-rydberg basis order: qubit q's |r> is bit n-1-q == 0
    ryd = np.stack([((idx >> (n - 1 - q)) & 1) == 0 for q in range(n)])
    pops = probs @ ryd.T.astype(float)  # (B, n)
    print(
        json.dumps(
            {
                "seed": SEED,
                "kind": "sesolve_batched_xla",
                "n_traj": int(probs.shape[0]),
                "n_steps": int(
                    np.count_nonzero(captured["plans"].plan.seg_dts)
                ),
                "rydberg_populations_mean": [
                    float(p) for p in pops.mean(axis=0)
                ],
                "rydberg_populations": [
                    [float(p) for p in row] for row in pops
                ],
                "final_counts": dict(
                    sorted(res[-1].bitstring_counts.items())
                ),
            }
        )
    )


if __name__ == "__main__":
    main()
