"""Reference figures of the SPD10 run, computed by ``pulser_tpu``.

SPD10 is the noisy 10-atom configuration of ``bench.py``
(``build_noisy_10atom``) with the dephasing taken out and nothing else
changed: SPAM (prep 0.005, false positive 0.01, false negative 0.02),
doppler at 50 µK and amplitude noise (σ 0.02, laser waist 175 µm), 100
trajectories of 10 samples. It has no collapse operators, so the
trajectories integrate as one pure-state batch: the JAX package's
``sesolve_rk4_batched`` on its default route (the vmapped XLA scan) and
one vectorized sampling pass on the host.

``chip_smoke.py`` holds the PyTorch port's run against the JSON this
script prints (stored as ``tests/goldens/spd10_reference.json``):
``TpuEmulator`` after ``np.random.seed(1234)`` with
``evaluation_times="Minimal"``, single precision, on the CPU:

- the RK4 step count of the plan;
- the Rydberg population of each atom at the final time, per trajectory
  (100 × 10) and averaged over the trajectories, from the renormalized
  states of that same solve;
- the final-time bitstring counts.

Run from the repository root (a few minutes on a CPU)::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/spd10_reference.py \\
        > tests/goldens/spd10_reference.json
"""

from __future__ import annotations

import json
import os
import sys
import warnings

os.environ.setdefault("PULSER_TPU_DISABLE_SHARDING", "1")
os.environ.pop("PULSER_TPU_PALLAS_INTERPRET", None)
os.environ.pop("PULSER_TPU_SESOLVE_PALLAS_BATCHED", None)

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
import pulser_tpu as tpu  # noqa: E402
from pulser_tpu.emulator import TpuEmulator  # noqa: E402
from pulser_tpu.emulator import simulation as jax_sim  # noqa: E402

SEED = 1234


def spd10_noise(runs: int = 100) -> "tpu.NoiseModel":
    """The NOISY10 noise model of ``bench.py`` without the dephasing."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)  # runs=
        return tpu.NoiseModel(
            state_prep_error=0.005,
            p_false_pos=0.01,
            p_false_neg=0.02,
            temperature=50.0,
            amp_sigma=0.02,
            laser_waist=175.0,
            runs=runs,
            samples_per_run=10,
        )


def main(runs: int = 100) -> None:
    seq, _ = bench.build_noisy_10atom()
    noise = spd10_noise(runs)
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
