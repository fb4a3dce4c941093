"""Reference figures of the PAULI10 run, computed by ``pulser_tpu``.

PAULI10 is the noisy 10-atom configuration of ``bench.py``
(``build_noisy_10atom``: SPAM, doppler, amplitude with laser waist and
dephasing, 100 trajectories of 10 samples) plus Pulser's effective-noise
Pauli channel, ``eff_noise_opers=[X, Y, Z]`` at 0.0125 /µs each (the
Lindblad content of a 0.05 /µs depolarizing rate). Its collapse
operators are not diagonal and not single matrix units, so the quantum-
jump solve runs in the lab frame: the JAX package's vmapped XLA scan
(``mcsolve_rk4_batched``, ``kind == "mcwf_batched"``) and host sampling.

``chip_smoke.py`` holds the PyTorch port's run against the JSON this
script prints (stored as ``tests/goldens/noisy10_pauli_reference.json``):
``TpuEmulator`` after ``np.random.seed(1234)`` with
``evaluation_times="Minimal"``, single precision, on the CPU:

- the RK4 step count of the plan;
- the per-trajectory Rydberg population of each atom at the final time
  (100 × 10), from the states of that same solve;
- the final-time bitstring counts.

Run from the repository root (about ten minutes on a CPU)::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/noisy10_pauli_reference.py
"""

from __future__ import annotations

import json
import os
import sys
import warnings

os.environ.setdefault("PULSER_TPU_DISABLE_SHARDING", "1")

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
import pulser_tpu as tpu  # noqa: E402
from pulser_tpu.emulator import TpuEmulator  # noqa: E402
from pulser_tpu.emulator import simulation as jax_sim  # noqa: E402
from pulser_tpu.ops import solver as jax_solver  # noqa: E402

SEED = 1234
#: The Pauli channel: X, Y, Z at this rate each (1/µs).
PAULI_RATE = 0.0125
PAULIS = (
    [[0, 1], [1, 0]],
    [[0, -1j], [1j, 0]],
    [[1, 0], [0, -1]],
)


def pauli10_noise(runs: int = 100) -> "tpu.NoiseModel":
    """The NOISY10 noise model of ``bench.py`` plus the Pauli channel."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)  # runs=
        return tpu.NoiseModel(
            state_prep_error=0.005,
            p_false_pos=0.01,
            p_false_neg=0.02,
            temperature=50.0,
            amp_sigma=0.02,
            laser_waist=175.0,
            dephasing_rate=0.05,
            eff_noise_rates=[PAULI_RATE] * 3,
            eff_noise_opers=[np.array(p, dtype=complex) for p in PAULIS],
            runs=runs,
            samples_per_run=10,
        )


def main(runs: int = 100) -> None:
    seq, _ = bench.build_noisy_10atom()
    noise = pauli10_noise(runs)
    captured = {}
    solve = jax_sim._solver_mod.mcsolve_rk4_batched

    def record(*args, **kwargs):
        captured["n"] = args[5]
        captured["states"] = np.asarray(solve(*args, **kwargs))
        return captured["states"]

    jax_sim._solver_mod.mcsolve_rk4_batched = record
    try:
        np.random.seed(SEED)
        emu = TpuEmulator.from_sequence(
            seq, noise_model=noise, evaluation_times="Minimal"
        )
        res = emu.run()
    finally:
        jax_sim._solver_mod.mcsolve_rk4_batched = solve
    info = dict(jax_solver.last_solve_info)
    assert info.get("kind") == "mcwf_batched", info

    n = captured["n"]
    probs = np.abs(captured["states"][:, -1].astype(np.complex128)) ** 2
    idx = np.arange(probs.shape[1])
    # Ground-rydberg basis order: qubit q's |r> is bit n-1-q == 0
    ryd = np.stack([((idx >> (n - 1 - q)) & 1) == 0 for q in range(n)])
    pops = probs @ ryd.T.astype(float)  # (B, n)
    print(
        json.dumps(
            {
                "seed": SEED,
                "kind": info["kind"],
                "n_steps": info["n_steps"],
                "n_cops": info["n_cops"],
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
