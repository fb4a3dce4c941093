"""Reference figures of NOISY10 with its trajectories sharded, by ``pulser_tpu``.

``chip_smoke.py``'s SHARD_NOISY10 runs the noisy 10-atom configuration
(``bench.py::build_noisy_10atom``, seed 1234, ``evaluation_times=
"Minimal"``) over two ranks. Under a mesh of more than one device the
JAX package takes its quantum-jump scan, not the row-batched kernel
(``ops/solver.py:2294``), and draws the measurements on the host in
bitstring order from the states that scan returns; the row-batched
kernel draws them on the device in state order. The two draws are equal
in distribution but not shot for shot, so this script prints the JAX
package's figures of the sharded route itself: ``TpuEmulator`` on a mesh
of two virtual CPU devices, single precision. Printed: the trajectory-
averaged Rydberg population of each atom at the final time (from the
states of that solve) and the final-time bitstring counts.

Run from the repository root (a few minutes on a CPU)::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/shard_noisy10_reference.py
"""

from __future__ import annotations

import json
import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=2"
).strip()
os.environ.pop("PULSER_TPU_DISABLE_SHARDING", None)

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
    assert len(jax.devices()) == 2
    seq, noise = bench.build_noisy_10atom()
    captured = {}
    solve = jax_sim._solver_mod.mcsolve_rk4_batched

    def record(*args, **kwargs):
        captured["out"] = solve(*args, **kwargs)
        captured["mesh"] = kwargs.get("mesh")
        return captured["out"]

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
    assert captured["mesh"] is not None and captured["mesh"].size == 2
    n = info["n"]
    probs = np.abs(np.asarray(captured["out"][:, -1], np.complex128)) ** 2
    probs /= probs.sum(axis=1, keepdims=True)
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
