"""Reference figures of the quantum-jump scans, computed by ``pulser_tpu``.

Two configurations on ``bench.py``'s ``build_noisy_10atom`` sequence (a
2×5 rectangle at 7 µm on ``MockDevice``, a 400 ns amplitude rise to
Ω = 2π·1.5 at δ = −2π·4, a 1200 ns sweep to δ = 2π·2 and a 400 ns fall),
``evaluation_times="Minimal"``, after ``np.random.seed(1234)``, in single
precision on the CPU (the threefry uniforms are then float32, the draws
of the port's float32 run on the card):

- ``relax10_reference.json`` (RELAX10): NOISY10's noise (SPAM, doppler,
  amplitude with laser waist, dephasing at 0.05 /µs; 100 trajectories of
  10 samples) plus relaxation at 0.1 /µs. Relaxation is a single matrix
  unit, so the quantum-jump batch runs the JAX package's vmapped scan in
  the interaction picture (``mcsolve_rk4_batched``, ``kind ==
  "mcwf_batched"``) and samples on the host. The file holds the RK4 step
  count, the per-trajectory final Rydberg population of each atom
  (100 × 10) and the final-time bitstring counts.
- ``mcdepol10_reference.json`` (MCDEPOL10): the same pulses under
  ``NoiseModel(depolarizing_rate=0.05)`` alone with
  ``solver=Solver.MCSOLVER`` and ``n_trajectories=100``: one serial
  ``mcsolve_rk4`` call in the lab frame whose 100 trajectories average
  into the ``(2, 1024, 1024)`` density matrices. The file holds the RK4
  step count, the final ρ's Rydberg populations, diagonal and trace.

Each file also holds the CPU seconds of the run and the repository
commit it ran at. ``chip_smoke.py`` holds the PyTorch port's runs on the
card against them.

Run from the repository root, one configuration per process (RELAX10
170 CPU s, 122 s wall; MCDEPOL10 321 CPU s, 140 s wall; at commit
41b6f73)::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/mcwf_references.py \\
        [relax10] [mcdepol10]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import warnings

os.environ.setdefault("PULSER_TPU_DISABLE_SHARDING", "1")
os.environ.pop("PULSER_TPU_PALLAS_INTERPRET", None)

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import bench  # noqa: E402
import pulser_tpu as tpu  # noqa: E402
from pulser_tpu.emulator import TpuEmulator  # noqa: E402
from pulser_tpu.emulator import simulation as jax_sim  # noqa: E402
from pulser_tpu.emulator.simulation import Solver  # noqa: E402
from pulser_tpu.ops import solver as jax_solver  # noqa: E402

SEED = 1234
GOLDENS = os.path.join(_ROOT, "tests", "goldens")


def _rydberg_populations(probs: np.ndarray, n: int) -> np.ndarray:
    """``(B, n)`` Rydberg populations of ``(B, 2^n)`` probabilities in the
    ground-rydberg order (qubit q's |r> is bit n-1-q == 0)."""
    idx = np.arange(probs.shape[1])
    ryd = np.stack([((idx >> (n - 1 - q)) & 1) == 0 for q in range(n)])
    return probs @ ryd.T.astype(float)


def relax10() -> dict:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)  # runs=
        noise = tpu.NoiseModel(
            state_prep_error=0.005,
            p_false_pos=0.01,
            p_false_neg=0.02,
            temperature=50.0,
            amp_sigma=0.02,
            laser_waist=175.0,
            dephasing_rate=0.05,
            relaxation_rate=0.1,
            runs=100,
            samples_per_run=10,
        )
    seq, _ = bench.build_noisy_10atom()
    captured = {}
    solve = jax_sim._solver_mod.mcsolve_rk4_batched

    def record(*args, **kwargs):
        captured["n"], captured["ip"] = args[5], kwargs.get("ip")
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
    assert info.get("kind") == "mcwf_batched" and captured["ip"], info
    probs = np.abs(captured["states"][:, -1].astype(np.complex128)) ** 2
    pops = _rydberg_populations(probs, captured["n"])
    return {
        "seed": SEED,
        "kind": info["kind"],
        "interaction_picture": True,
        "n_steps": info["n_steps"],
        "n_cops": info["n_cops"],
        "rydberg_populations": [[float(p) for p in row] for row in pops],
        "final_counts": dict(sorted(res[-1].bitstring_counts.items())),
    }


def mcdepol10() -> dict:
    seq, _ = bench.build_noisy_10atom()
    np.random.seed(SEED)
    emu = TpuEmulator.from_sequence(
        seq,
        noise_model=tpu.NoiseModel(depolarizing_rate=0.05),
        evaluation_times="Minimal",
        solver=Solver.MCSOLVER,
        n_trajectories=100,
    )
    rho = np.asarray(emu.run().get_final_state().full(), np.complex128)
    n = 10
    diag = np.real(np.diag(rho))
    return {
        "seed": SEED,
        "n": n,
        "ntraj": 100,
        "interaction_picture": False,
        "n_steps": int(np.count_nonzero(emu._plan_cache[1].seg_dts)),
        "kind": "mcsolve_rk4",
        "trace": [float(np.trace(rho).real), float(np.trace(rho).imag)],
        "rydberg_populations": [
            float(p) for p in _rydberg_populations(diag[None], n)[0]
        ],
        "diagonal": [float(x) for x in diag],
    }


CONFIGS = {"relax10": relax10, "mcdepol10": mcdepol10}


def main(names: list[str]) -> None:
    commit = subprocess.run(
        ["git", "rev-parse", "--short", "HEAD"], cwd=_ROOT,
        capture_output=True, text=True,
    ).stdout.strip()
    for name in names or list(CONFIGS):
        t0 = time.process_time()
        w0 = time.perf_counter()
        ref = CONFIGS[name]()
        ref["cpu_seconds"] = time.process_time() - t0
        ref["wall_seconds"] = time.perf_counter() - w0
        ref["commit"] = commit
        path = os.path.join(GOLDENS, f"{name}_reference.json")
        with open(path, "w") as f:
            json.dump(ref, f)
        print(
            f"{name}: {ref['n_steps']} steps, {ref['cpu_seconds']:.1f} CPU s"
            f" ({ref['wall_seconds']:.1f} s wall) at {commit} -> {path}"
        )


if __name__ == "__main__":
    main(sys.argv[1:])
