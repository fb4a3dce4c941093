"""Reference figures of REGNOISE10, computed by ``pulser_tpu``.

REGNOISE10 is the noisy 10-atom run (``bench.py::build_noisy_10atom``:
SPAM, doppler, amplitude noise with a laser waist, dephasing, 100
trajectories of 10 samples) with register noise added
(``chip_smoke.REGNOISE10_TRAP``: traps of waist 1 µm and depth 150 µK at
50 µK). ``TpuEmulator`` runs it after ``np.random.seed(1234)`` with
``evaluation_times="Minimal"``, on the row-batched quantum-jump kernel
(Pallas interpreter on the CPU, single precision). Written to
``tests/goldens/regnoise10_reference.json``:

- the trajectory-averaged Rydberg population of each atom at the final
  time, from the per-trajectory states of that same solve (same seeds
  and draws, recomputed by ``mcsolve_rk4_batched``);
- the final-time bitstring counts;
- how many distinct interaction diagonals the 100 trajectories carry.

``chip_smoke.py`` holds the PyTorch port's REGNOISE10 run on the card
against it. Run from the repository root (a few minutes on a CPU)::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/regnoise10_reference.py
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

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import chip_smoke  # noqa: E402
import pulser_tpu as tpu  # noqa: E402
from pulser_tpu.emulator import TpuEmulator  # noqa: E402
from pulser_tpu.emulator import simulation as jax_sim  # noqa: E402
from pulser_tpu.ops import solver as jax_solver  # noqa: E402

SEED = 1234
OUT = os.path.join(_ROOT, "tests", "goldens", "regnoise10_reference.json")


def regnoise10_build():
    """REGNOISE10 built with ``pulser_tpu``: ``chip_smoke``'s NOISY10
    sequence and noise, plus its register noise."""
    import warnings

    seq = chip_smoke._sweep_sequence(
        tpu.Register.rectangle(2, 5, spacing=7.0, prefix="q"),
        2 * np.pi * 1.5, -2 * np.pi * 4, 2 * np.pi * 2, 400, 1200, 400,
        P=tpu,
    )
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)  # runs=
        noise = tpu.NoiseModel(
            **chip_smoke._NOISY10_NOISE, **chip_smoke.REGNOISE10_TRAP
        )
    return seq, noise


def main() -> None:
    seq, noise = regnoise10_build()
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
    diag_rows = np.asarray(diags).reshape(len(probs), -1)
    out = {
        "seed": SEED,
        "n_steps": info["n_steps"],
        "noise_types": sorted(noise.noise_types),
        "distinct_diagonals": int(len(np.unique(diag_rows, axis=0))),
        "rydberg_populations": [float(p) for p in pops],
        "final_counts": dict(sorted(res[-1].bitstring_counts.items())),
    }
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps({k: v for k, v in out.items() if k != "final_counts"}))


if __name__ == "__main__":
    main()
