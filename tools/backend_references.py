"""Reference figures of NOISY10 through the backend API, from ``pulser_tpu``.

``chip_smoke.py`` holds the PyTorch port's ``TorchBackendV2`` run of the
noisy 10-atom configuration (``bench.py::build_noisy_10atom``: SPAM +
doppler + amplitude with laser waist + dephasing, 100 trajectories)
against the JSON this script writes: the same configuration through
``TpuBackendV2(seq, config=TpuConfig(...)).run()`` after
``np.random.seed(1234)``, with the observables

- ``Occupation`` at relative times 0.5 and 1.0 (the trajectory mean),
- ``Energy`` and ``StateResult`` at 1.0 (the mean energy, and the
  trajectories' ρ averaged by ``density_matrix_aggregator``),
- ``BitStrings(num_shots=1000)`` at 1.0, with the SPAM readout errors,

on the row-batched quantum-jump kernel (Pallas interpreter on the CPU,
single precision, one device), as ``tools/noisy10_reference.py`` runs
the same configuration through ``TpuEmulator``. The JAX backend builds a
dense 1024 × 1024 Hamiltonian for every evaluation time of every
trajectory, which 10 atoms afford. Written: the occupations, the
energy, the diagonal of the aggregated ρ, its trace, the final counts
and the seconds the run took.

Run from the repository root (a few minutes on a CPU)::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/backend_references.py \\
        > tests/goldens/backend_noisy10_reference.json
"""

from __future__ import annotations

import json
import os
import sys
import time
import warnings

os.environ.setdefault("PULSER_TPU_PALLAS_INTERPRET", "1")
os.environ.setdefault("PULSER_TPU_DISABLE_SHARDING", "1")
os.environ.setdefault("PULSER_TPU_MCWF_ROWS", "1")

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
from pulser_tpu.backend.default_observables import (  # noqa: E402
    BitStrings,
    Energy,
    Occupation,
    StateResult,
)
from pulser_tpu.emulator import TpuBackendV2, TpuConfig  # noqa: E402
from pulser_tpu.ops import solver as jax_solver  # noqa: E402

SEED = 1234
N_TRAJECTORIES = 100
OCCUPATION_TIMES = (0.5, 1.0)
NUM_SHOTS = 1000


def main() -> None:
    seq, noise = bench.build_noisy_10atom()
    with warnings.catch_warnings():
        # The noise model's samples_per_run is ignored by the backend
        warnings.simplefilter("ignore", UserWarning)
        config = TpuConfig(
            observables=[
                Occupation(evaluation_times=list(OCCUPATION_TIMES)),
                Energy(evaluation_times=[1.0]),
                StateResult(evaluation_times=[1.0]),
                BitStrings(evaluation_times=[1.0], num_shots=NUM_SHOTS),
            ],
            noise_model=noise,
            n_trajectories=N_TRAJECTORIES,
        )
    t0 = time.perf_counter()
    np.random.seed(SEED)
    results = TpuBackendV2(seq, config=config).run()
    seconds = time.perf_counter() - t0
    info = dict(jax_solver.last_solve_info)
    assert info.get("kind") == "mcwf_rows_pallas", info
    rho = results.final_state.to_qobj().full()
    print(
        json.dumps(
            {
                "seed": SEED,
                "n_trajectories": N_TRAJECTORIES,
                "n_steps": info["n_steps"],
                "occupation_times": list(OCCUPATION_TIMES),
                "occupation": [
                    [float(x) for x in results.get_result("occupation", t)]
                    for t in OCCUPATION_TIMES
                ],
                "energy": float(results.get_result("energy", 1.0)),
                "rho_trace": float(np.trace(rho).real),
                "rho_diagonal": [float(x) for x in np.diag(rho).real],
                "final_counts": dict(sorted(results.final_bitstrings.items())),
                "cpu_seconds": seconds,
            }
        )
    )


if __name__ == "__main__":
    main()
