"""The work of one ``spd16`` job's solve, counted from the problem.

Each of the configuration's noise realizations (``noise.runs``) is the
RK4 of ``work/afm16.py``: a state of 2^n complex amplitudes in float32,
the precision the configuration states, on the reference's grid
(``reference/rydberg.py::grid``), four evaluations of ``−i H ψ`` a step
(n σx terms at 4 flops each, the real diagonal at 4) and the stage sums
(3 × 4 + 16). The bytes: the initial state and each realization's
per-atom drive samples (amplitude and detuning, float32) read once, each
realization's state at each evaluation time written once. No kernel is
named and nothing the program reports is read.
"""

from gpubench.reference import rydberg as R

COMPLEX64 = 8
FLOAT32 = 4


def count(config: dict, traffic: dict) -> dict:
    n = len(R.register_coords(config["register"]))
    n_samples = sum(p["duration"] for p in config["pulses"])
    runs = int(config["noise"]["runs"])
    times = R.evaluation_times(config, n_samples)
    steps, _, _ = R.grid(times, n_samples * 1e-3)
    dim = 1 << n
    flops = runs * (4 * (4 * n + 4) + 3 * 4 + 16) * dim * len(steps)
    n_bytes = (
        COMPLEX64 * dim * (1 + runs * len(times))
        + runs * 2 * FLOAT32 * n * (n_samples + 1)
    )
    return {"flops": float(flops), "bytes": float(n_bytes)}
