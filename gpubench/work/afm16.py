"""The work of one ``afm16`` job's solve, counted from the problem.

Classic RK4 on the reference's grid (``reference/rydberg.py::grid``:
every nanosecond sample and every evaluation time) of a state of 2^n
complex amplitudes in float32, the precision the configuration states.
Per amplitude and step, four evaluations of ``−i H ψ`` (n σx terms at 4
flops each, the real diagonal at 4) and the stage sums (3 × 4 + 16).
The bytes: the initial state and the drive samples read once, the state
at each evaluation time written once. No kernel is named and nothing the
program reports is read.
"""

from gpubench.reference import rydberg as R

COMPLEX64 = 8


def count(config: dict, traffic: dict) -> dict:
    n = len(R.register_coords(config["register"]))
    n_samples = sum(p["duration"] for p in config["pulses"])
    times = R.evaluation_times(config, n_samples)
    steps, _, _ = R.grid(times, n_samples * 1e-3)
    dim = 1 << n
    flops = (4 * (4 * n + 4) + 3 * 4 + 16) * dim * len(steps)
    n_bytes = COMPLEX64 * dim * (1 + len(times)) + 2 * 4 * (n_samples + 1)
    return {"flops": float(flops), "bytes": float(n_bytes)}
