"""Reference figures of the master-equation runs, computed by ``pulser_tpu``.

Three configurations, each on ``MockDevice`` with the pulses of
``bench.py``'s ``build_noisy_10atom`` (a 400 ns amplitude rise to
Ω = 2π·1.5 at δ = −2π·4, a 1200 ns sweep to δ = 2π·2 and a 400 ns fall),
``evaluation_times="Minimal"``, in double precision on the CPU:

- ``deph10_reference.json`` (DEPH10): the 2×5 rectangle at 7 µm under
  ``NoiseModel(dephasing_rate=0.05)`` alone. There is no shot-to-shot
  noise, so ``TpuEmulator.run()`` runs one master-equation solve
  (``mesolve_rk4``) on the coarsened interaction-picture grid.
- ``mesolve10_reference.json`` (MESOLVE10): NOISY10 of ``bench.py``
  (SPAM, doppler, amplitude noise, dephasing, 100 trajectories × 10
  samples) with ``solver=Solver.MESOLVER`` after
  ``np.random.seed(1234)``. The JAX package's own
  ``_lindblad_batch_prep`` builds the trajectory batch as ``run()``
  does; trajectories 0, 1 and 2 are sliced out of it and solved with
  ``mesolve_rk4_batched``.
- ``eff8_reference.json`` (EFF8): the same pulses on a 2×4 rectangle at
  7 µm under the effective-noise Pauli channel (X, Y, Z at 0.0125 /µs
  each) alone. Its collapse operators are not diagonal, so the master
  equation runs in the lab frame. Eight atoms keep this run short on a
  CPU.

Each file holds the RK4 step count, the final ρ diagonal, the Rydberg
population of each atom, 64 fixed off-diagonal elements of the final ρ
(DEPH10 and EFF8), the trace, and the CPU seconds of the solve.
``chip_smoke.py`` holds the PyTorch port's runs on the card against them.

Run from the repository root (on a CPU about 50 minutes each, EFF8
mostly in the XLA compile; MESOLVE10 solves its three trajectories in
three processes; run the three configurations as three commands side by
side)::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/mesolve_references.py \\
        [deph10] [mesolve10] [eff8]
"""

from __future__ import annotations

import json
import os
import sys
import time
import warnings

os.environ.setdefault("PULSER_TPU_DISABLE_SHARDING", "1")
os.environ.pop("PULSER_TPU_PALLAS_INTERPRET", None)

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import bench  # noqa: E402
import pulser_tpu as tpu  # noqa: E402
from pulser_tpu.emulator import TpuEmulator  # noqa: E402
from pulser_tpu.emulator import simulation as jax_sim  # noqa: E402
from pulser_tpu.ops import solver as jax_solver  # noqa: E402

SEED = 1234
GOLDENS = os.path.join(_ROOT, "tests", "goldens")
#: The effective-noise Pauli channel of PAULI10: X, Y, Z in the
#: ground-rydberg basis order, 0.0125 /µs each.
PAULI_RATE = 0.0125
PAULIS = (
    ((0, 1), (1, 0)),
    ((0, -1j), (1j, 0)),
    ((1, 0), (0, -1)),
)
N_OFFDIAG = 64


def sweep_sequence(rows: int, cols: int) -> "tpu.Sequence":
    """``build_noisy_10atom``'s pulses on a ``rows × cols`` rectangle."""
    reg = tpu.Register.rectangle(rows, cols, spacing=7.0, prefix="q")
    seq = tpu.Sequence(reg, tpu.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    om, d0, d1 = 2 * np.pi * 1.5, -2 * np.pi * 4, 2 * np.pi * 2
    ramp = tpu.RampWaveform
    seq.add(tpu.Pulse.ConstantDetuning(ramp(400, 0.0, om), d0, 0.0), "ryd")
    seq.add(tpu.Pulse.ConstantAmplitude(om, ramp(1200, d0, d1), 0.0), "ryd")
    seq.add(tpu.Pulse.ConstantDetuning(ramp(400, om, 0.0), d1, 0.0), "ryd")
    return seq


def rydberg_populations(diag: np.ndarray, n: int) -> list[float]:
    """Per-atom Rydberg populations of a ``(2^n,)`` ρ diagonal (|r> of
    atom q is bit n-1-q == 0)."""
    idx = np.arange(diag.shape[-1])
    ryd = np.stack([((idx >> (n - 1 - q)) & 1) == 0 for q in range(n)])
    return [float(p) for p in ryd.astype(float) @ diag.real]


def offdiag_pairs(dim: int) -> np.ndarray:
    """The 64 fixed ``(row, col)`` pairs, ``row < col``."""
    rng = np.random.default_rng(8)
    rows = rng.integers(0, dim - 1, N_OFFDIAG)
    cols = rows + 1 + rng.integers(0, dim - 1 - rows)
    return np.stack([rows, cols], axis=1)


def rho_figures(rho: np.ndarray, n: int) -> dict:
    """The diagonal, populations, trace and off-diagonal sample of ρ."""
    diag = np.real(np.diag(rho))
    pairs = offdiag_pairs(rho.shape[0])
    return {
        "trace": float(np.trace(rho).real),
        "diagonal": [float(x) for x in diag],
        "rydberg_populations": rydberg_populations(diag, n),
        "offdiagonal": [
            [int(r), int(c), float(rho[r, c].real), float(rho[r, c].imag)]
            for r, c in pairs
        ],
    }


def _single(name: str, seq, noise, description: str) -> dict:
    """One master-equation ``run()`` of ``seq`` under ``noise``."""
    captured: dict = {}
    solve = jax_sim.mesolve_rk4

    def record(*args, **kwargs):
        captured["plan"], captured["ip"] = args[1], kwargs.get("ip")
        t0 = time.process_time()
        out = solve(*args, **kwargs)
        captured["cpu_s"] = time.process_time() - t0
        return out

    jax_sim.mesolve_rk4 = record
    try:
        emu = TpuEmulator.from_sequence(
            seq, noise_model=noise, evaluation_times="Minimal"
        )
        rho = emu.run().get_final_state().full()
    finally:
        jax_sim.mesolve_rk4 = solve
    n = len(seq.register.qubit_ids)
    return {
        "name": name,
        "description": description,
        "kind": "mesolve_rk4_xla_float64",
        "interaction_picture": bool(captured["ip"]),
        "n": n,
        "n_steps": int(np.count_nonzero(captured["plan"].seg_dts)),
        "cpu_seconds": captured["cpu_s"],
        **rho_figures(rho, n),
    }


def deph10() -> dict:
    return _single(
        "DEPH10",
        sweep_sequence(2, 5),
        tpu.NoiseModel(dephasing_rate=0.05),
        "NOISY10's register and pulses under dephasing 0.05 /us alone",
    )


def eff8() -> dict:
    noise = tpu.NoiseModel(
        eff_noise_rates=[PAULI_RATE] * 3,
        eff_noise_opers=[np.array(p, dtype=complex) for p in PAULIS],
    )
    return _single(
        "EFF8",
        sweep_sequence(2, 4),
        noise,
        "the sweep on a 2x4 rectangle at 7 um under the effective-noise"
        " Pauli channel (X, Y, Z at 0.0125 /us) alone",
    )


def _mesolve10_prep():
    """NOISY10 with ``Solver.MESOLVER`` after ``np.random.seed(1234)``, up
    to the batched solve: ``run()``'s order (the gates draw the noiseless
    Hamiltonian, then the batched dissipative prep)."""
    seq, noise = bench.build_noisy_10atom()
    np.random.seed(SEED)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        emu = TpuEmulator.from_sequence(
            seq,
            noise_model=noise,
            evaluation_times="Minimal",
            solver=jax_sim.Solver.MESOLVER,
        )
    assert emu._can_batch_lindblad()
    opts: dict = {}
    emu._validate_options(opts)
    p = emu._lindblad_batch_prep(opts)
    assert not p.mcwf_ip and p.mesolve_ip
    return p


def _mesolve10_trajectory(t: int) -> tuple:
    """Trajectory ``t`` of the batch, sliced out before
    ``mesolve_rk4_batched``: ``(final ρ, CPU seconds of the solve)``."""
    p = _mesolve10_prep()

    def one(leaf):
        if isinstance(leaf, jax_solver.RankFactors):
            return jax_solver.RankFactors(leaf.profiles, leaf.coeffs[t : t + 1])
        return np.asarray(leaf)[t : t + 1]

    plans = jax_solver.BatchedPlan(
        plan=p.plans.plan,
        n_traj=1,
        raw_coeffs={k: one(v) for k, v in p.plans.raw_coeffs.items()},
    )
    t0 = time.process_time()
    rhos = jax_solver.mesolve_rk4_batched(
        np.outer(p.psi0, p.psi0.conj()),
        plans,
        np.asarray(p.batch.diags)[t : t + 1],
        p.pairs,
        p.d,
        p.n,
        p.collapse_mats,
        dtype=np.complex128,
        ip=p.mesolve_ip,
    )
    return rhos[0, -1], time.process_time() - t0


def mesolve10(n_keep: int = 3) -> dict:
    """Trajectories ``0 .. n_keep-1``, one worker process each."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    p = _mesolve10_prep()
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(n_keep, mp_context=ctx) as pool:
        solved = list(pool.map(_mesolve10_trajectory, range(n_keep)))
    return {
        "name": "MESOLVE10",
        "description": "NOISY10 with solver=MESOLVER, seed 1234: the first"
        f" {n_keep} trajectories of the JAX package's batch, each sliced"
        " out before mesolve_rk4_batched",
        "kind": "mesolve_rk4_batched_xla_float64",
        "interaction_picture": bool(p.mesolve_ip),
        "seed": SEED,
        "n": p.n,
        "n_traj_batch": int(p.plans.n_traj),
        "n_steps": int(np.count_nonzero(p.plans.plan.seg_dts)),
        "cpu_seconds": sum(cpu for _, cpu in solved),
        "trajectories": [
            {"index": t, **rho_figures(rho, p.n)}
            for t, (rho, _) in enumerate(solved)
        ],
    }


RUNS = {"deph10": deph10, "mesolve10": mesolve10, "eff8": eff8}


def main(names: list[str]) -> None:
    for name in names or list(RUNS):
        fig = RUNS[name]()
        path = os.path.join(GOLDENS, f"{name}_reference.json")
        with open(path, "w") as f:
            json.dump(fig, f)
            f.write("\n")
        print(f"{name}: {fig['n_steps']} steps, {fig['cpu_seconds']:.1f} CPU s"
              f" -> {os.path.relpath(path, _ROOT)}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
