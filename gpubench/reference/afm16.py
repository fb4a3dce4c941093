"""The plain reference of the ``afm16`` cells, and their comparison.

From each checked job's drawn values it builds the pulse samples and the
Hamiltonian again (:mod:`rydberg`), integrates the states on its own RK4
grid in float64, and draws the shots with the job's numpy seed as the
Pulser API does. The program's outputs are only read to be judged.

Numbers compared (each the worst over the checked jobs):

- ``final_infidelity``: 1 − |⟨ψ_ref|ψ⟩|² of the fetched final state;
- ``shots_gap``: the widest distance by which the seeded uniform of a
  shot of ``sample_final_state`` lies outside the reference's cumulative
  probability interval of the outcome the program gave it;
- ``occupation_err``, ``correlation_err``: the largest |Δ| of ⟨n_k⟩ at
  every evaluation time and of ⟨n_i n_j⟩ at the end;
- ``energy_err``: |Δ⟨H⟩| at the end (rad/µs);
- ``bitstrings_gap``: ``shots_gap`` of the ``BitStrings`` observable.

The samplers are inverse CDFs over a fixed order of the outcomes, so the
k-th smallest uniform draws the k-th shot in that order: the shots pair
with their uniforms without the order the program returned them in. A
shot's gap is 0 when its outcome is the reference's; a program whose
probabilities are off by ε in their cumulative sum reads at most ε, and
a shot moved to another outcome reads about that outcome's distance.
Two equal draws are not asked for: a 16-atom state spreads over
thousands of outcomes below 1e-4 each, so the float32 rounding of the
probabilities alone moves hundreds of shots by one outcome.
"""

from __future__ import annotations

import os
from collections import Counter

import numpy as np
import torch

from gpubench.reference import rydberg as R

#: The limits, each between the largest reading of the program on the
#: H100 (over 14 seeds or more, the check jobs of each) and the smallest
#: of the control (this reference in bfloat16) over six or three seeds,
#: with more room above the first; PERF.md §2 gives the readings.
LIMITS = {
    "final_infidelity": 3e-4,  # program ≤ 1.82e-6, control ≥ 6.78e-3
    "shots_gap": 1.5e-3,  # program ≤ 4.03e-4, control ≥ 3.74e-3
    "occupation_err": 2e-3,  # program ≤ 4.69e-4, control ≥ 5.91e-3
    "correlation_err": 2e-3,  # program ≤ 4.84e-4, control ≥ 4.86e-3
    "energy_err": 7e-2,  # program ≤ 1.68e-2, control ≥ 0.182
    "bitstrings_gap": 1.5e-3,  # program ≤ 3.72e-4, control ≥ 4.04e-3
}
#: What a reading that is no number (NaN, inf) reports.
UNREADABLE = 1e300
#: Check jobs per reference pass (a batch of states in one integration).
BATCH = 4
#: The checkout whose ``gpubench/waveforms/`` give the pulses' samples.
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def problem(config: dict, jobs: list) -> R.Problem:
    amps, dets = [], []
    for job in jobs:
        a, d = R.pulse_samples(
            config["pulses"], R.values_of(config, job["params"]), ROOT
        )
        amps.append(a)
        dets.append(d)
    return R.Problem(
        R.register_coords(config["register"]),
        config["constants"]["c6_rad_um6_per_us"], np.array(amps), np.array(dets),
    )


def _shots_draw(probs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The emulator's draw: the outcomes in ascending order, and the
    cumulative probabilities (0 first)."""
    return np.arange(len(probs)), np.concatenate([[0.0], np.cumsum(probs)])


def _bitstrings_draw(probs: np.ndarray, shots: int) -> tuple[np.ndarray, np.ndarray]:
    """The ``BitStrings`` observable's draw: the state vector's order
    (descending outcomes), those of probability above ``1 / (1000
    shots)`` renormalized, the others at zero."""
    order = np.arange(len(probs))[::-1]
    kept = np.where(probs[order] > 1.0 / (1000 * shots), probs[order], 0.0)
    return order, np.concatenate([[0.0], np.cumsum(kept / np.sum(kept))])


def _sample(draw, uniforms: np.ndarray, n: int) -> Counter:
    """Inverse-CDF shots of ``draw`` (the control's, in the program's place)."""
    order, cdf = draw
    pos = np.minimum(np.searchsorted(cdf[1:], uniforms), len(order) - 1)
    return Counter(R.bitstring_labels(order[pos], n))


def _gap(got: Counter, draw, uniforms: np.ndarray) -> float:
    """The widest distance between a shot's uniform and the reference's
    interval of the shot's outcome; 1 where the shots cannot pair."""
    order, cdf = draw
    rank = np.empty(len(order), np.int64)
    rank[order] = np.arange(len(order))
    try:
        codes = np.repeat([int(b, 2) for b in got], list(got.values()))
    except (TypeError, ValueError):
        return 1.0
    if len(codes) != len(uniforms) or not len(codes) or (
        codes.min() < 0 or codes.max() >= len(order)
    ):
        return 1.0
    pos = np.sort(rank[codes])
    u = np.sort(uniforms)
    return float(np.max(np.clip(np.maximum(cdf[pos] - u, u - cdf[pos + 1]), 0.0, None)))


def expected(config: dict, traffic: dict, jobs: list, device="cpu",
             dtype=torch.float64) -> list[dict]:
    """The reference's outputs of ``jobs``, in the program's formats.

    With a lower ``dtype`` this is the control: the reference put in the
    program's place.
    """
    n = len(R.register_coords(config["register"]))
    n_samples = sum(p["duration"] for p in config["pulses"])
    rel = R.evaluation_times(config, n_samples)
    out = []
    for start in range(0, len(jobs), BATCH):
        chunk = jobs[start:start + BATCH]
        prob = problem(config, chunk)
        if traffic["entry"] == "emulator":
            states = R.normalized(R.evolve(prob, rel[-1:], dtype, device))[:, 0]
            for job, psi in zip(chunk, states):
                u = np.random.RandomState(job["np_seed"]).rand(int(traffic["shots"]))
                draw = _shots_draw(np.abs(psi) ** 2)
                out.append({
                    "final_state": psi[::-1].copy(),
                    "shots": _sample(draw, u, n),
                    "shots_draw": (draw, u),
                })
            continue
        times = np.linspace(0.0, n_samples * 1e-3, 101)
        states = R.normalized(R.evolve(prob, times, dtype, device))
        occ = R.occupations(n)
        for i, job in enumerate(chunk):
            probs = np.abs(states[i]) ** 2  # (T, dim)
            fin = probs[-1]
            # H at the end, where every channel is at zero (no σx term)
            _, d_end = prob.coeffs(times[-1:])
            energy = float(fin @ (prob.u_diag - d_end[i, 0] * occ.sum(axis=1)))
            rs = np.random.RandomState(job["np_seed"])
            # Two draws of n uniforms come first: the SPAM configuration of
            # the emulator's noiseless Hamiltonian data, built twice
            rs.uniform(size=n)
            rs.uniform(size=n)
            shots = next(o["num_shots"] for o in traffic["observables"]
                         if o["tag"] == "bitstrings")
            draw, u = _bitstrings_draw(fin, shots), rs.rand(shots)
            out.append({
                "occupation": probs @ occ,
                "correlation_matrix": np.einsum("s,si,sj->ij", fin, occ, occ)[None],
                "energy": np.array([energy]),
                "bitstrings": [_sample(draw, u, n)],
                "bitstrings_draw": (draw, u),
            })
    return out


def compare(config: dict, traffic: dict, jobs: list, ref: list) -> dict:
    """The numbers compared, worst over ``jobs``, each with its limit."""
    worst: dict[str, float] = {}

    def keep(name, value):
        value = float(value)
        if not np.isfinite(value):  # a NaN compares false with any limit
            value = UNREADABLE
        worst[name] = max(worst.get(name, 0.0), value)

    for job, want in zip(jobs, ref):
        got = job["outputs"]
        if "final_state" in want:
            psi = np.asarray(got["final_state"], np.complex128)
            psi = psi / np.linalg.norm(psi)
            keep("final_infidelity",
                 1.0 - abs(np.vdot(want["final_state"], psi)) ** 2)
            keep("shots_gap", _gap(got["shots"], *want["shots_draw"]))
        if "occupation" in want:
            keep("occupation_err", np.max(np.abs(
                np.asarray(got["occupation"]) - want["occupation"])))
            keep("correlation_err", np.max(np.abs(
                np.asarray(got["correlation_matrix"]) - want["correlation_matrix"])))
            keep("energy_err", np.max(np.abs(
                np.asarray(got["energy"]) - want["energy"])))
            keep("bitstrings_gap", _gap(got["bitstrings"][-1], *want["bitstrings_draw"]))
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in worst.items()}
