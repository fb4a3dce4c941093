"""The plain reference of the ``spd16`` cell, and its comparison.

A job is the AFM sweep of ``afm16`` under Pulser's shot-to-shot noise
(SPAM, doppler, amplitude): ``runs`` noise realizations, each a pure
state, and ``samples_per_run`` shots of each at every evaluation time,
merged into one count a time. From each checked job's numpy seed this
module replays the Pulser emulator API's draws from numpy's global
generator, in the order the program documents:

1. each realization's noise, from the published model
   (``pulser.NoiseModel``): the atoms that state preparation leaves
   undriven (one uniform an atom, below ``state_prep_error``); a doppler
   detuning an atom, normal of standard deviation ``k_eff √(k_B T / m)``;
   one amplitude factor, ``max(0, N(1, amp_sigma))``;
2. the noiseless Hamiltonian's draw (one uniform an atom);
3. one uniform for each measurement sample, realization-major and
   time-minor;
4. one flip uniform for each bit of each sample: an atom measured in
   ``r`` reads ``g`` below ``p_false_neg``, one in ``g`` reads ``r`` below
   ``p_false_pos``.

It integrates the realizations as one batch of states in float64 on its
own RK4 grid (:func:`rydberg.grid`), each atom with its own drive: atom
``k`` of a realization sees ``Ω_k(t) = a · e^{−(x_k/w)²} · Ω(t)`` (the
amplitude factor, the Gaussian beam's profile at the atom's distance
from the beam's axis, the y axis through the array's centre, which
Pulser's global beam follows) and ``δ_k(t) = δ(t) + d_k`` while a pulse
runs; an undriven atom has no drive, no detuning and no interaction, and
stays in ``g``. The program's outputs are only read to be judged.

Number compared (the worst over the evaluation times and checked jobs):

- ``counts_gap``: the smallest window w of cumulative probability such
  that the program's shots at a time can be paired one to one with the
  replayed draws (realization, uniform, flip uniforms), each shot being
  the flipped outcome of an outcome whose interval of the reference's
  cumulative distribution (the realization's, in bitstring order) lies
  within w of the draw's uniform. The shots merge the realizations, so
  afm16's pairing of sorted shots with sorted uniforms does not apply;
  the pairing is a bipartite matching, and w its bottleneck, found by
  bisection over the candidate pairs' distances. Shots that no pairing
  places read 1.

A program whose cumulative probabilities are off by ε reads at most ε;
a shot moved to another outcome reads about that outcome's distance.
Equal shots are not asked for: the float32 rounding of 2^16
probabilities alone moves shots by one outcome (see ``afm16.py``).
"""

from __future__ import annotations

import math
import os
from collections import Counter

import numpy as np
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import maximum_flow

from gpubench.reference import rydberg as R

# Float64 matrix products stay float64; the control's bfloat16 too
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: The limit, between the largest reading of the program on the H100
#: (36 runs over 24 seeds, the check jobs of each) and the smallest of the
#: control (this reference in bfloat16) over four seeds, with more room
#: above the first; PERF.md §2 gives the readings.
LIMITS = {
    "counts_gap": 5e-3,  # program ≤ 7.34e-4, control ≥ 1.86e-2
}
#: What a reading that is no number (NaN, inf) reports.
UNREADABLE = 1e300
#: Pulser's constants of the doppler width: the effective wave number
#: (µm⁻¹), Boltzmann's constant (J/K) and the atom's mass (kg, 87Rb).
KEFF = 8.7
KB = 1.38e-23
MASS = 1.45e-25
#: The checkout whose ``gpubench/waveforms/`` give the pulses' samples.
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# -- the replayed draws ------------------------------------------------------


def doppler_sigma(temperature_uk: float) -> float:
    """The doppler detuning's standard deviation (rad/µs) at a
    temperature in µK."""
    return KEFF * math.sqrt(KB * temperature_uk * 1e-6 / MASS)


def realizations(noise: dict, n: int, rs: np.random.RandomState) -> dict:
    """Each realization's noise, drawn from ``rs`` as the API draws it:
    ``undriven`` (runs, n) bool, ``doppler`` (runs, n) rad/µs,
    ``amplitude`` (runs,)."""
    runs = int(noise["runs"])
    undriven = np.zeros((runs, n), bool)
    doppler = np.zeros((runs, n))
    amplitude = np.ones(runs)
    sigma = doppler_sigma(float(noise["temperature"]))
    for r in range(runs):
        if noise.get("state_prep_error", 0.0) > 0:
            undriven[r] = rs.uniform(size=n) < noise["state_prep_error"]
        doppler[r] = rs.normal(0.0, sigma, size=n)
        amplitude[r] = max(0.0, rs.normal(1.0, noise.get("amp_sigma", 0.0)))
    return {"undriven": undriven, "doppler": doppler, "amplitude": amplitude}


def draws(config: dict, n_times: int, np_seed: int) -> dict:
    """Every draw of a job from its numpy seed, in the API's order:
    the realizations, the noiseless Hamiltonian's uniforms, the
    samples' uniforms ``u`` (runs, times, samples) and the flip uniforms
    ``v`` (runs, times, samples, n)."""
    noise = config["noise"]
    n = len(R.register_coords(config["register"]))
    runs, spr = int(noise["runs"]), int(noise["samples_per_run"])
    rs = np.random.RandomState(np_seed)
    out = realizations(noise, n, rs)
    rs.uniform(size=n)
    out["u"] = rs.rand(runs * n_times * spr).reshape(runs, n_times, spr)
    out["v"] = rs.uniform(size=(runs * n_times * spr, n)).reshape(
        runs, n_times, spr, n
    )
    return out


def beam_profile(coords: np.ndarray, waist: float | None) -> np.ndarray:
    """``exp(−(r/w)²)`` of each atom, r its distance from the y axis."""
    if waist is None:
        return np.ones(len(coords))
    return np.exp(-(coords[:, 0] ** 2) / waist**2)


# -- the integration ---------------------------------------------------------


def interaction_diags(coords: np.ndarray, c6: float, driven: np.ndarray) -> np.ndarray:
    """``Σ_{i<j} C6 / R_ij^6 n_i n_j`` over each realization's driven
    atoms, on every basis state: ``(runs, 2^n)``."""
    n = len(coords)
    occ = R.occupations(n)
    r = np.linalg.norm(coords[:, None, :] - coords[None, :, :], axis=-1)
    u = np.zeros((n, n))
    iu = np.triu_indices(n, 1)
    u[iu] = c6 / r[iu] ** 6
    g = driven.astype(np.float64)
    return np.stack([((occ @ (u * np.outer(m, m))) * occ).sum(axis=1) for m in g])


def evolve(coords, c6, amp, det, mask, factors, driven, doppler, times,
           dtype=torch.float64, device="cpu", max_step_ns: float = 1.0) -> np.ndarray:
    """The cumulative distributions of every realization at ``times``.

    Classic RK4 on :func:`rydberg.grid` in the interaction picture of the
    real diagonal, as :func:`rydberg.evolve`, with a drive of its own for
    each atom of each realization: the σx sum carries the atoms' factors
    ``factors`` (runs, n) (two dense products on ψ viewed as a
    ``(2^⌊n/2⌋, 2^⌈n/2⌉)`` matrix), and the phase Φ = U t − Σ_k n_k ∫δ_k
    integrates each atom's detuning exactly in float64. ``amp``, ``det``
    and ``mask`` are the shared samples (rad/µs, one a nanosecond; mask 1
    while a pulse runs); an undriven atom's factor, detuning and
    interactions are zero. The arithmetic is real, in ``dtype``.

    Returns:
        ``(runs, len(times), 2^n + 1)`` float64 cumulative probabilities
        in bitstring order, 0 first.
    """
    dev = torch.device(device)
    f64 = torch.float64
    n, b = len(coords), len(factors)
    nl = n // 2
    shape = (b, 1, 1 << nl, 1 << (n - nl))
    drive = R.Problem(coords, c6, amp[None], det[None])
    window = R.Problem(coords, c6, np.zeros_like(mask)[None], mask[None])
    steps, where, pts = R.grid(times, drive.t_last, max_step_ns)

    def on(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=dev)

    a_left = on(R.flip_sum(nl, factors[:, :nl]) / 2)[:, None]  # (B, 1, L, L)
    a_right_t = on(
        np.swapaxes(R.flip_sum(n - nl, factors[:, nl:]), -1, -2) / 2
    )[:, None]
    u_diag = on(interaction_diags(coords, c6, driven), f64)  # (B, dim)
    occ_t = on(R.occupations(n).T, f64)  # (n, dim)
    good = on(driven, f64)
    shift = on(driven * doppler, f64)
    t0 = pts[:-1]
    stage_t = np.stack([t0, t0 + steps / 2, t0 + steps], axis=-1).reshape(-1)
    om = drive.coeffs(stage_t)[0].reshape(-1, 3)
    d_int = drive.det_integral(stage_t)[0].reshape(-1, 3)
    m_int = window.det_integral(stage_t)[0].reshape(-1, 3)
    stage_t = stage_t.reshape(-1, 3)

    def frame(s, j):
        """cos Φ and sin Φ at stage time ``j`` of step ``s``."""
        g = good * float(d_int[s, j]) + shift * float(m_int[s, j])  # (B, n)
        phi = (u_diag * float(stage_t[s, j]) - g @ occ_t).view(shape)
        return torch.cos(phi).to(dtype), torch.sin(phi).to(dtype)

    def deriv(z, s, j, fr):
        c, sn = fr
        x, y = z[:, :1], z[:, 1:]
        u = torch.cat([c * x + sn * y, c * y - sn * x], dim=1)
        v = float(om[s, j]) * (
            torch.matmul(a_left, u) + torch.matmul(u, a_right_t)
        )
        vr, vi = v[:, :1], v[:, 1:]
        # −i e^{iΦ} v
        return torch.cat([c * vi + sn * vr, sn * vi - c * vr], dim=1)

    z = torch.zeros((b, 2) + shape[2:], dtype=dtype, device=dev)
    z[:, 0, 0, 0] = 1.0  # every atom in g: the all-zero bitstring
    out = np.empty((b, len(where), (1 << n) + 1))

    def keep(z, s):
        zz = z.to(f64)
        p = (zz[:, 0] ** 2 + zz[:, 1] ** 2).reshape(b, -1)  # |ψ|² = |ψ_I|²
        cdf = torch.cumsum(p, dim=1) / p.sum(dim=1, keepdim=True)
        cdf = torch.cat([torch.zeros((b, 1), dtype=f64, device=dev), cdf], 1)
        host = cdf.cpu().numpy()
        for i in np.flatnonzero(where == s):
            out[:, i] = host

    fr0 = frame(0, 0)
    keep(z, 0)
    for s in range(len(steps)):
        h = float(steps[s])
        fr_mid, fr_end = frame(s, 1), frame(s, 2)
        k1 = deriv(z, s, 0, fr0)
        k2 = deriv(z + (h / 2) * k1, s, 1, fr_mid)
        k3 = deriv(z + (h / 2) * k2, s, 1, fr_mid)
        k4 = deriv(z + h * k3, s, 2, fr_end)
        z = z + (h / 6) * (k1 + 2 * k2 + 2 * k3 + k4)
        fr0 = fr_end
        if s + 1 in where:
            keep(z, s + 1)
    return out


# -- the shots ---------------------------------------------------------------


def _flip(codes: np.ndarray, v: np.ndarray, noise: dict, n: int) -> np.ndarray:
    """The measured codes: each bit of ``codes`` read through the SPAM
    flips of its uniforms ``v`` (..., n), atom 0 the most significant."""
    pos = np.arange(n - 1, -1, -1)
    bits = (codes[..., None] >> pos) & 1
    p = np.where(
        bits == 1, noise.get("p_false_neg", 0.0), noise.get("p_false_pos", 0.0)
    )
    return ((bits ^ (v < p)) << pos).sum(axis=-1)


def _draw(cum: np.ndarray, u: np.ndarray) -> np.ndarray:
    """Inverse-CDF draws of ``u`` from the cumulative weights ``cum``,
    none past the last outcome of positive weight."""
    return np.minimum(np.searchsorted(cum, u), np.searchsorted(cum, cum[-1]))


def sample(cdf: np.ndarray, u: np.ndarray, v: np.ndarray, noise: dict,
           n: int) -> list[Counter]:
    """The counts at each time of inverse-CDF draws ``u`` (runs, times,
    samples) from ``cdf`` (runs, times, dim + 1), flipped by ``v``. A
    uniform above a distribution's rounded total draws its last outcome
    of positive weight, as the API does."""
    out = []
    for t in range(cdf.shape[1]):
        idx = np.stack([_draw(cdf[r, t, 1:], u[r, t]) for r in range(len(cdf))])
        codes = _flip(idx, v[:, t], noise, n)
        vals, cnts = np.unique(codes, return_counts=True)
        out.append(Counter(dict(zip(R.bitstring_labels(vals, n), cnts.tolist()))))
    return out


def expected(config: dict, traffic: dict, jobs: list, device="cpu",
             dtype=torch.float64) -> list[dict]:
    """The reference's outputs of ``jobs``, in the program's format
    (``counts``), with the cumulative distributions and the draws the
    comparison reads.

    With a lower ``dtype`` this is the control: the reference put in the
    program's place.
    """
    coords = R.register_coords(config["register"])
    n = len(coords)
    noise = config["noise"]
    c6 = config["constants"]["c6_rad_um6_per_us"]
    n_samples = sum(p["duration"] for p in config["pulses"])
    times = R.evaluation_times(config, n_samples)
    mask = np.ones(n_samples)  # the pulses follow each other from t = 0
    profile = beam_profile(coords, noise.get("laser_waist"))
    out = []
    for job in jobs:
        dr = draws(config, len(times), job["np_seed"])
        driven = ~dr["undriven"]
        factors = dr["amplitude"][:, None] * profile[None] * driven
        amp, det = R.pulse_samples(
            config["pulses"], R.values_of(config, job["params"]), ROOT
        )
        cdf = evolve(coords, c6, amp, det, mask, factors, driven,
                     dr["doppler"], times, dtype, device)
        out.append({
            "counts": sample(cdf, dr["u"], dr["v"], noise, n),
            "cdf": cdf,
            "draws": dr,
        })
    return out


# -- the comparison ----------------------------------------------------------


def _codes(got, n: int) -> tuple[np.ndarray, np.ndarray] | None:
    """The distinct codes of a count and how often each came up; None
    where the count is no count of n-bit strings."""
    try:
        items = [(int(b, 2), int(c)) for b, c in got.items() if int(c) > 0]
        if any(len(b) != n for b in got):
            return None
    except (AttributeError, TypeError, ValueError):
        return None
    if not items:
        return None
    codes, counts = (np.array(x, np.int64) for x in zip(*items))
    return codes, counts


def _edges(codes, cdf, run, u, v, noise, n, window: float):
    """The candidate pairs of draws and labels within ``window``:
    ``(draw, label, distance)`` arrays, the distance from the draw's
    uniform to the interval of an outcome that its flips turn into the
    label (a pair may come more than once, by several outcomes).

    An atom's flip uniform decides its measured bit from its true one:
    ``g`` reads ``v < p_false_pos``, ``r`` reads ``v ≥ p_false_neg``.
    Where both give the same bit, the true bit is free; elsewhere it is
    the measured bit xor the bit ``g`` would read. The outcomes within
    ``window`` of a uniform are an index range of the realization's
    cumulative distribution, found by bisection.
    """
    pos = np.arange(n - 1, -1, -1)
    weight = 1 << pos
    read_g = v < noise.get("p_false_pos", 0.0)  # (N, n)
    read_r = v >= noise.get("p_false_neg", 0.0)
    f0 = (read_g * weight).sum(axis=1)  # (N,)
    free = read_g == read_r
    a = (free * weight).sum(axis=1)
    diff = codes[None, :] ^ f0[:, None]  # (N, D)
    fits = (diff & a[:, None]) == 0
    base = diff & ~a[:, None]
    first = np.empty(len(u), np.int64)
    last = np.empty(len(u), np.int64)
    for r in np.unique(run):
        at = run == r
        first[at] = np.searchsorted(cdf[r, 1:], u[at] - window)
        last[at] = np.searchsorted(cdf[r, :-1], u[at] + window, "right") - 1
    n_free = free.sum(axis=1)
    bitvals = np.zeros((len(u), max(int(n_free.max()), 1)), np.int64)
    for i in np.flatnonzero(n_free):
        bitvals[i, : n_free[i]] = weight[free[i]]
    found = []
    # every subset of each draw's free bits
    for j in range(1 << int(n_free.max())):
        rows = np.flatnonzero(n_free >= j.bit_length())
        sel = bitvals[rows] @ ((j >> np.arange(bitvals.shape[1])) & 1)
        x = base[rows] | sel[:, None]
        near = fits[rows] & (x >= first[rows, None]) & (x <= last[rows, None])
        i, lab = np.nonzero(near)
        i, x = rows[i], x[near]
        r, uu = run[i], u[i]
        d = np.maximum(np.maximum(cdf[r, x] - uu, uu - cdf[r, x + 1]), 0.0)
        found.append((i, lab, d))
    return tuple(np.concatenate(c) for c in zip(*found))


def _matches(edges, n_draws: int, counts: np.ndarray, w: float) -> bool:
    """Whether every draw pairs with a shot within ``w``: a maximum
    flow from the draws (one each) to the labels (their counts)."""
    i, j, d = edges
    keep = d <= w
    i, j = i[keep], j[keep]
    n_labels = len(counts)
    sink = n_draws + n_labels + 1
    rows = np.concatenate([np.zeros(n_draws, np.int64), 1 + i,
                           1 + n_draws + np.arange(n_labels)])
    cols = np.concatenate([1 + np.arange(n_draws), 1 + n_draws + j,
                           np.full(n_labels, sink)])
    caps = np.concatenate([np.ones(n_draws + len(i), np.int32),
                           counts.astype(np.int32)])
    graph = coo_matrix((caps, (rows, cols)), shape=(sink + 1, sink + 1)).tocsr()
    return maximum_flow(graph, 0, sink).flow_value == n_draws


def _bottleneck(edges, n_draws: int, counts: np.ndarray) -> float | None:
    """The least w at which every draw pairs with a shot, over the
    candidate pairs ``edges``; None where none does."""
    i, j, d = edges
    # Lower bounds: every draw needs a pair, every label as many as its
    # count (the count-th nearest of its pairs)
    row_min = np.full(n_draws, np.inf)
    np.minimum.at(row_min, i, d)
    order = np.lexsort((d, j))
    starts = np.searchsorted(j[order], np.arange(len(counts)))
    ends = np.searchsorted(j[order], np.arange(len(counts)), "right")
    if np.any(ends - starts < counts) or not np.all(np.isfinite(row_min)):
        return None
    low = max(float(row_min.max()), float(d[order[starts + counts - 1]].max()))
    if _matches(edges, n_draws, counts, low):
        return low
    cand = np.unique(d[d > low])
    if not len(cand) or not _matches(edges, n_draws, counts, float(cand[-1])):
        return None
    lo, hi = 0, len(cand) - 1  # cand[hi] matches
    while lo < hi:
        mid = (lo + hi) // 2
        if _matches(edges, n_draws, counts, float(cand[mid])):
            hi = mid
        else:
            lo = mid + 1
    return float(cand[hi])


#: The window of the first search for a pairing: the pairs within it
#: are few. Where it holds none, every pair is searched.
WINDOW = 0.02


def time_gap(got, cdf: np.ndarray, u: np.ndarray, v: np.ndarray, noise: dict,
             n: int) -> float:
    """``counts_gap`` at one time: ``cdf`` (runs, dim + 1), ``u`` (runs,
    samples), ``v`` (runs, samples, n)."""
    parsed = _codes(got, n)
    runs, spr = u.shape
    if parsed is None or parsed[1].sum() != runs * spr:
        return 1.0
    codes, counts = parsed
    run = np.repeat(np.arange(runs), spr)
    uu, vv = u.reshape(-1), v.reshape(-1, n)
    for window in (WINDOW, np.inf):
        edges = _edges(codes, cdf, run, uu, vv, noise, n, window)
        gap = _bottleneck(edges, len(uu), counts)
        if gap is not None:
            return gap
    return 1.0


def compare(config: dict, traffic: dict, jobs: list, ref: list) -> dict:
    """The number compared, worst over ``jobs`` and times, with its limit."""
    n = len(R.register_coords(config["register"]))
    noise = config["noise"]
    worst = 0.0
    for job, want in zip(jobs, ref):
        got = job["outputs"].get("counts") if isinstance(job["outputs"], dict) else None
        if got is None or len(got) != want["cdf"].shape[1]:
            worst = 1.0
            continue
        for t, counts in enumerate(got):
            gap = time_gap(counts, want["cdf"][:, t], want["draws"]["u"][:, t],
                           want["draws"]["v"][:, t], noise, n)
            worst = max(worst, gap if np.isfinite(gap) else UNREADABLE)
    return {"counts_gap": {"value": worst, "limit": LIMITS["counts_gap"]}}
