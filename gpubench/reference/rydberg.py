"""Plain physics of a Rydberg-atom register under one global channel.

The benchmark's references work every answer out again from a job's own
parameters with nothing but numpy and torch: the atoms' positions, the
pulse samples, the Hamiltonian, a fixed-step RK4 grid, and the seeded
draws of the Pulser emulator API. Nothing here imports the program under
test, JAX or the JAX package.

Conventions (those of Pulser's ground-rydberg basis):

- A basis state is indexed by its bitstring read as a binary number,
  atom 0 the most significant bit, bit 1 = the Rydberg state ``r``. The
  emulator's state vectors list ``r`` first, so their index ``j`` is this
  module's ``dim - 1 - j``.
- ``H(t) = Σ_k Ω_k(t)/2 σx_k − Σ_k δ_k(t) n_k + Σ_{i<j} C6 / R_ij^6 n_i n_j``
  in rad/µs, with ``n = |r⟩⟨r|``, phase 0.
- The samples are taken every nanosecond, and the sequence ends one
  nanosecond after the last one with every channel at zero; between two
  samples the drive is the straight line through them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gpubench.harness.spec import load_module

TWO_PI = 2.0 * math.pi


# -- the register and the pulses ---------------------------------------------


def register_coords(register: dict) -> np.ndarray:
    """``(n, 2)`` atom positions in µm, in the order of the atom ids."""
    return np.asarray(register["coords_um"], dtype=np.float64)


def pulse_samples(pulses: list, values: dict, root: str) -> tuple[np.ndarray, np.ndarray]:
    """The amplitude and detuning samples (rad/µs, one a nanosecond) of
    a chain of pulses. A waveform is ``[kind, *args]``: the samples of
    ``<root>/gpubench/waveforms/<kind>.py`` (the program's waveform
    class ``kind``) over the pulse's duration; a string argument names a
    value of ``values``."""

    def value(v):
        return float(values[v]) if isinstance(v, str) else float(v)

    def wave(spec, duration):
        kind = spec[0]
        if kind not in _WAVEFORMS:
            _WAVEFORMS[kind] = load_module(root, "waveforms", kind).samples
        return _WAVEFORMS[kind](duration, *(value(v) for v in spec[1:]))

    amp = np.concatenate([wave(p["amplitude"], p["duration"]) for p in pulses])
    det = np.concatenate([wave(p["detuning"], p["duration"]) for p in pulses])
    return amp, det


_WAVEFORMS: dict = {}


def values_of(config: dict, params: dict) -> dict:
    """The configuration's values (stored in units of 2π rad/µs) with a
    job's drawn parameters over them, in rad/µs."""
    out = {k: TWO_PI * float(v) for k, v in config["values_2pi"].items()}
    out.update({k: TWO_PI * float(v) for k, v in params.items()})
    return out


def evaluation_times(config: dict, n_samples: int) -> np.ndarray:
    """The evaluation times (µs) the emulator is asked for: the
    configuration's count of them, evenly spaced over the sequence."""
    return np.linspace(0.0, n_samples * 1e-3, int(config["evaluation_times"]))


# -- the Hamiltonian ---------------------------------------------------------


def occupations(n: int) -> np.ndarray:
    """``(dim, n)`` 0/1 table: bit ``k`` (atom ``k``) of each basis state."""
    idx = np.arange(1 << n, dtype=np.int64)
    return ((idx[:, None] >> np.arange(n - 1, -1, -1)) & 1).astype(np.float64)


def interaction_diag(coords: np.ndarray, c6: float) -> np.ndarray:
    """``Σ_{i<j} C6 / R_ij^6 n_i n_j`` on every basis state."""
    n = len(coords)
    occ = occupations(n)
    r = np.linalg.norm(coords[:, None, :] - coords[None, :, :], axis=-1)
    u = np.zeros((n, n))
    iu = np.triu_indices(n, 1)
    u[iu] = c6 / r[iu] ** 6
    return np.einsum("si,ij,sj->s", occ, u, occ)


def flip_sum(n_bits: int, factors: np.ndarray) -> np.ndarray:
    """``Σ_k f_k σx_k`` on ``n_bits`` atoms, atom 0 the most significant
    bit: ``(..., 2^n_bits, 2^n_bits)`` for factors ``(..., n_bits)``."""
    dim = 1 << n_bits
    idx = np.arange(dim)
    out = np.zeros(factors.shape[:-1] + (dim, dim))
    for k in range(n_bits):
        out[..., idx, idx ^ (1 << (n_bits - 1 - k))] += factors[..., k, None]
    return out


class Problem:
    """A batch of ``B`` pure states of ``n`` atoms under one global drive.

    Args:
        coords: ``(n, 2)`` positions (µm).
        c6: The interaction coefficient (rad·µm⁶/µs).
        amp: ``(B, N)`` amplitude samples (rad/µs), one a nanosecond;
            a zero sample follows them at the sequence's end.
        det: ``(B, N)`` detuning samples (rad/µs).
    """

    def __init__(self, coords, c6, amp, det):
        self.n = len(coords)

        def padded(x):
            x = np.atleast_2d(np.asarray(x, np.float64))
            return np.concatenate([x, np.zeros((x.shape[0], 1))], axis=1)

        self.amp, self.det = padded(amp), padded(det)
        self.occ = occupations(self.n)
        self.u_diag = interaction_diag(np.asarray(coords, float), c6)
        self.n_left = self.n // 2

    @property
    def batch(self) -> int:
        return self.amp.shape[0]

    @property
    def t_last(self) -> float:
        """The sequence's end (µs): the zero sample after the last one."""
        return (self.amp.shape[1] - 1) * 1e-3

    def coeffs(self, t: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """``(B, len(t))`` amplitude and detuning at times ``t`` (µs):
        the straight line between the two samples around each."""
        s = np.clip(np.asarray(t, np.float64) * 1e3, 0.0, self.amp.shape[1] - 1)
        i0 = np.minimum(np.floor(s).astype(np.int64), self.amp.shape[1] - 2)
        frac = s - i0
        lerp = lambda x: x[:, i0] * (1 - frac) + x[:, i0 + 1] * frac  # noqa: E731
        return lerp(self.amp), lerp(self.det)

    def det_integral(self, t: np.ndarray) -> np.ndarray:
        """``(B, len(t))`` ∫_0^t δ (rad) of the straight-line detuning."""
        s = np.clip(np.asarray(t, np.float64) * 1e3, 0.0, self.det.shape[1] - 1)
        i0 = np.minimum(np.floor(s).astype(np.int64), self.det.shape[1] - 2)
        frac = s - i0
        cum = np.concatenate(
            [np.zeros((self.batch, 1)),
             np.cumsum((self.det[:, :-1] + self.det[:, 1:]) * 0.5e-3, axis=1)],
            axis=1,
        )
        d_t = self.det[:, i0] * (1 - frac) + self.det[:, i0 + 1] * frac
        return cum[:, i0] + frac * 0.5e-3 * (self.det[:, i0] + d_t)


def grid(times: np.ndarray, t_last: float, max_step_ns: float = 1.0):
    """The reference's fixed-step RK4 grid: every sample time up to the
    last requested time, and the requested times, with no step longer
    than ``max_step_ns``. Returns ``(steps (µs), indices in the steps'
    end points of each requested time)``."""
    times = np.clip(np.asarray(times, np.float64), 0.0, t_last)
    t_end = float(times.max())
    knots = np.arange(0.0, t_end * 1e3 + 1e-9, max_step_ns) * 1e-3
    pts = np.unique(np.round(np.concatenate([[0.0], knots, times]), 12))
    pts = pts[pts <= t_end + 1e-12]
    where = np.searchsorted(pts, np.round(times, 12))
    return np.diff(pts), where, pts


def evolve(problem: Problem, times: np.ndarray, dtype=torch.float64,
           device="cpu", max_step_ns: float = 1.0) -> np.ndarray:
    """The states at ``times`` (µs) from all atoms in the ground state.

    Classic RK4 on the reference's grid (:func:`grid`) in the interaction
    picture of the diagonal: ψ = e^{−iΦ(t)} ψ_I with Φ the exact integral
    of the real diagonal (interactions, detunings), so only the drive is
    stepped, whatever the interactions' size. The arithmetic is real
    (ψ_I = x + i y) so that any real ``dtype`` runs it, bfloat16
    included; the phases are worked out in float64 and their cosines and
    sines cast to ``dtype``. The σx sum acts as two dense products on ψ
    viewed as a ``(2^⌊n/2⌋, 2^⌈n/2⌉)`` matrix.

    Returns:
        ``(B, len(times), dim)`` complex128 states in this module's basis
        order, as integrated.
    """
    dev = torch.device(device)
    f64 = torch.float64
    n, b = problem.n, problem.batch
    nl = problem.n_left
    shape = (b, 1, 1 << nl, 1 << (n - nl))
    steps, where, pts = grid(times, problem.t_last, max_step_ns)

    def on(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=dev)

    a_left = on(flip_sum(nl, np.ones(nl)) / 2)  # (L, L)
    a_right_t = on(np.swapaxes(flip_sum(n - nl, np.ones(n - nl)), -1, -2) / 2)
    # Φ(t) = u·t − pop·∫δ
    d0 = on(problem.u_diag, f64).view(1, 1, *shape[2:])
    pop = on(problem.occ.sum(axis=1), f64).view(1, 1, *shape[2:])
    # Every stage's drive and ∫δ at once: (B, steps, 3) at t, t+h/2, t+h
    t0 = pts[:-1]
    stage_t = np.stack([t0, t0 + steps / 2, t0 + steps], axis=-1).reshape(-1)
    om = on(problem.coeffs(stage_t)[0].reshape(b, -1, 3))
    dint = on(problem.det_integral(stage_t).reshape(b, -1, 3), f64)
    stage_t = stage_t.reshape(-1, 3)

    def frame(s, j):
        """cos Φ and sin Φ at stage time ``j`` of step ``s``."""
        phi = d0 * float(stage_t[s, j]) - pop * dint[:, s, j].view(b, 1, 1, 1)
        return torch.cos(phi).to(dtype), torch.sin(phi).to(dtype)

    def deriv(z, s, j, fr):
        c, sn = fr
        x, y = z[:, :1], z[:, 1:]
        u = torch.cat([c * x + sn * y, c * y - sn * x], dim=1)
        v = om[:, s, j].view(b, 1, 1, 1) * (
            torch.matmul(a_left, u) + torch.matmul(u, a_right_t)
        )
        vr, vi = v[:, :1], v[:, 1:]
        # −i e^{iΦ} v
        return torch.cat([c * vi + sn * vr, sn * vi - c * vr], dim=1)

    z = torch.zeros((b, 2) + shape[2:], dtype=dtype, device=dev)
    z[:, 0, 0, 0] = 1.0  # every atom in g: the all-zero bitstring
    out = np.empty((b, len(where), 1 << n), np.complex128)

    def keep(z, fr, s):
        c, sn = (x.to(f64) for x in fr)
        zz = z.to(f64)
        x, y = zz[:, :1], zz[:, 1:]
        # ψ = e^{−iΦ} ψ_I
        re = (c * x + sn * y).reshape(b, -1).cpu().numpy()
        im = (c * y - sn * x).reshape(b, -1).cpu().numpy()
        for i in np.flatnonzero(where == s):
            out[:, i] = re + 1j * im

    fr0 = frame(0, 0)
    keep(z, fr0, 0)
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
            keep(z, fr_end, s + 1)
    return out


def normalized(states: np.ndarray) -> np.ndarray:
    return states / np.linalg.norm(states, axis=-1, keepdims=True)


# -- the seeded draws of the emulator API ---------------------------------------


def bitstring_labels(codes: np.ndarray, n: int) -> list[str]:
    return [format(int(c), f"0{n}b") for c in codes]
