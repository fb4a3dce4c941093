"""Closed-loop pulse optimization for AFM state preparation.

PyTorch rendition of the reference's "Bayesian Optimisation for
antiferromagnetic state preparation" tutorial (reference:
tutorials/quantum_simulation/Bayesian Optimisation for
antiferromagnetic state preparation.ipynb). The reference reaches for
Bayesian optimisation because each QuTiP simulation is expensive; here
the emulator is fast enough that a plain Nelder-Mead loop — dozens of
full simulations — closes in seconds, optimizing the detuning sweep of
an adiabatic ramp to maximize the Néel structure factor of a 6-atom
chain.

Run:  python examples_torch/optimize_afm_preparation.py [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import numpy as np
from scipy.optimize import minimize

import pulser_tpu_torch as pt
from pulser_tpu_torch.devices import MockDevice
from pulser_tpu_torch.emulator import TorchEmulator
from pulser_tpu_torch.ops.solver import resolve_device

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument(
    "--device",
    default=None,
    help="torch device to run on (default: the CUDA card; 'cpu' to run"
    " without one)",
)
DEVICE = resolve_device(parser.parse_args().device)

N_ATOMS = 6
SPACING = 7.0  # um: nearest-neighbour blockade, weak beyond
T_TOTAL = 2000  # ns
OMEGA_MAX = 2.0 * np.pi  # rad/us

reg = pt.Register.rectangle(1, N_ATOMS, spacing=SPACING, prefix="q")


def neel_structure_factor(probs: dict[str, float]) -> float:
    """< sum_ij (-1)^(i-j) (n_i - 1/2)(n_j - 1/2) > from bit probs.

    Equals ``(sum_i (-1)^i (n_i - 1/2))^2`` averaged over the measured
    distribution; a perfect 6-atom Néel state scores 9, a product
    state ~1.5.
    """
    total = 0.0
    sign = (-1.0) ** np.arange(N_ATOMS)
    for bits, p in probs.items():
        n = np.array([int(b) for b in bits]) - 0.5
        total += p * float(np.sum(sign * n)) ** 2
    return total


def prepare(params: np.ndarray) -> float:
    """One full simulation; returns the Néel structure factor."""
    det_start, det_end, hold_frac = params
    ramp_t = int(T_TOTAL * float(np.clip(hold_frac, 0.2, 0.8)))
    ramp_t += -ramp_t % 4  # clock-period alignment
    rise_t = (T_TOTAL - ramp_t) // 2
    rise_t += -rise_t % 4

    seq = pt.Sequence(reg, MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(
        pt.Pulse.ConstantDetuning(
            pt.RampWaveform(rise_t, 0.0, OMEGA_MAX), det_start, 0.0
        ),
        "ryd",
    )
    seq.add(
        pt.Pulse.ConstantAmplitude(
            OMEGA_MAX,
            pt.RampWaveform(ramp_t, det_start, det_end),
            0.0,
        ),
        "ryd",
    )
    seq.add(
        pt.Pulse.ConstantDetuning(
            pt.RampWaveform(rise_t, OMEGA_MAX, 0.0), det_end, 0.0
        ),
        "ryd",
    )

    result = TorchEmulator.from_sequence(seq, torch_device=DEVICE).run()
    final = np.asarray(result.get_final_state().full()).ravel()
    probs_vec = np.abs(final) ** 2
    probs = {
        format(i, f"0{N_ATOMS}b"): float(p)
        for i, p in enumerate(probs_vec)
        if p > 1e-6
    }
    return neel_structure_factor(probs)


# --- baseline: an uninformed sweep -----------------------------------
# det_end = 4 rad/us sits right at the edge of the AFM lobe for this
# chain; the optimizer should discover a deeper sweep.
x0 = np.array([-4.0, 4.0, 0.5])
baseline = prepare(x0)
print(f"baseline Neel structure factor: {baseline:.4f}")

# --- closed-loop optimization ----------------------------------------
history: list[float] = []


def loss(params: np.ndarray) -> float:
    value = prepare(params)
    history.append(value)
    return -value


opt = minimize(
    loss,
    x0,
    method="Nelder-Mead",
    options={
        "maxfev": 40,
        "xatol": 0.1,
        "fatol": 1e-4,
        # A wide opening simplex: each full simulation is cheap, so
        # explore aggressively instead of creeping locally.
        "initial_simplex": np.array(
            [
                [-4.0, 4.0, 0.5],
                [-2.0, 4.0, 0.5],
                [-4.0, 10.0, 0.5],
                [-4.0, 4.0, 0.3],
            ]
        ),
    },
)
best = -opt.fun
print(f"optimized Neel structure factor: {best:.4f}")
print(
    "optimal sweep: det "
    f"{opt.x[0]:.2f} -> {opt.x[1]:.2f} rad/us, "
    f"ramp fraction {np.clip(opt.x[2], 0.2, 0.8):.2f}"
)
print(f"simulations run: {len(history) + 1}")

# The edge-of-lobe baseline scores ~1.5; the optimizer reliably finds
# sweeps above 2 (perfect Néel on 6 atoms would score 9).
assert best > baseline + 0.3, (best, baseline)
print("OK closed-loop optimization complete")
