"""QAOA on a Rydberg register: variational alternation, not annealing.

PyTorch rendition of the reference's "QAOA and QAA to solve a QUBO
problem" tutorial (reference: tutorials/applications/QAOA and QAA to
solve a QUBO problem.ipynb), covering the QAOA half — the QAA half
lives in ``examples/qubo_qaa.py``. One PARAMETRIZED sequence with
variable-duration layers is declared once; every candidate schedule is
then just ``seq.build(...)`` with new numbers, exactly the
parametrized-sequence machinery a QPU submission would use.

The Ising cost is read off the register itself: the always-on van der
Waals couplings C6/r^6 are the quadratic terms, the cost layer's
detuning is the linear term. A square register makes the two diagonal
pairs the degenerate optima.

Run:  python examples_torch/qaoa_qubo.py [--device cpu]
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import numpy as np

import pulser_tpu_torch as pt
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

# --- the problem, straight from the geometry ------------------------
side = 7.0
coords = [
    (0.0, 0.0),
    (side, 0.0),
    (side, side),
    (0.0, side),
]
reg = pt.Register.from_coordinates(coords, prefix="q")
c6 = pt.MockDevice.interaction_coeff
rr = np.array(
    [
        [np.hypot(x1 - x2, y1 - y2) for (x2, y2) in coords]
        for (x1, y1) in coords
    ]
)
U = np.where(rr > 0, c6 / np.maximum(rr, 1e-9) ** 6, 0.0)
# rad/us: above the diagonal coupling (~5.8) so a diagonal PAIR beats
# a single excitation, below the edge coupling (~46) so edge pairs
# stay penalized -> the two diagonals are the degenerate optima.
delta_cost = 20.0


def ising_cost(bits: str) -> float:
    z = np.array(list(bits), dtype=float)
    return float(z @ np.triu(U, 1) @ z - delta_cost * z.sum())


bitstrings = ["".join(b) for b in itertools.product("01", repeat=4)]
best = min(bitstrings, key=ising_cost)
optima = {b for b in bitstrings if ising_cost(b) <= ising_cost(best) + 1e-9}
print(f"ground configurations: {sorted(optima)}")
assert optima == {"0101", "1010"}  # the two diagonals, degenerate

# --- ONE parametrized sequence, built per candidate -----------------
P_LAYERS = 2
proto = pt.Sequence(reg, pt.MockDevice)
proto.declare_channel("ryd", "rydberg_global")
t_mix = proto.declare_variable("t_mix", size=P_LAYERS, dtype=int)
t_cost = proto.declare_variable("t_cost", size=P_LAYERS, dtype=int)
for j in range(P_LAYERS):
    # Mixer: resonant drive rotates every qubit.
    proto.add(
        pt.Pulse.ConstantPulse(t_mix[j], 2.0 * np.pi, 0.0, 0.0),
        "ryd",
    )
    # Cost: no drive, detuning + the always-on interactions phase the
    # computational basis by the Ising energies.
    proto.add(
        pt.Pulse.ConstantPulse(t_cost[j], 0.0, delta_cost, 0.0),
        "ryd",
    )
assert proto.is_parametrized()


def expected_cost(params: np.ndarray) -> tuple[float, np.ndarray]:
    """<cost> under the final-state distribution, plus the probs."""
    tm = np.clip(np.round(params[:P_LAYERS]), 16, 2000).astype(int)
    tc = np.clip(np.round(params[P_LAYERS:]), 16, 2000).astype(int)
    seq = proto.build(t_mix=tm, t_cost=tc)
    state = np.asarray(
        TorchEmulator.from_sequence(seq, torch_device=DEVICE)
        .run()
        .get_final_state()
        .full()
    )[:, 0]
    probs = np.abs(state) ** 2
    # ground-rydberg ordering: digit 0 = |r>; bit 1 of the QUBO = |r>,
    # so bitstring b maps to index sum((1-b_i) << (3-i)).
    cost = sum(
        probs[int("".join("0" if c == "1" else "1" for c in b), 2)]
        * ising_cost(b)
        for b in bitstrings
    )
    return float(cost), probs


def p_optimal(probs: np.ndarray) -> float:
    idx = [
        int("".join("0" if c == "1" else "1" for c in b), 2)
        for b in optima
    ]
    return float(sum(probs[i] for i in idx))


# --- variational loop: coarse grid, then local refinement -----------
rng = np.random.default_rng(1)
grid = [100, 250, 400]
best_params, best_val = None, np.inf
for tm0 in grid:
    for tc0 in grid:
        params = np.array([tm0, tm0, tc0, tc0], float)
        val, _ = expected_cost(params)
        if val < best_val:
            best_val, best_params = val, params
print(f"grid best <cost> = {best_val:.2f} at {best_params}")

for _ in range(8):  # cheap stochastic refinement around the best
    trial = best_params + rng.integers(-60, 61, size=4)
    val, _ = expected_cost(trial)
    if val < best_val:
        best_val, best_params = val, trial
val, probs = expected_cost(best_params)
print(f"refined <cost> = {val:.2f}")

p_opt = p_optimal(probs)
baseline = len(optima) / len(bitstrings)  # uniform sampling
print(
    f"P(ground configs) = {p_opt:.3f} (uniform baseline {baseline:.3f})"
)
assert p_opt > 2 * baseline, (p_opt, baseline)
top = bitstrings[
    int(
        np.argmax(
            [
                probs[
                    int(
                        "".join(
                            "0" if c == "1" else "1" for c in b
                        ),
                        2,
                    )
                ]
                for b in bitstrings
            ]
        )
    )
]
print(f"most probable configuration: {top}")
assert top in optima, top
print("OK qaoa-qubo walkthrough complete")
