# %% [markdown]
# # Solving a QUBO with QAOA and parametrized sequences
#
# Variational algorithms ask for the SAME pulse program with many
# different parameter values. Rebuilding (and revalidating) the
# sequence from scratch each iteration would be wasteful — so, like
# the reference, the framework lets you declare a sequence once with
# `declare_variable` placeholders and instantiate it per candidate
# with `seq.build(...)`. The parametrized sequence is exactly what
# you would serialize and submit to a QPU with an attached parameter
# table (reference: `tutorials/applications/QAOA and QAA to solve a
# QUBO problem.ipynb`).
#
# **The problem, straight from the geometry.** On a Rydberg register
# the quadratic cost terms come for free: the always-on van-der-
# Waals couplings U_ij = C6/R_ij⁶ ARE the QUBO matrix, and a global
# detuning supplies the linear term. We place 4 atoms on a square:
# with the detuning between the diagonal coupling (weak) and the
# edge coupling (strong), the two diagonal pairs are the degenerate
# optima — a tiny maximum-independent-set instance.
#
# This page runs on `pulser_tpu_torch`, the PyTorch package; its
# emulators take `torch_device=DEVICE`, the torch device
# `tools/build_tutorials_torch.py` puts into the cells' namespace
# (`cuda` by default; this page was built with `--device cpu`).

# %%
import itertools

import matplotlib.pyplot as plt
import numpy as np

import pulser_tpu_torch as ptt
from pulser_tpu_torch.emulator import TorchEmulator

side = 7.0
coords = [(0.0, 0.0), (side, 0.0), (side, side), (0.0, side)]
reg = ptt.Register.from_coordinates(coords, prefix="q")
c6 = ptt.MockDevice.interaction_coeff
rr = np.array(
    [
        [np.hypot(x1 - x2, y1 - y2) for (x2, y2) in coords]
        for (x1, y1) in coords
    ]
)
U = np.where(rr > 0, c6 / np.maximum(rr, 1e-9) ** 6, 0.0)
delta_cost = 20.0  # rad/µs: between diag (~5.8) and edge (~46)


def ising_cost(bits: str) -> float:
    z = np.array(list(bits), dtype=float)
    return float(z @ np.triu(U, 1) @ z - delta_cost * z.sum())


bitstrings = ["".join(b) for b in itertools.product("01", repeat=4)]
best = min(bitstrings, key=ising_cost)
optima = {
    b for b in bitstrings if ising_cost(b) <= ising_cost(best) + 1e-9
}
print("ground configurations:", sorted(optima))
assert optima == {"0101", "1010"}

# %% [markdown]
# ## One parametrized sequence, many candidates
#
# QAOA alternates two layers, p times:
#
# - **mixer**: a resonant drive (Ω on, δ = 0) rotating every qubit —
#   the transverse field;
# - **cost**: drive off, detuning on — the computational basis
#   accumulates phase proportional to its Ising energy (the
#   interactions are always on; we cannot switch them, so the cost
#   layer is simply "let the register be itself").
#
# The layer DURATIONS are the variational parameters. Declaring them
# as integer `Variable`s of size p gives a sequence that builds in
# milliseconds per candidate.

# %%
P_LAYERS = 2
proto = ptt.Sequence(reg, ptt.MockDevice)
proto.declare_channel("ryd", "rydberg_global")
t_mix = proto.declare_variable("t_mix", size=P_LAYERS, dtype=int)
t_cost = proto.declare_variable("t_cost", size=P_LAYERS, dtype=int)
for j in range(P_LAYERS):
    proto.add(
        ptt.Pulse.ConstantPulse(t_mix[j], 2.0 * np.pi, 0.0, 0.0),
        "ryd",
    )
    proto.add(
        ptt.Pulse.ConstantPulse(t_cost[j], 0.0, delta_cost, 0.0),
        "ryd",
    )
assert proto.is_parametrized()
print(proto)

# %% [markdown]
# ## The objective
#
# Build a candidate, emulate it, read ⟨cost⟩ off the final-state
# distribution. Index bookkeeping: the statevector orders the
# Rydberg state FIRST (digit 0 = |r⟩), while the QUBO bit 1 means
# "excited" — hence the bit-complement when mapping bitstrings to
# amplitudes.

# %%
def expected_cost(params):
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
    cost = sum(
        probs[int("".join("0" if c == "1" else "1" for c in b), 2)]
        * ising_cost(b)
        for b in bitstrings
    )
    return float(cost), probs

# %% [markdown]
# ## The variational loop
#
# A coarse grid over layer durations, then a cheap stochastic
# refinement. (Any optimizer slots in here — the objective is just a
# function; with the differentiable build path you can even get
# gradients through pulse parameters, see `docs/MIGRATION.md`.)

# %%
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
for _ in range(8):
    trial = best_params + rng.integers(-60, 61, size=4)
    val, _ = expected_cost(trial)
    if val < best_val:
        best_val, best_params = val, trial
val, probs = expected_cost(best_params)
print(f"refined <cost> = {val:.2f}")

# %% [markdown]
# ## Did it work?
#
# Compare the probability the optimized schedule assigns to the two
# ground configurations against uniform sampling.

# %%
def p_of(b):
    return probs[
        int("".join("0" if c == "1" else "1" for c in b), 2)
    ]

p_opt = sum(p_of(b) for b in optima)
baseline = len(optima) / len(bitstrings)
print(
    f"P(ground configs) = {p_opt:.3f}"
    f"  (uniform baseline {baseline:.3f})"
)
assert p_opt > 2 * baseline
top = max(bitstrings, key=p_of)
print("most probable configuration:", top)
assert top in optima

fig, ax = plt.subplots(figsize=(7, 3))
cols = [
    "#b34f38" if b in optima else "#9a9a9a" for b in bitstrings
]
ax.bar(bitstrings, [p_of(b) for b in bitstrings], color=cols)
ax.axhline(baseline / 2, ls="--", color="#555",
           label="uniform per-state")
ax.set_ylabel("probability")
ax.set_title("QAOA concentrates on the two diagonal optima (red)")
ax.tick_params(axis="x", rotation=45)
ax.legend()

# %% [markdown]
# ## Where to go next
#
# - `examples/qubo_qaa.py` solves the same instance by quantum
#   adiabatic annealing (one sweep, no variational loop) — the
#   comparison the reference tutorial draws.
# - `examples/mwis_qaa.py` scales the idea to maximum-weight
#   independent set with per-qubit DMM weights.
# - For QPU submission, `proto.to_abstract_repr()` serializes the
#   PARAMETRIZED sequence — variables included — so the schedule
#   search can run against the real device.
