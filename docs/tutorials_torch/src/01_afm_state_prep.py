# %% [markdown]
# # Preparing an antiferromagnetic state
#
# This walkthrough prepares the antiferromagnetic (AFM) ground state
# of a 3×3 Rydberg array by an adiabatic sweep — the flagship
# experiment of neutral-atom analog quantum simulation and the
# benchmark sequence of this framework
# (reference: `tutorials/quantum_simulation/Preparing state with
# antiferromagnetic order in the Ising model.ipynb`).
#
# **The physics.** Each atom is a two-level system {ground `g`,
# Rydberg `r`}. A global laser drives every atom with Rabi frequency
# Ω(t) and detuning δ(t), while two atoms in `r` separated by R pay
# the van-der-Waals interaction U = C6/R⁶. The Hamiltonian realized
# on the device is the transverse-field Ising model
#
#     H = Σᵢ (Ω/2 σˣᵢ − δ nᵢ) + Σᵢ<ⱼ (C6/Rᵢⱼ⁶) nᵢ nⱼ .
#
# For δ < 0 every atom prefers `g` (paramagnet). For 0 < δ < U the
# many-body ground state wants each atom in `r` — but nearest
# neighbours cannot BOTH afford it (the blockade), so on a square
# lattice the ground state is the checkerboard: the AFM phase. Sweep
# δ slowly from negative to positive at finite Ω and the adiabatic
# theorem carries the system from the trivial paramagnet into the
# AFM state.
#
# This page runs on `pulser_tpu_torch`, the PyTorch package. Its code
# cells pass `torch_device=DEVICE` to the emulator: `DEVICE` is the
# torch device `tools/build_tutorials_torch.py` puts into their
# namespace (`--device`, `cuda` by default; this page was built with
# `--device cpu`).

# %%
import numpy as np

import pulser_tpu_torch as ptt
from pulser_tpu_torch.emulator import TorchEmulator

# %% [markdown]
# ## The register
#
# A 3×3 square array at 6 µm spacing. The blockade radius at our
# chosen Ω (2π·2 rad/µs) is ~8 µm for `MockDevice`'s Rydberg level —
# nearest neighbours (6 µm) are blockaded, diagonal neighbours
# (8.5 µm) are not: exactly the regime where the checkerboard wins.

# %%
spacing = 6.0  # µm
reg = ptt.Register.square(3, spacing=spacing, prefix="q")
print("qubits:", list(reg.qubit_ids))
print(
    "blockade radius at Ω=2π·2:",
    round(
        float(
            ptt.MockDevice.rydberg_blockade_radius(2.0 * 2 * np.pi)
        ),
        2,
    ),
    "µm",
)

# %% [markdown]
# ## The sweep
#
# Three pulses on one global Rydberg channel:
#
# 1. **Rise**: ramp Ω from 0 to Ω_max at large negative δ₀ — the
#    dressed paramagnet.
# 2. **Sweep**: hold Ω_max while ramping δ from δ₀ < 0 to δ_f > 0 —
#    crossing the phase transition. This leg must be slow: the
#    minimum gap at the transition sets the adiabatic time scale.
# 3. **Fall**: ramp Ω back to 0 at δ_f — projecting onto the
#    classical AFM configurations.

# %%
omega_max = 2.0 * 2 * np.pi  # rad/µs
delta_0 = -6.0 * 2 * np.pi
delta_f = 2.0 * 2 * np.pi
t_rise, t_sweep, t_fall = 252, 2700, 252  # ns

seq = ptt.Sequence(reg, ptt.MockDevice)
seq.declare_channel("ising", "rydberg_global")
seq.add(
    ptt.Pulse.ConstantDetuning(
        ptt.RampWaveform(t_rise, 0.0, omega_max), delta_0, 0.0
    ),
    "ising",
)
seq.add(
    ptt.Pulse.ConstantAmplitude(
        omega_max, ptt.RampWaveform(t_sweep, delta_0, delta_f), 0.0
    ),
    "ising",
)
seq.add(
    ptt.Pulse.ConstantDetuning(
        ptt.RampWaveform(t_fall, omega_max, 0.0), delta_f, 0.0
    ),
    "ising",
)
print("total duration:", seq.get_duration(), "ns")

# %% [markdown]
# The sequence drawer shows the two control curves — amplitude on
# top, detuning below. The sweep leg is where the physics happens.

# %%
import matplotlib.pyplot as plt

seq.draw(mode="input", show=False)

# %% [markdown]
# ## Emulating
#
# `TorchEmulator.from_sequence` samples the sequence into per-channel
# time series, builds the Ising Hamiltonian (the interaction term is
# DIAGONAL in the computational basis — a length-2^N vector, so the
# solver never forms a 2^N × 2^N matrix), and integrates the
# Schrödinger equation with a fixed-step RK4 in the interaction
# picture, where the interaction becomes a phase per basis state. On
# the card, 10 to 17 atoms run in one launch of a hand-written CUDA
# kernel (`pulser_tpu_torch/csrc/ip_sesolve.cu`); this 9-atom sweep,
# like every size outside that range, runs as a loop of torch
# operations.

# %%
sim = TorchEmulator.from_sequence(
    seq, evaluation_times=np.linspace(0, seq.get_duration() * 1e-3, 40),
    torch_device=DEVICE,
)
results = sim.run()
counts = results.sample_final_state(2000)
top = counts.most_common(4)
print("top outcomes of 2000 shots:")
for bits, n in top:
    print(f"  {bits}: {n}")

# %% [markdown]
# Checkerboard-ordered states dominate. A 3×3 subtlety worth
# noticing: the perfect checkerboard `101010101` (corners + center,
# 5 excitations) competes with `101000101` (corners only). The
# center atom sits 8.5 µm from all four corners — right at the
# blockade radius — so exciting it gains δ_f but pays four diagonal
# C6 tails at once. At this final detuning the corners-only state
# wins; raise δ_f and the full checkerboard takes over.

# %%
assert top[0][0] in ("101000101", "101010101"), top
afm_weight = sum(
    counts.get(s, 0)
    for s in ("101010101", "010101010", "101000101")
) / 2000
print(f"checkerboard-ordered weight: {afm_weight:.1%}")
assert afm_weight > 0.5
labels = [b for b, _ in top]
vals = [n for _, n in top]
fig, ax = plt.subplots(figsize=(6, 3))
ax.bar(labels, vals, color="#4469ab")
ax.set_ylabel("shots (of 2000)")
ax.set_title("Final-state histogram: checkerboard order")
ax.tick_params(axis="x", rotation=45)

# %% [markdown]
# ## Watching the order parameter grow
#
# The staggered magnetization m_stag = Σᵢ εᵢ ⟨nᵢ⟩ (with εᵢ = ±1 on
# the two checkerboard sublattices) is the natural AFM order
# parameter: it is zero in the paramagnet (every site equally
# unoccupied) and grows only once the sweep crosses δ = 0 and the
# blockade starts selecting the ε = +1 sublattice.

# %%
coords = np.stack(
    [np.asarray(q.as_array()) for q in reg.qubits.values()]
)
parity = np.array(
    [
        (-1) ** (round((c[0] - coords[0][0]) / spacing)
                 + round((c[1] - coords[0][1]) / spacing))
        for c in coords
    ]
)
n = len(coords)
# bit i of state index s, r-first convention: index 0 is |r...r>
bits = 1 - (
    (np.arange(2**n)[:, None] >> np.arange(n - 1, -1, -1)) & 1
)
times = sim.evaluation_times
order = []
for i in range(len(times)):
    st = np.asarray(results.states[i].full())[:, 0]
    probs = np.abs(st) ** 2
    occ = probs @ bits  # ⟨n_i⟩ per atom
    order.append(float(parity @ occ))
fig, ax = plt.subplots(figsize=(6, 3))
ax.plot(times, order, color="#b34f38")
ax.set_xlabel("t (µs)")
ax.set_ylabel("staggered magnetization Σ εᵢ⟨nᵢ⟩")
ax.set_title("AFM order builds up across the transition")
print("final staggered magnetization:", round(order[-1], 2))
assert abs(order[0]) < 0.1 and order[-1] > 3.5

# %% [markdown]
# ## Where to go next
#
# - `02_noisy_simulation` adds a realistic noise model to this exact
#   sequence and shows what a lab histogram looks like.
# - `tools/scale_ladder_torch.py` runs a short pulse at 24–26 atoms
#   on one card (dim up to 2^26), and with `--ceiling` at the largest
#   size the capacity contract admits on it
#   (`pulser_tpu_torch.parallel.capacity`). Beyond one card's memory,
#   `pulser_tpu_torch.parallel` shards the statevector over ranks.
# - The 16-atom version of this tutorial is AFM16, the first path
#   `chip_smoke.py` runs on the card.
