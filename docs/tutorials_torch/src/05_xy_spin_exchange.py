# %% [markdown]
# # XY mode: dipolar spin exchange
#
# Everything so far used the Ising (ground-rydberg) basis, where the
# van-der-Waals C6/r⁶ interaction is DIAGONAL — atoms shift each
# other's energies but never exchange state. Encoding the qubit in
# TWO Rydberg levels {u, d} instead unlocks the resonant
# dipole-dipole interaction: a genuine flip-flop term
#
#     H_XY = Σᵢ<ⱼ  (C3/Rᵢⱼ³)·(1 − 3cos²θᵢⱼ)/2 · (σᵢ⁺σⱼ⁻ + σᵢ⁻σⱼ⁺)
#
# that HOPS excitations between atoms — the XY spin model. Two
# things distinguish it from the Ising case:
#
# - 1/r³ range (much longer than 1/r⁶), and
# - the angular factor (1 − 3cos²θ): θ is the angle between the
#   interatomic axis and the magnetic field, so ORIENTING the field
#   tunes interactions, even to zero at the magic angle 54.7°.
#
# Declaring a microwave channel puts the sequence in XY mode;
# `set_magnetic_field` fixes the quantization axis (reference
# physics: `pulser_simulation/hamiltonian.py`, `make_xy_term`).
#
# This page runs on `pulser_tpu_torch`, the PyTorch package; its
# emulators take `torch_device=DEVICE`, the torch device
# `tools/build_tutorials_torch.py` puts into the cells' namespace
# (`cuda` by default; this page was built with `--device cpu`).

# %%
import matplotlib.pyplot as plt
import numpy as np

import pulser_tpu_torch as ptt
from pulser_tpu_torch.emulator import TorchEmulator

reg = ptt.Register(
    {"q0": (0.0, 0.0), "q1": (8.0, 0.0), "q2": (16.0, 0.0)}
)
seq = ptt.Sequence(reg, ptt.MockDevice)
# Field perpendicular to the chain: cos θ = 0, full-strength exchange
seq.set_magnetic_field(0.0, 0.0, 30.0)
seq.declare_channel("mw", "mw_global")
u_nn = ptt.MockDevice.interaction_coeff_xy / 8.0**3
print(f"nearest-neighbour exchange U = {u_nn:.3f} rad/µs")
print(f"expected hop period ~ pi/U = {np.pi / u_nn:.3f} µs")

# %% [markdown]
# ## Free spin exchange
#
# No drive at all — a zero-amplitude pulse just keeps the channel's
# clock running while the interaction does the work. We start from
# |duu⟩ (one flipped spin at the chain end) and watch the excitation
# hop coherently.

# %%
seq.add(ptt.Pulse.ConstantPulse(400, 0.0, 0.0, 0.0), "mw")
eval_times = np.linspace(0, seq.get_duration() * 1e-3, 51)
sim = TorchEmulator.from_sequence(
    seq, evaluation_times=eval_times, torch_device=DEVICE
)
psi0 = np.zeros(8, dtype=complex)
psi0[0b100] = 1.0  # q0 in d, q1/q2 in u  ([u, d] ordering)
sim.set_initial_state(psi0)
res = sim.run()

# %% [markdown]
# Track each atom's d-state occupation ⟨nᵢ_d⟩ through time with the
# results' `expect` API. The excitation sloshes from q0 toward q2
# and back; the total Σᵢ⟨nᵢ_d⟩ stays exactly 1 — H_XY conserves the
# number of flipped spins (U(1) symmetry), unlike the Ising drive.

# %%
n_ops = []
for q in range(3):
    mats = [np.eye(2, dtype=complex)] * 3
    mats[q] = np.diag([0.0, 1.0]).astype(complex)  # |d><d|
    full = mats[0]
    for m in mats[1:]:
        full = np.kron(full, m)
    n_ops.append(full)
occ = np.real(np.array(res.expect(n_ops)))  # (3, n_times)
total = occ.sum(axis=0)
print(f"total flipped spins: {total[-1]:.6f} (conserved)")
assert np.all(np.abs(total - 1) < 1e-5)
assert occ[1].max() > 0.3  # the excitation really hops

fig, ax = plt.subplots(figsize=(7, 3))
for row, (label, color) in zip(
    occ,
    [("q0", "#4469ab"), ("q1", "#c98a28"), ("q2", "#b34f38")],
):
    ax.plot(eval_times, row, label=label, color=color)
ax.set_xlabel("t (µs)")
ax.set_ylabel("⟨n_d⟩")
ax.set_title("Spin exchange along a 3-atom chain")
ax.legend()

# %% [markdown]
# ## Steering interactions with the field angle
#
# Tilt the magnetic field INTO the chain axis and the (1 − 3cos²θ)
# factor shrinks the exchange — at θ = 0 (field along the chain) it
# flips sign at double strength... and at the magic angle it
# vanishes. Compare the q1 occupation after the same evolution for
# three field orientations.

# %%
def exchange_run(bx, by, bz):
    s = ptt.Sequence(reg, ptt.MockDevice)
    s.set_magnetic_field(bx, by, bz)
    s.declare_channel("mw", "mw_global")
    s.add(ptt.Pulse.ConstantPulse(400, 0.0, 0.0, 0.0), "mw")
    sm = TorchEmulator.from_sequence(
        s, evaluation_times=eval_times,
        torch_device=DEVICE,
    )
    sm.set_initial_state(psi0)
    r = sm.run()
    return np.real(np.array(r.expect([n_ops[1]])))[0]

along = exchange_run(30.0, 0.0, 0.0)  # field along the chain
perp = occ[1]
magic = exchange_run(
    30.0 * np.cos(np.deg2rad(54.7356)),
    0.0,
    30.0 * np.sin(np.deg2rad(54.7356)),
)
print(f"max q1 occupation  perp: {perp.max():.3f}"
      f"  along: {along.max():.3f}  magic angle: {magic.max():.4f}")
assert magic.max() < 0.01  # interactions switched off

fig, ax = plt.subplots(figsize=(7, 3))
ax.plot(eval_times, perp, label="θ=90° (full)", color="#4469ab")
ax.plot(eval_times, along, label="θ=0° (−2× sign-flipped)",
        color="#c98a28")
ax.plot(eval_times, magic, label="magic angle (off)",
        color="#b34f38")
ax.set_xlabel("t (µs)")
ax.set_ylabel("⟨n_d⟩ on q1")
ax.set_title("The field angle tunes the dipolar exchange")
ax.legend()

# %% [markdown]
# ## Notes
#
# - In XY mode an SLM mask physically removes masked atoms from the
#   interaction during the first pulse (there is no detuning trick
#   to hide behind) — the emulator models that as a time-dependent
#   masked/unmasked interaction pair, exactly like the reference.
# - Microwave channels drive the u↔d transition directly; add
#   finite-amplitude pulses to combine drive and exchange.
