# %% [markdown]
# # Simulating a noisy device
#
# A lab device is not a closed quantum system. This walkthrough
# builds up the framework's `NoiseModel` — the same 12-channel
# taxonomy as the reference (`pulser-core/pulser/noise_model.py`) —
# and shows how each noise class routes to a different solver:
#
# | noise class | examples | solver path |
# |---|---|---|
# | decoherence (Lindblad) | dephasing, relaxation, depolarizing, eff_noise | master equation (`mesolve`) |
# | shot-to-shot stochastic | doppler, amplitude σ, register jitter | one batched solve of every trajectory |
# | both at once | e.g. dephasing + doppler | one quantum-jump (MCWF) realization per noise trajectory, batched on-device |
# | measurement | SPAM: η, ε, ε′ | bitstring resampling / flips |
#
# The reference loops its trajectories serially through QuTiP
# (`pulser-simulation/pulser_simulation/simulation.py:848-861`); here
# the whole batch integrates in ONE batched solve, and on the card the
# quantum-jump batch is one launch of a hand-written kernel (section
# 3). The emulators run on `DEVICE`, the torch device
# `tools/build_tutorials_torch.py` gives the cells (`cuda` by default;
# this page was built with `--device cpu`).

# %%
import matplotlib.pyplot as plt
import numpy as np

import pulser_tpu_torch as ptt
from pulser_tpu_torch.emulator import TorchEmulator

reg = ptt.Register.square(2, spacing=7.0, prefix="q")


def rabi_seq(t_ns=800):
    seq = ptt.Sequence(reg, ptt.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(
        ptt.Pulse.ConstantPulse(t_ns, 2 * np.pi, 0.0, 0.0), "ryd"
    )
    return seq

# %% [markdown]
# ## 1. Decoherence: the master equation
#
# `dephasing_rate` and `relaxation_rate` declare Lindblad jump
# operators; with no stochastic noise present the emulator solves
# the master equation dρ/dt = −i[H,ρ] + Σ LρL† − ½{L†L,ρ} once. The
# tell-tale signature: the state purity Tr ρ² decays from 1 while
# the trace stays exactly 1.

# %%
nm_deph = ptt.NoiseModel(dephasing_rate=0.3, relaxation_rate=0.05)
print("active noise types:", nm_deph.noise_types)
sim = TorchEmulator.from_sequence(
    rabi_seq(), noise_model=nm_deph, evaluation_times="Full",
    torch_device=DEVICE,
)
res = sim.run()
rho = res.get_final_state().full()
print(f"trace:  {np.trace(rho).real:.6f}")
print(f"purity: {np.real(np.trace(rho @ rho)):.4f}")
assert abs(np.trace(rho).real - 1) < 1e-6
assert np.real(np.trace(rho @ rho)) < 0.99

# %% [markdown]
# Watch dephasing damp the Rabi oscillation. The occupation of the
# Rydberg state rings at Ω but its envelope decays — each Lindblad
# dephasing event scrambles the phase coherence the drive needs.

# %%
times = sim.evaluation_times
dim = 2 ** len(reg.qubit_ids)
half = dim // 2  # r-first ordering: q0 = r on the first half
occ_noisy = [
    float(
        np.real(
            np.trace(
                np.asarray(res.states[i].full())[:half, :half]
            )
        )
    )
    for i in range(len(times))
]
sim0 = TorchEmulator.from_sequence(
    rabi_seq(), evaluation_times="Full",
    torch_device=DEVICE,
)
res0 = sim0.run()
occ_clean = [
    float(
        np.sum(
            np.abs(np.asarray(res0.states[i].full())[:half, 0])
            ** 2
        )
    )
    for i in range(len(times))
]
fig, ax = plt.subplots(figsize=(6.5, 3))
ax.plot(times, occ_clean, label="noiseless", color="#9a9a9a")
ax.plot(times, occ_noisy, label="dephasing + relaxation",
        color="#b34f38")
ax.set_xlabel("t (µs)")
ax.set_ylabel("P(q0 = r)")
ax.set_title("Dephasing damps the Rabi oscillation")
ax.legend()

# %% [markdown]
# ## 2. Shot-to-shot noise: Monte-Carlo trajectories
#
# `amp_sigma` draws one laser-amplitude scale factor per run;
# `laser_waist` applies the Gaussian beam profile across the
# register; `temperature` draws per-atom Doppler detunings. None of
# these decohere a single run — each run is a coherent evolution
# under slightly wrong parameters — so the emulator integrates
# `runs` trajectories as one batch and aggregates the
# sampled bitstrings.

# %%
nm_traj = ptt.NoiseModel(
    amp_sigma=0.05,
    laser_waist=120.0,
    temperature=30.0,
    runs=60,
    samples_per_run=5,
)
print("active noise types:", nm_traj.noise_types)
np.random.seed(7)
sim2 = TorchEmulator.from_sequence(
    rabi_seq(), noise_model=nm_traj, evaluation_times="Minimal",
    torch_device=DEVICE,
)
counts = sim2.run().results[-1]
print("aggregate over 60 trajectories x 5 samples:")
for k, v in sorted(counts.items(), key=lambda kv: -kv[1])[:4]:
    print(f"  {k}: {v:.3f}")

# %% [markdown]
# ## 3. Decoherence + stochastic noise: quantum jumps
#
# Mixing the two classes would need one master-equation solve per
# trajectory — quadratically expensive in the state. Instead the
# emulator follows the reference's auto-selection and runs one
# quantum-jump (MCWF) realization per noise trajectory: evolve with
# the non-Hermitian H_eff = H − (i/2)Σ L†L, jump when the norm
# crosses a uniform draw. On the card the entire batch — the jumps on
# pre-drawn uniforms included — is one launch of the hand-written
# kernel `pulser_tpu_torch/csrc/mcwf_rows.cu`, and the measurement
# draw follows on the device; on the CPU the kernel's plain twin, a
# torch scan, does the same arithmetic.

# %%
nm_both = ptt.NoiseModel(
    dephasing_rate=0.08,
    amp_sigma=0.03,
    temperature=30.0,
    runs=60,
    samples_per_run=5,
)
np.random.seed(7)
sim3 = TorchEmulator.from_sequence(
    rabi_seq(), noise_model=nm_both, evaluation_times="Minimal",
    torch_device=DEVICE,
)
counts3 = sim3.run().results[-1]
print("MCWF aggregate:")
for k, v in sorted(counts3.items(), key=lambda kv: -kv[1])[:4]:
    print(f"  {k}: {v:.3f}")

# %% [markdown]
# ## 4. SPAM: what the camera actually sees
#
# State Preparation And Measurement errors act on the classical
# record: with probability η an atom is badly prepared (and behaves
# as absent), a ground atom reads out as excited with probability ε
# (false positive), an excited one as ground with ε′. The histogram
# acquires a floor of single-bit-flipped neighbours of the true
# outcomes.

# %%
nm_spam = ptt.NoiseModel(
    state_prep_error=0.01, p_false_pos=0.05, p_false_neg=0.02,
    runs=60, samples_per_run=5,
)
np.random.seed(7)
sim4 = TorchEmulator.from_sequence(
    rabi_seq(), noise_model=nm_spam, evaluation_times="Minimal",
    torch_device=DEVICE,
)
counts4 = sim4.run().results[-1]

labels = sorted(
    set(counts3) | set(counts4),
    key=lambda k: -(counts3.get(k, 0) + counts4.get(k, 0)),
)[:8]
x = np.arange(len(labels))
fig, ax = plt.subplots(figsize=(7, 3))
ax.bar(x - 0.2, [counts3.get(k, 0) for k in labels], 0.4,
       label="dephasing + shot-to-shot", color="#4469ab")
ax.bar(x + 0.2, [counts4.get(k, 0) for k in labels], 0.4,
       label="SPAM", color="#c98a28")
ax.set_xticks(x, labels, rotation=45)
ax.set_ylabel("probability")
ax.set_title("Noise classes reshape the histogram differently")
ax.legend()

# %% [markdown]
# ## Reproducibility
#
# Trajectory draws come from the host numpy RNG, so a fixed
# `np.random.seed` makes a noisy run reproducible end-to-end —
# the same contract the reference's seeded tests rely on
# (`tests/test_emulator_behavior.py` pins exact seeded histograms).

# %%
np.random.seed(123)
a = TorchEmulator.from_sequence(
    rabi_seq(), noise_model=nm_both, evaluation_times="Minimal",
    torch_device=DEVICE,
).run().results[-1]
np.random.seed(123)
b = TorchEmulator.from_sequence(
    rabi_seq(), noise_model=nm_both, evaluation_times="Minimal",
    torch_device=DEVICE,
).run().results[-1]
assert a == b
print("seeded runs identical:", a == b)
