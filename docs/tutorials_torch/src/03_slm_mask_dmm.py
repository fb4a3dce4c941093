# %% [markdown]
# # Local addressing: SLM masks and detuning maps (DMM)
#
# Global channels drive every atom identically — but real
# experiments need LOCAL control: shield some atoms from a pulse,
# bias the energy of others. Neutral-atom hardware offers two
# optical tools, both modeled here exactly as in the reference
# (`pulser-core/pulser/channels/dmm.py`, the SLM logic in
# `sequence/sequence.py`):
#
# - A **DMM** (Detuning Map Modulator) projects a light pattern that
#   shifts each atom's detuning by `weight_i · δ_dmm(t)`, with the
#   per-trap weights in [0, 1] declared as a `DetuningMap`. Only
#   NEGATIVE detunings are allowed — light shifts push energy down.
# - An **SLM mask** (Spatial Light Modulator) shields chosen atoms
#   from the FIRST global pulse. In Ising mode there is no physical
#   shutter per atom: the mask is implemented as a large negative
#   DMM detuning (−10·Ω_max) that detunes the masked atoms far out
#   of resonance for the duration of that pulse.
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
from pulser_tpu_torch.sampler import sample

# %% [markdown]
# ## Declaring a detuning map
#
# A 2×2 register; the map gives q0 the full DMM effect, q1 half, and
# nothing to q2/q3. `Register.define_detuning_map` matches qubits to
# trap weights.

# %%
reg = ptt.Register.square(2, spacing=8.0, prefix="q")
weights = {"q0": 1.0, "q1": 0.5, "q2": 0.0, "q3": 0.0}
detuning_map = reg.define_detuning_map(weights)
detuning_map.draw(show=False)

# %% [markdown]
# ## Composing the sequence
#
# Three channels: the global Rydberg drive, a local Raman (digital
# basis) channel targeting q0, and the DMM configured with our map.
# `config_slm_mask(["q2", "q3"])` arms the mask — it fires on the
# first global pulse added afterwards.

# %%
seq = ptt.Sequence(reg, ptt.MockDevice)
seq.declare_channel("ryd", "rydberg_global")
seq.declare_channel("raman", "raman_local", initial_target="q0")
seq.config_detuning_map(detuning_map, "dmm_0")
seq.config_slm_mask(["q2", "q3"])

# The masked (first) global pulse: only q0/q1 respond.
seq.add(ptt.Pulse.ConstantPulse(400, 2 * np.pi, 0.0, 0.0), "ryd")
# DMM detuning: -4 rad/µs, scaled per qubit by the map's weights.
seq.add_dmm_detuning(ptt.ConstantWaveform(400, -4.0), "dmm_0")
# A local π pulse on q0 in the digital (hyperfine) basis.
seq.add(
    ptt.Pulse.ConstantDetuning(
        ptt.BlackmanWaveform(500, np.pi), 0.0, 0.0
    ),
    "raman",
)
print("duration:", seq.get_duration(), "ns")
print("channels:", sorted(seq.declared_channels))
seq.draw(mode="input", draw_detuning_maps=False, show=False)

# %% [markdown]
# ## What the hardware actually plays
#
# `sample()` lowers the sequence to per-qubit time series — the
# ground truth the emulator (and the QPU) consumes. Three things to
# verify:
#
# 1. masked qubits carry the −10·Ω_max shielding detuning during the
#    first pulse's window;
# 2. the DMM detuning lands weighted (q1 gets exactly half of q0);
# 3. the Raman pulse appears only on q0's digital-basis row.

# %%
samples = sample(seq)
nested = samples.to_nested_dict()
slm_end = samples._slm_mask.end
print(
    f"SLM window: 0-{slm_end} ns on {sorted(samples._slm_mask.targets)}"
)
det_q2 = np.asarray(nested["Local"]["ground-rydberg"]["q2"]["det"])
assert det_q2[:slm_end].min() < -10
det_q0 = np.asarray(nested["Local"]["ground-rydberg"]["q0"]["det"])
det_q1 = np.asarray(nested["Local"]["ground-rydberg"]["q1"]["det"])
ratio = det_q1.sum() / det_q0.sum()
print(f"q1/q0 DMM detuning ratio: {ratio:.3f}  (weights 0.5/1.0)")
assert abs(ratio - 0.5) < 1e-9
amp_raman = np.asarray(nested["Local"]["digital"]["q0"]["amp"])
assert amp_raman.max() > 0

fig, ax = plt.subplots(figsize=(7, 3))
t = np.arange(len(det_q0))
ax.plot(t, det_q0, label="q0 (weight 1.0)", color="#4469ab")
ax.plot(t, det_q1, label="q1 (weight 0.5)", color="#c98a28")
ax.plot(t, det_q2, label="q2 (masked)", color="#b34f38")
ax.set_xlabel("t (ns)")
ax.set_ylabel("detuning (rad/µs)")
ax.set_title("Per-qubit detuning: SLM shielding + weighted DMM")
ax.legend()

# %% [markdown]
# The picture tells the whole story: q2 (and q3) sit at −10·Ω_max ≈
# −73 rad/µs during the masked pulse — far out of resonance — while
# q0 and q1 see the weighted −4 and −2 rad/µs DMM bias.
#
# ## Emulating
#
# The emulator consumes the same lowered samples; the masked qubits
# stay in `g` through the first pulse while q0/q1 undergo (detuned)
# Rabi flopping, and the Raman pulse moves q0's ground population to
# the hyperfine level `h` in the `all`-basis simulation.

# %%
sim = TorchEmulator.from_sequence(seq, torch_device=DEVICE)
res = sim.run()
counts = res.sample_final_state(1000)
print("top outcomes:", counts.most_common(3))
norm = float(np.linalg.norm(np.asarray(res.get_final_state().full())))
assert abs(norm - 1) < 1e-5

# %% [markdown]
# ## Notes for device runs
#
# - `WeightedAnalogDevice` (a realistic DMM-equipped device) enforces
#   DMM limits: `bottom_detuning` per qubit, `total_bottom_detuning`
#   across the register — `add_dmm_detuning` validates against them.
# - The mask is a one-shot: it applies to the first global Ising
#   pulse only. In XY mode the SLM instead removes masked qubits
#   from the interaction during that window.
# - Everything here serializes: `seq.to_abstract_repr()` round-trips
#   the detuning map, the mask and the DMM pulses (tutorial
#   `serialization_walkthrough` in `examples/`).
