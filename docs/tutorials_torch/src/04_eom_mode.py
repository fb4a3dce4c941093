# %% [markdown]
# # Nanosecond pulses: EOM mode
#
# A standard channel shapes its output through an AOM whose
# modulation bandwidth smears fast edges over ~100 ns. For digital-
# style gates you want square pulses with nanosecond switching — and
# that is what an EOM (electro-optic modulator) provides, at a
# price: while EOM mode is on, the channel can ONLY play square
# pulses at a fixed setpoint (Ω_on, δ_on), and when idle it does not
# go dark — it parks at a discrete `detuning_off` level determined
# by the EOM's beam physics.
#
# The framework models that physics exactly as the reference does
# (`pulser-core/pulser/channels/eom.py`): the EOM drives two beams
# with configurable lightshifts; switching "off" leaves a residual
# lightshift, so only a discrete set of off-detunings exists, and
# the channel picks the one closest to your
# `optimal_detuning_off`.
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

reg = ptt.Register({"q0": (-3.0, 0.0), "q1": (3.0, 0.0)})
seq = ptt.Sequence(reg, ptt.AnalogDevice)
seq.declare_channel("ryd", "rydberg_global")

# %% [markdown]
# ## Entering EOM mode
#
# `enable_eom_mode` fixes the setpoint. Ask the channel's EOM config
# what off-detunings are physically available at this amplitude —
# the chosen one is whichever lies closest to our requested −20.

# %%
amp_on = 2 * np.pi  # rad/µs
eom = seq.declared_channels["ryd"].eom_config
options = eom.detuning_off_options(amp_on, detuning_on=0.0)
print("available detuning_off levels:", np.round(options, 2))
seq.enable_eom_mode(
    "ryd", amp_on=amp_on, detuning_on=0.0,
    optimal_detuning_off=-20.0,
)
det_off = float(seq._schedule["ryd"].eom_blocks[-1].detuning_off)
print(f"chosen detuning_off: {det_off:.3f} rad/µs")
assert any(abs(det_off - o) < 1e-9 for o in options)

# %% [markdown]
# ## A spin-echo-style train
#
# Square pulses now switch in nanoseconds. Delays inside an EOM
# block are NOT free evolution: the atoms idle at `detuning_off`,
# accumulating phase at a known rate — so the echo pulse can fold
# that drift into its own phase with `correct_phase_drift=True`.
# `modify_eom_setpoint` closes the block and reopens it at a new
# amplitude (here: half) without leaving EOM mode.

# %%
seq.add_eom_pulse("ryd", duration=100, phase=0.0)
seq.delay(300, "ryd")  # idles at detuning_off, phase drifts
seq.modify_eom_setpoint("ryd", amp_on=amp_on / 2, detuning_on=0.0)
seq.add_eom_pulse(
    "ryd", duration=200, phase=np.pi, correct_phase_drift=True
)
seq.disable_eom_mode("ryd")
print("duration:", seq.get_duration(), "ns")
seq.draw(mode="input+output", show=False)

# %% [markdown]
# The drawer overlays the programmed squares (input) with the
# modulated expectation (output): inside the EOM block the edges are
# sharp; the enable/disable transitions carry the configured buffer
# times. Compare the ~ns EOM edges with what the SAME square pulse
# looks like through the standard modulator:

# %%
ch = seq.declared_channels["ryd"]
square = np.concatenate([np.zeros(20), np.full(100, amp_on),
                         np.zeros(20)])
std = np.asarray(ch.modulate(square, eom=False).as_array())
fast = np.asarray(ch.modulate(square, eom=True).as_array())
fig, ax = plt.subplots(figsize=(7, 3))
ax.plot(square, label="programmed", color="#9a9a9a", ls="--")
ax.plot(std, label="standard modulator", color="#b34f38")
ax.plot(fast, label="EOM", color="#4469ab")
ax.set_xlabel("t (ns)")
ax.set_ylabel("amplitude (rad/µs)")
ax.set_title("Square pulse: EOM vs standard modulation bandwidth")
ax.legend()

# %% [markdown]
# ## Wire format and emulation
#
# EOM blocks — including setpoint changes and phase-drift
# corrections — are first-class in the abstract representation, so
# the sequence round-trips to JSON and back bit-exactly, and the
# emulator reproduces the detuned idling.

# %%
s = seq.to_abstract_repr()
seq2 = ptt.Sequence.from_abstract_repr(s)
assert seq2.get_duration() == seq.get_duration()
print(f"abstract repr: {len(s)} bytes, round trip OK")
np.random.seed(0)
res = TorchEmulator.from_sequence(seq2, torch_device=DEVICE).run()
print("final bitstrings:", dict(res.sample_final_state(500)))
