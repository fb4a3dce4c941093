"""Effective noise channels: custom Lindblad operators via eff_noise.

``NoiseModel(eff_noise_opers=…, eff_noise_rates=…)`` accepts arbitrary
single-qudit collapse operators L with rates r, adding the dissipator
D[sqrt(r)·L] to the master equation — the escape hatch for noise
channels the built-in types don't cover (mirrors the reference's
"Simulating with effective noise channels" tutorial,
reference: tutorials/retired/).

Two demonstrations:

1. **Dephasing equivalence.** The built-in dephasing channel attaches
   L = sqrt(2·rate)·|r><r| per atom.  Since a Hermitian collapse
   operator is insensitive to identity shifts, eff_noise with the
   Pauli sigma_z (in the [r, g] eigenbasis ordering) at rate/2
   produces *exactly* the same evolution — verified below to the
   f32 solver tolerance.
2. **A custom amplitude-damping-like channel** sigma_gr (|g><r|,
   r -> g decay) at a chosen rate, i.e. hand-rolled relaxation.

Run:  python examples_torch/effective_noise_channels.py [--device cpu]
"""

from __future__ import annotations

import argparse
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


def make_seq() -> pt.Sequence:
    reg = pt.Register({"q0": (-3.0, 0.0), "q1": (3.0, 0.0)})
    seq = pt.Sequence(reg, pt.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(pt.Pulse.ConstantPulse(600, 2 * np.pi, 0.0, 0.0), "ryd")
    return seq


def final_rho(noise_model: pt.NoiseModel) -> np.ndarray:
    sim = TorchEmulator.from_sequence(
        make_seq(), noise_model=noise_model, torch_device=DEVICE
    )
    return np.asarray(sim.run().get_final_state().full())


# --- 1. eff_noise(sigma_z, rate/2) == built-in dephasing(rate) -------
gamma = 0.12  # 1/µs
rho_builtin = final_rho(pt.NoiseModel(dephasing_rate=gamma))

# Eigenbasis ordering for ground-rydberg is [r, g] (r first), so the
# Pauli z in that ordering is diag(+1, -1).
sigma_z = np.diag([1.0, -1.0]).astype(complex)
rho_eff = final_rho(
    pt.NoiseModel(
        eff_noise_opers=[sigma_z], eff_noise_rates=[gamma / 2]
    )
)

err = float(np.max(np.abs(rho_builtin - rho_eff)))
print(f"max |rho_dephasing - rho_eff_noise(sigma_z)| = {err:.2e}")
assert err < 1e-6, err
print("eff_noise(sigma_z, rate/2) == dephasing(rate): OK")

# --- 2. custom decay channel |g><r| ----------------------------------
sigma_gr = np.zeros((2, 2), dtype=complex)
sigma_gr[1, 0] = 1.0  # row g, column r in [r, g] ordering
rho_decay = final_rho(
    pt.NoiseModel(eff_noise_opers=[sigma_gr], eff_noise_rates=[0.8])
)
rho_relax = final_rho(pt.NoiseModel(relaxation_rate=0.8))
err2 = float(np.max(np.abs(rho_decay - rho_relax)))
print(f"max |rho_eff_noise(sigma_gr) - rho_relaxation| = {err2:.2e}")
assert err2 < 1e-6, err2
print("hand-rolled relaxation via eff_noise: OK")

# Purity drops below 1 under either channel: genuinely mixed states
purity = float(np.real(np.trace(rho_decay @ rho_decay)))
print(f"final purity under decay: {purity:.4f}")
assert purity < 0.999
