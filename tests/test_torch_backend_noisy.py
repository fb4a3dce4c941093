"""TorchBackendV2 against TpuBackendV2 under stochastic noise.

The noisy scenarios of ``tests/test_backend_v2.py``, defined with the
others in ``tests/test_torch_backend.py`` and run here so that the two
files share the time: the device's noise model, the stochastic-noise
equivalence with the legacy API, the exact SPAM aggregation, the
normalization under amplitude noise and the fresh draws of a second
run. Both packages run on the same inputs and numpy seed, the port in
complex128 on the CPU, the JAX package on one device; results within
1e-6, seeded counts equal, register noise included. NOISY10's own route (the
row-batched quantum-jump solve, single precision) is checked at 4 atoms
against the JAX package's rows kernel in interpret mode.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import test_torch_backend as B
from torch_parity import assert_parity

from pulser_tpu_torch.ops import solver as torch_solver

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _one_jax_device(monkeypatch):
    """The JAX package on one device (no trajectory sharding), as the
    port runs."""
    monkeypatch.setenv("PULSER_TPU_DISABLE_SHARDING", "1")


@pytest.mark.parametrize("name", list(B.V2_NOISY_SCENARIOS))
def test_backend_v2_noisy_parity(name):
    """The noisy scenarios of tests/test_backend_v2.py, in both
    packages."""
    B.check_v2(B.V2_NOISY_SCENARIOS[name])


@pytest.mark.parametrize("name", list(B.REGISTER_NOISE_SCENARIOS))
def test_register_noise_is_refused(name):
    """Register noise (once refused, hence the name) in both packages:
    the jittered positions, the density matrix and the occupations of
    the same seeded trajectories."""
    B.check_v2(B.REGISTER_NOISE_SCENARIOS[name])


def test_noisy_observables_match_on_the_row_batched_route(monkeypatch):
    """NOISY10's route at 4 atoms (dephasing with SPAM, amplitude and
    Doppler noise: one quantum-jump realization per trajectory, the
    states aggregated into a density matrix), in single precision as the
    card runs it, against the JAX package's rows kernel in interpret
    mode: equal seeded counts, the rest within 1e-5."""
    import jax

    monkeypatch.setenv("PULSER_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PULSER_TPU_MCWF_ROWS", "1")
    jax.config.update("jax_enable_x64", False)

    def case(ns):
        P = ns.pkg
        reg = P.Register.rectangle(2, 2, spacing=7.0, prefix="q")
        seq = P.Sequence(reg, P.MockDevice)
        seq.declare_channel("ryd", "rydberg_global")
        seq.add(P.Pulse.ConstantPulse(400, 2 * np.pi, -1.0, 0.0), "ryd")
        noise = P.NoiseModel(
            dephasing_rate=0.08,
            amp_sigma=0.02,
            temperature=40,
            state_prep_error=0.05,
            p_false_pos=0.01,
            p_false_neg=0.02,
        )
        O = ns.obs
        config = B._config(
            ns,
            observables=[
                O.Occupation(evaluation_times=[0.5, 1.0]),
                O.Energy(evaluation_times=[1.0]),
                O.StateResult(evaluation_times=[1.0]),
                O.BitStrings(evaluation_times=[1.0], num_shots=400),
            ],
            noise_model=noise,
            n_trajectories=8,
        )
        return ns.BackendV2(seq, config=config).run()

    try:
        assert_parity(case, tol=1e-5, double=False)
    finally:
        jax.config.update("jax_enable_x64", True)
    assert torch_solver.last_solve_info["kind"] == "mcwf_rows_torch"


