"""The emulation examples of ``examples_torch/`` run end to end.

Each script runs in a fresh interpreter on the CPU (``--device cpu``) and
is held to the lines ``tests/test_examples.py`` checks in its JAX
counterpart's output; no ``jax`` or ``pulser_tpu`` module may be loaded
when it exits. The three examples the JAX file marks slow are slow here.
"""

from __future__ import annotations

import pytest

from torch_examples import run_example, run_ok


def test_xy_spin_exchange_example():
    out = run_ok("xy_spin_exchange.py")
    assert "conserved" in out
    # Total flipped-spin number conserved at 1
    total = float(out.rsplit("total flipped spins:", 1)[1].split()[0])
    assert abs(total - 1.0) < 1e-6


@pytest.mark.slow
def test_afm_state_prep_example():
    out = run_ok("afm_state_prep.py", timeout=900)
    assert "checkerboard" in out.lower() or len(out) > 0


def test_mwis_qaa_example():
    out = run_ok("mwis_qaa.py", timeout=600)
    assert "OK mwis-qaa walkthrough complete" in out
    assert "QAA found the MWIS 0110" in out


@pytest.mark.slow
def test_qubo_qaa_example():
    out = run_ok("qubo_qaa.py", timeout=900)
    assert "OK qubo-qaa walkthrough complete" in out
    assert "QAA found 10001" in out


@pytest.mark.slow
def test_optimize_afm_preparation_example():
    out = run_ok("optimize_afm_preparation.py", timeout=900)
    assert "OK closed-loop optimization complete" in out
    baseline = float(
        out.rsplit("baseline Neel structure factor:", 1)[1].split()[0]
    )
    best = float(
        out.rsplit("optimized Neel structure factor:", 1)[1].split()[0]
    )
    assert best > baseline + 0.3


def test_cz_gate_blockade_example():
    out = run_ok("cz_gate_blockade.py", timeout=600)
    assert "CZ gate OK" in out
    assert "+1.000" in out and "-1.000" in out


def test_qaoa_qubo_example():
    out = run_ok("qaoa_qubo.py", timeout=600)
    assert "OK qaoa-qubo walkthrough complete" in out
    assert "P(ground configs)" in out


def test_effective_noise_channels_example():
    out = run_ok("effective_noise_channels.py")
    assert "eff_noise(sigma_z, rate/2) == dephasing(rate): OK" in out
    assert "hand-rolled relaxation via eff_noise: OK" in out


def test_xxz_hamiltonians_example():
    out = run_ok("xxz_hamiltonians.py", timeout=600)
    assert "XXZ engineering suppresses spin transport: OK" in out
    assert "magnetization conserved under free exchange: OK" in out


def test_noisy_simulation_example():
    """No JAX test runs this one; it shows the three noisy routes."""
    out = run_ok("noisy_simulation.py")
    trace = float(out.rsplit("mesolve: trace=", 1)[1].split()[0])
    assert abs(trace - 1.0) < 1e-5
    purity = float(out.rsplit("mesolve: purity=", 1)[1].split()[0])
    assert purity < 1.0
    assert "trajectories:" in out and "with SPAM:" in out


def test_distributed_statevector_demo_example(monkeypatch):
    """12 atoms over 2 CPU ranks, the sharding threshold lowered to 10:
    the demo's own lines, its sharded route asserted inside, and no JAX
    module loaded."""
    monkeypatch.setenv("PULSER_TPU_STATE_SHARD_MIN_QUBITS", "10")
    rc, out, err = run_example(
        "distributed_statevector_demo.py", timeout=300, extra=("12", "--ranks", "2")
    )
    assert rc == 0, err[-2000:]
    assert "devices: 2 (cpu)" in out
    assert "Hilbert-space dim: 2^12 = 4,096" in out
    norm = float(out.rsplit("final-state norm:", 1)[1].split()[0])
    assert abs(norm - 1.0) < 1e-5
    assert "OK: distributed statevector solve completed" in out
