"""The sequence-building examples of ``examples_torch/`` run end to end.

Each script runs in a fresh interpreter on the CPU (``--device cpu``) and
is held to the lines ``tests/test_examples.py`` checks in its JAX
counterpart's output; no ``jax`` or ``pulser_tpu`` module may be loaded
when it exits. The emulation-heavy examples are in
``test_torch_examples_emulation.py``.
"""

from __future__ import annotations

import pytest
import torch

from torch_examples import run_example, run_ok


def test_eom_pulses_example():
    out = run_ok("eom_pulses.py")
    assert "round trip OK" in out
    assert "detuning_off chosen by the EOM physics" in out
    assert "final bitstrings" in out


def test_slm_mask_dmm_example():
    out = run_ok("slm_mask_dmm.py")
    assert "OK slm+dmm walkthrough complete" in out
    ratio = float(out.rsplit("q1/q0 DMM detuning ratio:", 1)[1].split()[0])
    assert abs(ratio - 0.5) < 1e-9


def test_parametrized_sequences_example():
    out = run_ok("parametrized_sequences.py")
    assert "OK parametrized-sequence walkthrough complete" in out
    assert "round trip: OK" in out
    err = float(out.rsplit("max |P - sin^2(theta/2)|:", 1)[1].split()[0])
    assert err < 1e-3


def test_interpolated_waveforms_example():
    out = run_ok("interpolated_waveforms.py")
    assert "OK interpolated-waveform walkthrough complete" in out
    assert "no overshoot" in out
    p_rr = float(out.rsplit("P(rr) =", 1)[1].split()[0])
    assert p_rr < 0.1


def test_phase_shifts_example():
    out = run_ok("phase_shifts_virtual_z.py")
    assert "OK phase-shift walkthrough complete" in out
    err = float(out.rsplit("max |P - sin^2(phi/2)|:", 1)[1].split()[0])
    assert err < 1e-3
    assert "(free gate)" in out


def test_register_layouts_example():
    out = run_ok("register_layouts.py")
    assert "OK register-layout walkthrough complete" in out
    assert "layout abstract-repr round trip: OK" in out


def test_virtual_devices_example():
    out = run_ok("virtual_devices.py")
    assert "OK virtual-device walkthrough complete" in out
    assert "caps lifted" in out


def test_serialization_example():
    out = run_ok("serialization_walkthrough.py")
    assert "OK serialization walkthrough complete" in out
    assert "schema violation rejected: SchemaValidationError" in out
    assert "legacy coder round trip: OK" in out


def test_qpu_execution_example():
    out = run_ok("qpu_execution.py")
    assert "OK qpu-execution walkthrough complete" in out
    p00 = float(out.rsplit("P(00) =", 1)[1].split()[0])
    assert p00 < 0.05


def test_rydberg_blockade_intro_example():
    out = run_ok("rydberg_blockade_intro.py")
    assert "blockade physics OK" in out
    assert "P(rr) far apart" in out


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
@pytest.mark.parametrize(
    "example", ["rydberg_blockade_intro.py", "register_layouts.py"]
)
def test_example_without_device_needs_a_card(example):
    """Without ``--device`` an example runs on the card: here, with none,
    it stops with the entry points' RuntimeError before any output."""
    rc, stdout, stderr = run_example(example, device=None)
    assert rc != 0
    assert "RuntimeError: No CUDA device is visible" in stderr
    assert stdout == ""
