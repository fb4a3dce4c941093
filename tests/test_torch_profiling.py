"""The port's phase timing and tracing against the JAX package's.

``pulser_tpu_torch/profiling.py`` keeps ``pulser_tpu/profiling.py``'s
registry (lock-guarded wall-clock totals and call counts per phase) and
marks each phase with ``torch.profiler.record_function``. The emulator's
phases carry the JAX package's names: for the same scenario both
packages report the same set of phases, where a route differs by design
the test names the difference.
"""

from __future__ import annotations

import json
import sys
import threading
import time
import warnings

import numpy as np
import pytest
import torch

import pulser_tpu
import pulser_tpu.emulator
import pulser_tpu.profiling
import pulser_tpu_torch
import pulser_tpu_torch.emulator
from pulser_tpu_torch import profiling

torch.set_num_threads(1)


def test_profiling_phases_recorded():
    """Phase timings accumulate around emulator solves and annotate
    traces; the report exposes totals and call counts (the counterpart
    of ``tests/test_emulator.py::test_profiling_phases_recorded``)."""
    profiling.reset_phases()
    reg = pulser_tpu_torch.Register({"q0": (0, 0), "q1": (0, 8)})
    seq = pulser_tpu_torch.Sequence(reg, pulser_tpu_torch.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(pulser_tpu_torch.Pulse.ConstantPulse(200, 1.0, 0.0, 0.0), "ryd")
    from pulser_tpu_torch.emulator.simulation import TorchEmulator

    TorchEmulator.from_sequence(seq, torch_device="cpu").run()
    report = profiling.phase_report()
    assert report["emulator.build_plan"]["calls"] >= 1
    assert report["emulator.sesolve"]["total_s"] > 0
    profiling.reset_phases()
    assert profiling.phase_report() == {}


def test_nested_phases_and_reset():
    profiling.reset_phases()
    with profiling.phase("outer"):
        for _ in range(3):
            with profiling.phase("inner"):
                time.sleep(0.002)
    report = profiling.phase_report(reset=True)
    assert report["outer"]["calls"] == 1.0
    assert report["inner"]["calls"] == 3.0
    assert report["inner"]["total_s"] >= 0.006
    assert report["outer"]["total_s"] >= report["inner"]["total_s"]
    assert profiling.phase_report() == {}


def test_phase_records_when_the_block_raises():
    profiling.reset_phases()
    with pytest.raises(ValueError):
        with profiling.phase("failing"):
            raise ValueError("inside")
    assert profiling.phase_report(reset=True)["failing"]["calls"] == 1.0


def test_phases_from_threads_all_count():
    """The registry is shared and lock-guarded: phases timed in more
    threads than cores, switching as often as the interpreter allows, all
    land in it (a lost update would lose a call)."""
    profiling.reset_phases()
    n_threads, n_calls = 16, 200
    barrier = threading.Barrier(n_threads)

    def work(i: int) -> None:
        barrier.wait()
        for _ in range(n_calls):
            with profiling.phase("shared"):
                with profiling.phase(f"own{i}"):
                    pass

    threads = [
        threading.Thread(target=work, args=(i,)) for i in range(n_threads)
    ]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    report = profiling.phase_report(reset=True)
    assert report["shared"]["calls"] == n_threads * n_calls
    for i in range(n_threads):
        assert report[f"own{i}"]["calls"] == n_calls


def test_trace_on_the_cpu_writes_a_chrome_trace(tmp_path):
    from pulser_tpu_torch.emulator import TorchEmulator

    seq = _seq(pulser_tpu_torch)
    with profiling.trace(str(tmp_path), device="cpu"):
        TorchEmulator.from_sequence(seq, torch_device="cpu").run()
    events = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert "emulator.sesolve" in names
    assert "emulator.build_plan" in names


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_trace_without_a_card_raises(tmp_path):
    with pytest.raises(RuntimeError, match="No CUDA device is visible"):
        with profiling.trace(str(tmp_path / "t")):
            pass
    assert not (tmp_path / "t").exists()


# -- the same scenario through both packages ------------------------------


def _seq(P):
    reg = P.Register.rectangle(1, 3, spacing=8.0, prefix="q")
    seq = P.Sequence(reg, P.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(
        P.Pulse.ConstantDetuning(P.BlackmanWaveform(500, np.pi), -2.0, 0.0),
        "ryd",
    )
    return seq


def _noiseless(P):
    return {}


def _jumps(P):
    """Dephasing with shot-to-shot noise: the batched quantum jumps."""
    return dict(
        noise_model=P.NoiseModel(
            dephasing_rate=0.05, amp_sigma=0.02, runs=5, samples_per_run=2
        ),
        evaluation_times="Minimal",
    )


def _pure_batch(P):
    """Shot-to-shot noise without collapse operators: the pure-state
    batch."""
    return dict(
        noise_model=P.NoiseModel(
            amp_sigma=0.02, p_false_pos=0.01, runs=5, samples_per_run=2
        ),
        evaluation_times="Minimal",
    )


def _mesolve(P):
    """Dephasing alone: the master equation of one density matrix."""
    return dict(noise_model=P.NoiseModel(dephasing_rate=0.1))


#: (scenario, emulator options as a function of the package namespace,
#: phases only the port reports, with why)
SCENARIOS = [
    ("noiseless", _noiseless, set()),
    ("noisy_jumps", _jumps, set()),
    # The port times the pure-state batch's plan as both packages time
    # the quantum-jump batch's; the JAX package leaves it unmarked
    ("noisy_pure_batch", _pure_batch, {"emulator.build_plan_batched"}),
    ("mesolve", _mesolve, set()),
]


def _phases(P, prof, emulator_cls, options, device_kw) -> set[str]:
    prof.reset_phases()
    np.random.seed(7)
    emu = emulator_cls.from_sequence(_seq(P), **options(P), **device_kw)
    with warnings.catch_warnings():
        # A noisy run's results resample their counts, and say so
        warnings.simplefilter("ignore", UserWarning)
        emu.run().sample_final_state(100)
    return set(prof.phase_report(reset=True))


@pytest.mark.parametrize(
    "options,port_only", [s[1:] for s in SCENARIOS], ids=[s[0] for s in SCENARIOS]
)
def test_phase_names_equal_the_jax_packages(monkeypatch, options, port_only):
    monkeypatch.setenv("PULSER_TPU_DISABLE_SHARDING", "1")
    want = _phases(
        pulser_tpu,
        pulser_tpu.profiling,
        pulser_tpu.emulator.TpuEmulator,
        options,
        {},
    )
    got = _phases(
        pulser_tpu_torch,
        profiling,
        pulser_tpu_torch.emulator.TorchEmulator,
        options,
        {"torch_device": "cpu"},
    )
    assert want and all(name.startswith("emulator.") for name in got)
    assert got - port_only == want
    assert port_only <= got
