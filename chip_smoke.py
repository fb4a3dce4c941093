"""Drives the PyTorch/CUDA port once on one NVIDIA GPU and checks it.

Run from the root of the repository, on a machine with a CUDA card and
``nvcc``::

    python3 chip_smoke.py

Phases (each one raises on failure, and the script then exits non-zero):

1. Require a CUDA device; print the card's name and power limit.
2. Build the interaction-picture sesolve kernel
   (``pulser_tpu_torch/csrc/ip_sesolve.cu``) with nvcc for ``sm_90a``.
3. Hold the kernel against its plain PyTorch version on random inputs at
   n = 10, 13 and 16 qubits (2 segments x 8 steps): max |Δ| ≤ 1e-5.
4. Run the main path at full size: the 16-atom AFM sweep of ``bench.py``
   through ``TorchEmulator(...).run()`` with 101 evaluation times. The
   kernel must have been launched, and the mid-sweep and final states
   must reach 1 − F < 1e-6 against ``tests/goldens/afm16_final.npz``.
5. Time the kernel against its plain version on the sweep's own inputs
   (median of 3 warm solves each) and the whole warm ``run()``.

The line before the last is the kernel report, one JSON object; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.abspath(__file__))
_GOLDEN = os.path.join(_ROOT, "tests", "goldens", "afm16_final.npz")

#: Tolerance of the kernel against its plain version on random inputs:
#: both run in float32 with different summation orders and libm.
KERNEL_TOL = 1e-5
#: The same over the whole 16-atom sweep (about a thousand RK4 steps of
#: float32 rounding, accumulated differently by the two versions).
SWEEP_TOL = 1e-4
#: Required agreement with the golden states.
FIDELITY_TOL = 1e-6


def _ramp(duration: int, start: float, stop: float) -> np.ndarray:
    """``RampWaveform(duration, start, stop)`` samples."""
    slope = (stop - start) / (duration - 1)
    ramp = slope * np.arange(duration, dtype=float) + start
    return np.clip(ramp, *sorted([float(start), float(stop)]))


def _const(duration: int, value: float) -> np.ndarray:
    """``ConstantWaveform(duration, value)`` samples."""
    return value * np.ones(duration)


def afm16_inputs() -> tuple:
    """``(samples, register, device)`` of the 16-atom AFM sweep.

    The configuration of ``bench.py``'s ``build_afm_sequence``: a 4x4
    square register at 6 µm on ``MockDevice``, one global Rydberg
    channel, a 252 ns amplitude rise at δ0 = −2π·6, a 2700 ns detuning
    sweep to δf = 2π·2 at Ω = 2π·2 and a 252 ns fall, phase 0. Built
    from the waveform formulas directly, since the sequence builder is
    not ported yet.
    """
    import pulser_tpu_torch.math as pm
    from pulser_tpu_torch import MockDevice, Register
    from pulser_tpu_torch.interop import _TimeSlot
    from pulser_tpu_torch.sampler.samples import (
        ChannelSamples,
        SequenceSamples,
        _PulseTargetSlot,
    )

    omega_max = 2.0 * 2 * np.pi
    delta_0 = -6 * 2 * np.pi
    delta_f = 2 * 2 * np.pi
    t_rise, t_sweep, t_fall = 252, 2700, 252
    register = Register.square(4, spacing=6.0, prefix="q")
    qids = set(register.qubit_ids)
    amp = np.concatenate(
        [
            _ramp(t_rise, 0.0, omega_max),
            _const(t_sweep, omega_max),
            _ramp(t_fall, omega_max, 0.0),
        ]
    )
    det = np.concatenate(
        [
            _const(t_rise, delta_0),
            _ramp(t_sweep, delta_0, delta_f),
            _const(t_fall, delta_f),
        ]
    )
    edges = np.cumsum([0, t_rise, t_sweep, t_fall])
    channel = ChannelSamples(
        amp=pm.AbstractArray(amp),
        det=pm.AbstractArray(det),
        phase=pm.AbstractArray(np.zeros(len(amp))),
        slots=[
            _PulseTargetSlot(int(ti), int(tf), set(qids))
            for ti, tf in zip(edges[:-1], edges[1:])
        ],
        target_time_slots=[_TimeSlot("target", -1, 0, set(qids))],
    )
    samples = SequenceSamples(
        channels=["ryd"],
        samples_list=[channel],
        _ch_objs={"ryd": MockDevice.channels["rydberg_global"]},
        _basis_ref={"ground-rydberg": {q: ((0, 0.0),) for q in qids}},
    )
    return samples, register, MockDevice


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _fidelity(golden: np.ndarray, state: np.ndarray) -> float:
    a = golden / np.linalg.norm(golden)
    b = state / np.linalg.norm(state)
    return float(abs(np.vdot(a, b)) ** 2)


def random_kernel_inputs(
    n: int, seed: int, device, seg_len: int = 8
) -> tuple:
    """Random ip_sesolve inputs for 2 segments of ``seg_len`` steps on n
    qubits, made with numpy from ``seed``: ``(tensors, keywords)``."""
    import torch

    rng = np.random.default_rng(seed)
    n_col = 8 if n >= 15 else 7
    n_row = n - n_col
    rows, cols = 1 << n_row, 1 << n_col
    n_seg = 2
    stage = (n_seg, seg_len, 3, n)
    dts = rng.uniform(1e-3, 4e-3, (n_seg, seg_len, 1))
    dts[1, :2] = 0.0  # start padding of a short segment
    t0 = np.cumsum(dts.reshape(-1)).reshape(n_seg, seg_len) - dts[..., 0]
    t_stage = t0[..., None] + dts * np.array([0.0, 0.5, 1.0])
    psi0 = rng.normal(size=(2, rows, cols))
    psi0 /= np.linalg.norm(psi0)
    host = [
        rng.uniform(-6.0, 6.0, stage),
        rng.uniform(-6.0, 6.0, stage),
        rng.uniform(0.0, 2 * np.pi, stage),
        t_stage,
        dts,
        (t0[:, -1] + dts[:, -1, 0]).reshape(n_seg, 1, 1),
        rng.uniform(0.0, 2 * np.pi, (n_seg, 1, n)),
        rng.uniform(0.0, 400.0, (1, rows, cols)),
        psi0[0],
        psi0[1],
    ]
    tensors = [
        torch.from_numpy(np.ascontiguousarray(h, dtype=np.float32)).to(device)
        for h in host
    ]
    return tensors, dict(n_row=n_row, n_col=n_col, seg_len=seg_len)


def _median_seconds(fn, repeats: int = 3) -> float:
    import torch

    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def main() -> int:
    import torch

    # 1. The card
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import pulser_tpu_torch.ops.kernels as K
    from pulser_tpu_torch.emulator import TorchEmulator
    from pulser_tpu_torch.ops import solver as S

    card = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(
        "torch", torch.__version__, "cuda", torch.version.cuda,
        "python", sys.version.split()[0], flush=True,
    )
    device = torch.device("cuda")

    # 2. Build the kernel from the checkout's sources
    t0 = time.perf_counter()
    lib_path, log = K.build_ip_sesolve(verbose=True)
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s -> {os.path.relpath(lib_path, _ROOT)}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # 3. The kernel against its plain version on random inputs
    for n in (10, 13, 16):
        args, kw = random_kernel_inputs(n, seed=n, device=device)
        got = K.ip_sesolve(*args, **kw)
        torch.cuda.synchronize()
        want = K.ip_sesolve_reference(*args, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        print(f"ip_sesolve vs plain, n={n}: max|d| = {err:.3e}")
        _check(bool(torch.isfinite(got).all()), f"finite output, n={n}")
        _check(err <= KERNEL_TOL, f"n={n}: {err:.3e} > {KERNEL_TOL}")

    # 4. The main path at full size, counted
    samples, register, mock = afm16_inputs()
    eval_times = np.linspace(0, samples.max_duration * 1e-3, 101)
    golden = np.load(_GOLDEN)
    K.IP_SESOLVE_LAUNCHES = 0
    t0 = time.perf_counter()
    emu = TorchEmulator(
        samples, register, mock, evaluation_times=eval_times
    )
    res = emu.run()
    mid = res.states[50].full()[:, 0]
    fin = res.states[-1].full()[:, 0]
    cold_s = time.perf_counter() - t0
    launches = K.IP_SESOLVE_LAUNCHES
    info = dict(S.last_solve_info)
    print(f"main path: {info}, launches={launches}, cold {cold_s:.3f} s")
    _check(info.get("kind") == "ip_sesolve_cuda", "kernel route taken")
    _check(launches > 0, "ip_sesolve launched on the main path")
    for name, state in (("mid", mid), ("final", fin)):
        _check(state.shape == (1 << 16,), f"{name} state shape")
        _check(bool(np.isfinite(state).all()), f"{name} state finite")
    one_minus_f = {
        "mid": 1 - _fidelity(golden["mid_state"], mid),
        "final": 1 - _fidelity(golden["final_state"], fin),
    }
    print(f"1-F vs golden: {one_minus_f}")
    for name, value in one_minus_f.items():
        _check(value < FIDELITY_TOL, f"{name} 1-F {value:.3e}")

    # 5. Times at the sweep's own shapes, and the whole warm run
    plan = emu._plan_cache[1]
    psi0 = emu._initial_ket().astype(np.complex64)
    ham = emu._current_hamiltonian
    args, kw = S.ip_kernel_inputs(psi0, plan, ham.int_diag, 16, device)
    got = K.ip_sesolve(*args, **kw)
    want = K.ip_sesolve_reference(*args, **kw)
    torch.cuda.synchronize()
    sweep_err = float((got - want).abs().max())
    print(f"ip_sesolve vs plain on the sweep: max|d| = {sweep_err:.3e}")
    _check(sweep_err <= SWEEP_TOL, f"sweep: {sweep_err:.3e} > {SWEEP_TOL}")
    kernel_s = _median_seconds(lambda: K.ip_sesolve(*args, **kw))
    plain_s = _median_seconds(lambda: K.ip_sesolve_reference(*args, **kw))
    run_s = _median_seconds(
        lambda: emu.run().states[-1].full()
    )
    print(
        f"times on {card}: ip_sesolve {kernel_s * 1e3:.3f} ms,"
        f" plain {plain_s * 1e3:.3f} ms, warm run() {run_s * 1e3:.3f} ms"
        f" ({info['n_steps']} RK4 steps, {plan.seg_dts.shape[0]} segments)"
    )

    report = {
        "kernels": [
            {
                "name": "ip_sesolve",
                "route": "cuda",
                "source": "pulser_tpu_torch/csrc/ip_sesolve.cu",
                "replaces": "pulser_tpu/ops/pallas_kernels.py:112",
                "launches": launches,
                "max_abs_err": sweep_err,
                "ms": kernel_s * 1e3,
                "plain_ms": plain_s * 1e3,
            }
        ]
    }
    print(json.dumps(report))
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
