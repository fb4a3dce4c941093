"""Scale ladder of the PyTorch port: 24-26 atoms on one card.

The port's counterpart of ``tools/scale_ladder.py``: the same register
(⌊√n⌋ rows at 7 µm) and the same ``ConstantPulse(52, 2π, 1, 0)`` on
``MockDevice``, run by ``TorchEmulator`` with
``evaluation_times="Minimal"``. For each size it reports:

- build: ``Sequence`` → ``TorchEmulator.from_sequence``;
- cold solve: the first ``run()``;
- warm solves: ``run()`` again (median of 3), with steps/s and the
  achieved FLOP/s of :func:`solve_telemetry`;
- the route (``solver.last_solve_info["kind"]``), the final state's
  norm from an on-device reduction (|norm − 1| ≤ 1e-4), and the peak
  device memory of the cold run beside the capacity contract's
  ``solve_bytes``.

Each timing ends with ``torch.cuda.synchronize()``. One card runs the
unsharded interaction-picture torch loop here (``kind ==
"sesolve_torch_loop"``): past 17 qubits no kernel applies, as the JAX
package runs its XLA scan there. ``--ceiling`` adds one cold solve at
``capacity.single_chip_ceiling(2, measured_memory_bytes())`` qubits,
the largest size the capacity contract admits on this card.

Usage::

    python tools/scale_ladder_torch.py [sizes ...] [--ceiling]
        [--device cuda|cpu]      # default: 24 25 26 on the card

The last line is the records as JSON. Without a card and without
``--device cpu`` the first emulator raises the port's "No CUDA device
is visible" error.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: Published float32 peak of one H100 SXM outside the tensor cores
#: (NVIDIA's data sheet, at 700 W): the torch loop's complex64
#: arithmetic runs there.
H100_F32_FLOPS = 67e12

#: The route one card takes at these sizes.
LADDER_KIND = "sesolve_torch_loop"

NORM_TOL = 1e-4


def ladder_sequence(n_atoms: int):
    """``n_atoms`` at 7 µm on ⌊√n⌋ rows, ``ConstantPulse(52, 2π, 1,
    0)`` on ``MockDevice``'s global Rydberg channel."""
    import pulser_tpu_torch as ptt

    rows = int(np.floor(np.sqrt(n_atoms)))
    cols = -(-n_atoms // rows)
    coords = [(7.0 * c, 7.0 * r) for r in range(rows) for c in range(cols)]
    reg = ptt.Register.from_coordinates(coords[:n_atoms], prefix="q")
    seq = ptt.Sequence(reg, ptt.devices.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(ptt.Pulse.ConstantPulse(52, 2 * np.pi, 1.0, 0.0), "ryd")
    return seq


def solve_flops(info: dict) -> int | None:
    """Floating-point operations of the solve ``info`` describes
    (``solver.last_solve_info``), counted as ``bench.solve_telemetry``
    counts the JAX package's scan: per RK4 stage about ``8 + 12n`` per
    amplitude (the diagonal or rotor, and ``n`` axis-wise 2×2
    contractions). None for another route."""
    if info.get("kind") != LADDER_KIND:
        return None
    return info["n_steps"] * 4 * info["dim"] * (8 + 12 * info["n"])


def solve_telemetry(info: dict, seconds: float) -> dict:
    """The achieved FLOP/s of a solve of ``seconds`` (empty for a route
    :func:`solve_flops` does not count)."""
    flops = solve_flops(info)
    if flops is None:
        return {}
    achieved = flops / seconds
    return {
        "flops": flops,
        "achieved_tflops_per_s": achieved / 1e12,
        "pct_of_h100_f32_peak": 100 * achieved / H100_F32_FLOPS,
        "model": info["kind"],
    }


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_size(n_atoms: int, device: str = "cuda", warm_runs: int = 3) -> dict:
    """Build, cold and warm solves at ``n_atoms``; the record's
    ``"state"`` is the final state on ``device`` (complex, normalized)."""
    import torch

    from pulser_tpu_torch.emulator import TorchEmulator
    from pulser_tpu_torch.ops import solver
    from pulser_tpu_torch.parallel import capacity

    seq = ladder_sequence(n_atoms)
    t0 = time.perf_counter()
    emu = TorchEmulator.from_sequence(
        seq, evaluation_times="Minimal", torch_device=device
    )
    build_s = time.perf_counter() - t0
    on_card = torch.device(device).type == "cuda"
    if on_card:
        _sync(device)
        torch.cuda.reset_peak_memory_stats(device)
        held = torch.cuda.memory_allocated(device)
    t0 = time.perf_counter()
    res = emu.run()
    _sync(device)
    cold_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) - held if on_card else None
    info = dict(solver.last_solve_info)
    n_eval = len(emu.evaluation_times)
    model = capacity.solve_bytes(2, n_atoms, n_eval=n_eval)
    warm = []
    for _ in range(warm_runs):
        del res
        t0 = time.perf_counter()
        res = emu.run()
        _sync(device)
        warm.append(time.perf_counter() - t0)
    warm_s = statistics.median(warm) if warm else cold_s
    batch = res._device_states
    last = len(batch) - 1
    norm = float(batch.device_norm(last))
    if info.get("kind") != LADDER_KIND or not info.get("ip") or info.get(
        "ranks", 1
    ) != 1:
        raise RuntimeError(f"{n_atoms} atoms took the route {info}")
    if abs(norm - 1) > NORM_TOL:
        raise RuntimeError(
            f"{n_atoms} atoms: |norm - 1| = {abs(norm - 1):.3e}"
        )
    return {
        "n_atoms": n_atoms,
        "device": str(device),
        "build_s": build_s,
        "cold_solve_s": cold_s,
        "warm_solve_s": warm,
        "warm_median_s": warm_s,
        "n_steps": info["n_steps"],
        "stages": 4 * info["n_steps"],
        "ms_per_stage": 1e3 * warm_s / (4 * info["n_steps"]),
        "steps_per_s": info["n_steps"] / warm_s,
        "telemetry": solve_telemetry(info, warm_s),
        "norm": norm,
        "solver_kind": info["kind"],
        "n_eval": n_eval,
        "peak_bytes": peak,
        "solve_bytes": model,
        "state": batch.device_state(last),
    }


def ceiling_size() -> int:
    """The largest qubit count the capacity contract admits on this
    card: ``single_chip_ceiling(2, measured_memory_bytes())``."""
    from pulser_tpu_torch.parallel import capacity

    mem = capacity.measured_memory_bytes()
    if mem is None:
        raise RuntimeError("--ceiling needs a CUDA card")
    return capacity.single_chip_ceiling(2, mem)


def _line(rec: dict) -> str:
    peak = rec["peak_bytes"]
    return (
        f"{rec['n_atoms']} atoms on {rec['device']}: build"
        f" {rec['build_s']:.3f} s, cold {rec['cold_solve_s']:.3f} s, warm"
        f" {[round(t, 4) for t in rec['warm_solve_s']]} s (median"
        f" {rec['warm_median_s']:.4f} s, {rec['steps_per_s']:.1f} steps/s,"
        f" {rec['ms_per_stage']:.3f} ms a stage), {rec['solver_kind']},"
        f" |norm - 1| {abs(rec['norm'] - 1):.3e}, peak"
        f" {'not measured' if peak is None else f'{peak} B'} against"
        f" solve_bytes {rec['solve_bytes']} B, {rec['telemetry']}"
    )


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("sizes", nargs="*", type=int)
    parser.add_argument("--ceiling", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    sizes = args.sizes or [24, 25, 26]
    records = []
    for n in sizes:
        records.append(run_size(n, args.device))
        print(_line(records[-1]), flush=True)
    if args.ceiling:
        n = ceiling_size()
        records.append(run_size(n, args.device, warm_runs=0))
        print("ceiling: " + _line(records[-1]), flush=True)
    for rec in records:
        del rec["state"]
    print(json.dumps(records))


if __name__ == "__main__":
    main()
