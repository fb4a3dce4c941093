"""Warm ``run()`` of chip_smoke's main paths in two checkouts, in turns.

Compares two trees of this repository (for example a parent commit's
``git archive`` and the working tree) on one card: each run is a fresh
process in one tree that builds the kernels, runs each path once to warm
it, then times ``reps`` warm ``TorchEmulator.run()`` calls (the final
state fetched on the noiseless paths, the counts on the noisy ones) and
prints their median in ms as one JSON line. The trees run in the order
A, B, B, A, repeated ``rounds`` times, so that drift on the host hits
both alike. Needs a CUDA card. Run from the repository root::

    python3 tools/warm_ab.py PARENT_DIR CHANGE_DIR [--rounds 3] [--reps 15]
        [--paths AFM16,NOISY10]

Paths: AFM16, NOISY10, SPD10, PAULI10 and SPD16 (the 16-atom sweep under
SPD10's noise, 100 trajectories of 10 samples, built here from
chip_smoke's AFM16 sequence and NOISY10 noise, so that trees older than
``chip_smoke.spd16_sequence`` run it too), seed 1234, as chip_smoke.py.
The pure-state batches (SPD10, SPD16) also report the host preparation
of a warm run (``chip_smoke._timed_parts``, median of 3) under ``NAME
prep`` and the device's busy share of one traced run in percent under
``NAME busy``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

_CODE = r"""
import contextlib, io, json, statistics, sys, time
sys.path.insert(0, ".")
import numpy as np, torch
import chip_smoke as C
import pulser_tpu_torch.ops.kernels as K
from pulser_tpu_torch.emulator import TorchEmulator

paths, reps = sys.argv[1].split(","), int(sys.argv[2])
with contextlib.redirect_stdout(io.StringIO()):
    C._build(K)

def warm(emu):
    emu.run()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = emu.run()
        if type(res).__name__ == "CoherentResults":
            res.states[-1].full()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3

def spd16():
    from pulser_tpu_torch import NoiseModel

    params = {k: v for k, v in C._NOISY10_NOISE.items() if k != "dephasing_rate"}
    return C.afm16_sequence(), NoiseModel(**params)

noisy = {
    "NOISY10": C.noisy10_sequence,
    "SPD10": C.spd10_sequence,
    "PAULI10": C.pauli10_sequence,
    "SPD16": spd16,
}
out = {}
for name in paths:
    if name == "AFM16":
        seq = C.afm16_sequence()
        times = np.linspace(0, seq.get_duration() * 1e-3, 101)
        emu = TorchEmulator.from_sequence(seq, evaluation_times=times)
    else:
        seq, noise = noisy[name]()
        np.random.seed(1234)
        emu = TorchEmulator.from_sequence(
            seq, noise_model=noise, evaluation_times="Minimal"
        )
    out[name] = warm(emu)
    if name in ("SPD10", "SPD16"):
        from pulser_tpu_torch.emulator import simulation as sim
        from pulser_tpu_torch.ops import solver as S

        parts = [C._timed_parts(emu, S, sim)["prep"] for _ in range(3)]
        out[name + " prep"] = statistics.median(parts) * 1e3
        wall_s, busy_ms = C._device_busy(emu.run)[:2]
        out[name + " busy"] = 100 * busy_ms / 1e3 / wall_s
print(json.dumps(out))
"""


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("tree_a")
    parser.add_argument("tree_b")
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--reps", type=int, default=15)
    parser.add_argument("--paths", default="AFM16,NOISY10")
    args = parser.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card, flush=True)
    runs: dict = {args.tree_a: [], args.tree_b: []}
    order = [args.tree_a, args.tree_b, args.tree_b, args.tree_a]
    for tree in order * args.rounds:
        proc = subprocess.run(
            [sys.executable, "-c", _CODE, args.paths, str(args.reps)],
            cwd=tree, capture_output=True, text=True,
        )
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return 1
        ms = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[tree].append(ms)
        print(tree, json.dumps(ms), flush=True)
    for tree, results in runs.items():
        summary = {
            name: {
                "median": statistics.median(r[name] for r in results),
                "min": min(r[name] for r in results),
                "max": max(r[name] for r in results),
            }
            for name in results[0]
        }
        print(tree, "over", len(results), "runs:", json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
