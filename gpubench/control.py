"""The control of a cell's check: the reference in a lower precision put
in the program's place, judged by the same comparison.

Run from the root of a checkout, on the card, at the cell's own size::

    python gpubench/control.py --workload afm16.sweep --seeds 1 2 3

For each seed it takes the jobs a run of that seed checks first, works
their outputs out with the reference in bfloat16 (the precision below
the configuration's float32), and prints the numbers compared beside
their limits, one JSON line a seed. The benchmark's own runs never run
it; the limits in ``reference/*.py`` lie between the program's readings
and these.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(root: str, workload: str, seed: int, device: str,
             dtype=torch.bfloat16) -> dict:
    from gpubench.harness import spec, traffic

    cell = spec.load_cell(root, workload)
    ref = cell.reference()
    tr = cell.traffic
    jobs = traffic.first(tr, seed, int(tr.get("check_jobs", 1)))
    low = ref.expected(cell.config, tr, jobs, device=device, dtype=dtype)
    for job, out in zip(jobs, low):
        job["outputs"] = out
    return ref.compare(
        cell.config, tr, jobs, ref.expected(cell.config, tr, jobs, device=device)
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        r = readings(ROOT, args.workload, seed, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed, "control": r}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
