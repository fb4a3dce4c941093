"""Small copies of the benchmark's cells for the CPU tests.

``small_root`` copies the benchmark's folder and ``BENCHMARK.json`` into
a temporary directory, shrinks each configuration's register to 2 x 3
atoms at its spacing and each traffic's warm-up to two jobs (pulses and
the rest as committed), so that the program's CPU path and the reference
both run a job in about a second.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SMALL_ROWS, SMALL_COLUMNS = 2, 3


def small_register(register: dict) -> dict:
    """A 2 x 3 block of a square register, at its spacing."""
    xy = np.asarray(register["coords_um"])
    spacing = float(np.linalg.norm(xy[1] - xy[0]))
    return {"coords_um": [
        [c * spacing, r * spacing]
        for r in range(SMALL_ROWS) for c in range(SMALL_COLUMNS)
    ]}


def small_root(tmp: str) -> str:
    root = os.path.join(tmp, "checkout")
    shutil.copytree(
        os.path.join(REPO, "gpubench"), os.path.join(root, "gpubench"),
        ignore=shutil.ignore_patterns("__pycache__", "tests"),
    )
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["configs"]:
        path = os.path.join(root, c["file"])
        with open(path) as f:
            cfg = json.load(f)
        cfg["register"] = small_register(cfg["register"])
        with open(path, "w") as f:
            json.dump(cfg, f)
    for w in bench["workloads"]:
        path = os.path.join(root, "gpubench", "traffic", f"{w['traffic']}.json")
        with open(path) as f:
            tr = json.load(f)
        tr["warmup_jobs"] = 2
        with open(path, "w") as f:
            json.dump(tr, f)
    return root


def run_cell(root: str, workload: str, seed: int = 2**31 + 12345,
             seconds: float = 1.0, trace: int = 0) -> tuple[int, dict, str]:
    """Runs a cell on the CPU; returns (exit code, last line, stderr)."""
    from gpubench.harness.main import run

    out, err = io.StringIO(), io.StringIO()
    rc = run(
        ["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
         "--trace", str(trace)],
        t_process=time.perf_counter(), root=root, device="cpu", out=out, err=err,
    )
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else {}), err.getvalue()
