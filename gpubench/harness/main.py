"""One run of one cell: set-up, the measured window, the check, the line.

The command is ``python gpubench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>``. Set-up builds the cell's inputs and warms
its shapes (the first run in a checkout builds the program's kernels
into ``pulser_tpu_torch/build/``). The window is a closed loop of one
client: each job starts when the one before has returned its result to
host memory, until ``--seconds`` have passed. With ``--trace 1`` the
same window runs under ``torch.profiler`` and the per-layer metrics are
read from it (the profiler covers the window's first
``TRACE_SECONDS``). Then the reference checks a sample of the jobs, drawn
from the seed, and the last line of standard output is the result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass

import numpy as np

from gpubench.harness import spec, traffic as trafficmod

#: Top-level modules that may not be loaded in a run: the JAX package
#: and JAX itself (compared by whole top-level name).
FORBIDDEN = ("jax", "jaxlib", "flax", "pulser_tpu")
#: The card's published peaks (NVIDIA H100 SXM data sheet, at 700 W):
#: float32 outside the tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
#: A traced run's profiler covers the window's first jobs, until this
#: many seconds have passed: the trace of a host-bound cell (thousands
#: of synchronizing reads a job) takes minutes to write and read back.
TRACE_SECONDS = 20.0
#: The host range around the traced part of the window.
TRACED = "gpubench.traced"


class _Tracer:
    """``torch.profiler`` over the first part of the window."""

    def __init__(self, torch, device: str):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.range = torch.profiler.record_function(TRACED)
        self.range.__enter__()
        self.jobs = 0
        self.done = False
        self.path = None

    def stop(self) -> None:
        self.range.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        fd, self.path = tempfile.mkstemp(prefix="gpubench_", suffix=".json")
        os.close(fd)
        self.prof.export_chrome_trace(self.path)
        self.prof = None
        self.done = True


@dataclass
class Window:
    """What a per-layer metric's reader gets."""

    cell: spec.Cell
    jobs: int
    spans: object
    phases: dict
    work: dict
    trace: object = None
    main_tid: object = None
    traced_jobs: int = 0

    def phase_ms_per_job(self, names) -> float | None:
        found = [self.phases[n]["total_s"] for n in names if n in self.phases]
        if not found or not self.jobs:
            return None
        return 1e3 * sum(found) / self.jobs

    def span_ms_per_job(self, name: str) -> float | None:
        if not self.spans.count.get(name) or not self.jobs:
            return None
        return 1e3 * self.spans.total[name] / self.jobs


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _forbidden_loaded() -> list[str]:
    return sorted(
        {m.split(".")[0] for m in sys.modules} & set(FORBIDDEN)
    )


def run(argv, *, t_process: float, root: str, device: str = "cuda",
        out=sys.stdout, err=sys.stderr) -> int:
    """Runs a cell and prints its line; returns the exit code.

    ``device="cpu"`` (tests only) skips the look for a card and reports
    no device metric.
    """
    args = parse(argv)
    cell = spec.load_cell(root, args.workload)
    import torch

    if device == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark runs only on the card", file=err)
            return 2
        if torch.cuda.device_count() < int(cell.workload["chips"]):
            print(
                f"{cell.name} needs {cell.workload['chips']} cards,"
                f" {torch.cuda.device_count()} visible", file=err,
            )
            return 2
    from pulser_tpu_torch import profiling

    from gpubench.harness import jobs as jobsmod

    spans = jobsmod.Spans()
    runner = jobsmod.Runner(cell, device, spans)
    tr = cell.traffic
    for job in trafficmod.first(
        tr, args.seed, int(tr.get("warmup_jobs", 2)), trafficmod.WARMUP
    ):
        runner.run(job)
    if device == "cuda":
        torch.cuda.synchronize()
    spans.reset()
    profiling.reset_phases()

    checked = trafficmod.CheckSample(tr, args.seed)
    latencies = []
    attempted = failed = 0
    first_error = None
    source = trafficmod.jobs(tr, args.seed)
    tracer = _Tracer(torch, device) if args.trace else None
    t_window = time.perf_counter()
    setup_s = t_window - t_process
    while time.perf_counter() - t_window < args.seconds:
        job = next(source)
        attempted += 1
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function("gpubench.job"):
                outputs = runner.run(job)
        except Exception:  # a failed job is counted and reported
            failed += 1
            first_error = first_error or traceback.format_exc()
            continue
        latencies.append(time.perf_counter() - t0)
        checked.offer(job, outputs)
        if tracer is not None and not tracer.done:
            tracer.jobs += 1
            if time.perf_counter() - t_window >= TRACE_SECONDS:
                tracer.stop()
    window_s = time.perf_counter() - t_window
    if tracer is not None and not tracer.done:
        tracer.stop()
    phases = profiling.phase_report()
    peak = int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0
    if first_error:
        print(first_error, file=err)
    done = len(latencies)

    # The check: the reference works the sampled jobs out again
    del runner
    if device == "cuda":
        torch.cuda.empty_cache()
    reference = cell.reference()
    picked = checked.picked()
    t_check = time.perf_counter()
    readings = reference.compare(
        cell.config, tr, picked,
        reference.expected(cell.config, tr, picked, device=device),
    )
    print(f"reference: {len(picked)} jobs checked in"
          f" {time.perf_counter() - t_check:.3f} s", file=err)
    correct = bool(picked) and failed == 0 and all(
        r["value"] <= r["limit"] for r in readings.values()
    )

    work = cell.work().count(cell.config, tr)
    window = Window(cell, done, spans, phases, work)
    metrics = {}
    line = {}
    if args.trace:
        from gpubench.harness import trace as tracemod

        window.trace, window.main_tid = tracemod.read(tracer.path, TRACED)
        window.traced_jobs = tracer.jobs
        os.unlink(tracer.path)
        for m in cell.per_layer():
            value = cell.module("metrics", m["name"]).read(window)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        line["breakdown"] = {
            "device_ops": window.trace.top_device_ops(),
            "idle_gaps": window.trace.idle_by_range(window.main_tid),
        }
    else:
        e2e = {
            "jobs_per_s": done / window_s,
            "job_p95_ms": 1e3 * float(np.percentile(latencies, 95)) if latencies else None,
            "setup_s": setup_s,
        }
        for m in cell.end_to_end():
            if e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    dev = {
        "platform": "gpu" if device == "cuda" else "cpu",
        "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
        "count": int(cell.workload["chips"]),
        "memory_peak_bytes": peak,
    }
    if window.trace is not None:
        dev["busy_s"] = window.trace.busy_s()
        dev["window_s"] = window.trace.window_s
    result = {
        "correct": correct,
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": dev,
        **line,
        "checks": readings,
    }
    # Last, so that it covers every module the run loaded: the program,
    # the reference, the work count and the metrics' readers
    loaded = _forbidden_loaded()
    if loaded:
        print(f"forbidden modules loaded: {', '.join(loaded)}", file=err)
        return 3
    for name, r in readings.items():
        print(f"check {name}: {r['value']!r} (limit {r['limit']!r})", file=err)
    print(json.dumps(result), file=out)
    return 0
