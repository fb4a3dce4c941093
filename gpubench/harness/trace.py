"""Reduces a ``torch.profiler`` Chrome trace to what the metrics read.

Device events are the kernels, copies and sets the profiler records from
the card (``kernel``, ``gpu_memcpy``, ``gpu_memset``); each links to the
host call that launched it by its ``correlation``. Host ranges are the
``record_function`` ranges: the program's phases and the harness's
spans. Times are in µs on the trace's clock.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass, field

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CALL_CATS = {"cuda_runtime", "cuda_driver"}
#: Host calls that wait for the device. A PyTorch ``.item()`` or
#: ``.cpu()`` is one ``cudaStreamSynchronize``; a blocking ``cudaMemcpy``
#: counts where its copy runs device to host.
SYNC_CALLS = {
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
    "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize",
}
BLOCKING_COPIES = {"cudaMemcpy", "cuMemcpyDtoH", "cuMemcpyDtoH_v2", "cuMemcpy"}


@dataclass
class Trace:
    window: tuple[float, float]
    device: list = field(default_factory=list)  # (ts, end, name, corr)
    launches: dict = field(default_factory=dict)  # corr -> (ts, tid)
    ranges: list = field(default_factory=list)  # (ts, end, name, tid)
    host_calls: list = field(default_factory=list)  # (ts, name, corr)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device events inside the window."""
        lo, hi = self.window
        return _union(
            (max(ts, lo), min(end, hi))
            for ts, end, _, _ in self.device
            if end > lo and ts < hi
        )

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def device_seconds_in(self, names: set[str]) -> float:
        """Seconds of the device events launched while a host range named
        in ``names`` was open on the launching thread."""
        opened = defaultdict(list)
        for ts, end, name, tid in self.ranges:
            if name in names:
                opened[tid].append((ts, end))
        merged = {tid: _union(spans) for tid, spans in opened.items()}
        starts = {tid: [a for a, _ in spans] for tid, spans in merged.items()}
        total = 0.0
        for ts, end, _, corr in self.device:
            launch = self.launches.get(corr)
            if launch is None or launch[1] not in merged:
                continue
            spans = merged[launch[1]]
            i = bisect.bisect_right(starts[launch[1]], launch[0]) - 1
            if i >= 0 and launch[0] <= spans[i][1]:
                total += end - ts
        return total * 1e-6

    def syncs(self) -> int:
        """Host calls in the window that waited for the device."""
        lo, hi = self.window
        copies = {corr: name for _, _, name, corr in self.device}
        n = 0
        for ts, name, corr in self.host_calls:
            if not lo <= ts <= hi:
                continue
            if name in SYNC_CALLS:
                n += 1
            elif name in BLOCKING_COPIES and "DtoH" in copies.get(corr, ""):
                n += 1
        return n

    def top_device_ops(self, k: int = 10) -> list[list]:
        lo, hi = self.window
        by_name: dict[str, float] = defaultdict(float)
        for ts, end, name, _ in self.device:
            if end > lo and ts < hi:
                by_name[name] += (min(end, hi) - max(ts, lo)) * 1e-6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:k]
        return [[name[:120], s] for name, s in top]

    def idle_by_range(self, main_tid, k: int = 10) -> list[list]:
        """Idle device time in the window, split by the innermost host
        range open on the main thread at each moment of it."""
        lo, hi = self.window
        gaps, t = [], lo
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
        idle: dict[str, float] = defaultdict(float)
        segs = _innermost(
            [(ts, end, name) for ts, end, name, tid in self.ranges
             if tid == main_tid]
        )
        i = 0
        for a, b in gaps:
            while i < len(segs) and segs[i][1] <= a:
                i += 1
            j = i
            while j < len(segs) and segs[j][0] < b:
                s0, s1, name = segs[j]
                idle[name] += (min(b, s1) - max(a, s0)) * 1e-6
                j += 1
        top = sorted(idle.items(), key=lambda kv: -kv[1])[:k]
        return [[name[:120], s] for name, s in top]


def _innermost(ranges) -> list[tuple[float, float, str]]:
    """Nested ranges of one thread cut into ``(start, end, name)``
    pieces, each named by the innermost range open over it."""
    bounds = sorted(
        [(ts, 1, -end, name) for ts, end, name in ranges]
        + [(end, 0, 0.0, name) for ts, end, name in ranges]
    )
    segs, stack, last = [], [], None
    for t, opening, neg_end, name in bounds:
        if stack and last is not None and t > last:
            segs.append((last, t, stack[-1]))
        if opening:
            stack.append(name)
        elif name in stack:
            # the innermost open range of that name closes
            del stack[len(stack) - 1 - stack[::-1].index(name)]
        last = t
    return segs


def _union(spans) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def read(path: str, window_name: str = "gpubench.window") -> tuple[Trace, object]:
    """The trace in ``path``; also returns the window range's thread."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    window = None
    main_tid = None
    t = Trace(window=(0.0, 0.0))
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        ts = float(ev["ts"])
        end = ts + float(ev.get("dur", 0.0))
        args = ev.get("args") or {}
        if cat in DEVICE_CATS:
            t.device.append((ts, end, ev["name"], args.get("correlation")))
        elif cat in HOST_CALL_CATS:
            corr = args.get("correlation")
            t.host_calls.append((ts, ev["name"], corr))
            if corr is not None:
                t.launches[corr] = (ts, ev.get("tid"))
        elif cat == "user_annotation":
            t.ranges.append((ts, end, ev["name"], ev.get("tid")))
            if ev["name"] == window_name:
                window, main_tid = (ts, end), ev.get("tid")
    if window is None:
        raise ValueError(f"the trace has no {window_name!r} range")
    t.window = window
    return t, main_tid
