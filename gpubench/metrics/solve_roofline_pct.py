"""The least time the card could take for the solves' work over the
device time of what the solves launched, in %.

The work is ``work/<config>.py``'s count of the problem (float32
operations and bytes per job); the least time is the larger of the
operations at 67 TFLOP/s and the bytes at 3.35 TB/s (the H100 SXM's
published peaks at 700 W). The device time is that of every kernel and
copy launched while one of the program's solve phases was open
(``phases.solve``), joined to its launch by the trace's correlation.
None when the trace holds no such device event."""

from gpubench.harness.main import PEAK_BYTES_PER_S, PEAK_F32_FLOPS


def read(w):
    if w.trace is None or not w.traced_jobs:
        return None
    device_s = w.trace.device_seconds_in(set(w.cell.phases("solve")))
    if device_s <= 0:
        return None
    least = max(w.work["flops"] / PEAK_F32_FLOPS, w.work["bytes"] / PEAK_BYTES_PER_S)
    return 100.0 * least * w.traced_jobs / device_s
