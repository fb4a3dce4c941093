"""The batched solve's kernels' share of their roofline, in %: the least
time the card could take for every realization's work
(``work/<config>.py``) over the device time of the kernels that the
configuration's ``phases.solve`` launched, as ``solve_roofline_pct.py``
computes it (its reader, run on this cell's trace with the copies left
out). On this route the solve call also copies the whole batch of
states to host memory (``traj_fetch_mb_per_job``), a transfer over the
host's bus that the kernels' roofline does not bound."""

import dataclasses

from gpubench.harness.spec import load_module

COPIES = ("Memcpy", "Memset")


def read(w):
    if w.trace is None:
        return None
    kernels = dataclasses.replace(
        w.trace, device=[e for e in w.trace.device if not e[2].startswith(COPIES)]
    )
    reader = load_module(w.cell.root, "metrics", "solve_roofline_pct")
    return reader.read(dataclasses.replace(w, trace=kernels))
