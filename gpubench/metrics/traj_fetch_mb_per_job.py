"""MB (10^6 bytes) of states a job's batched solve copies from the card
to host memory, as the program counts them where it reads: its
``traj.fetched_bytes`` counter (``pulser_tpu_torch.profiling.
counter_report()``, cleared with the phases after the warm-up) over the
window's jobs. Read when the metric is read: after the window only the
reference runs, which calls nothing of the program. None where the
program keeps no such counter."""

NAME = "traj.fetched_bytes"


def read(w):
    from pulser_tpu_torch import profiling

    report = getattr(profiling, "counter_report", None)
    if report is None or not w.jobs:
        return None
    fetched = report().get(NAME)
    if fetched is None:
        return None
    return float(fetched) / w.jobs / 1e6
