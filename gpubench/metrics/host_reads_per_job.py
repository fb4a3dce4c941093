"""Host calls a job makes that wait for the card, as the program counts
them where it reads: the sum of its ``sync.*`` counters
(``pulser_tpu_torch.profiling.counter_report()``, cleared with the phases
after the warm-up) over the window's jobs. Read when the metric is read:
after the window only the reference runs, which calls nothing of the
program. None where the program keeps no counters."""

PREFIX = "sync."


def read(w):
    from pulser_tpu_torch import profiling

    report = getattr(profiling, "counter_report", None)
    if report is None or not w.jobs:
        return None
    reads = sum(v for k, v in report().items() if k.startswith(PREFIX))
    return float(reads) / w.jobs
