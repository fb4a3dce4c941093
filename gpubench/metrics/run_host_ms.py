"""Host ms a job spends in ``TorchEmulator.run()`` outside the plan and
the solve call: the options, the step policy and the wrapping of the
results. The phase ``RUN`` less the configuration's ``phases.host_prep``
and ``phases.solve``; None where the program does not mark ``run()``."""

RUN = "emulator.run"


def read(w):
    if RUN not in w.phases or not w.jobs:
        return None
    inner = w.cell.phases("host_prep") + w.cell.phases("solve")
    inside = sum(w.phases[n]["total_s"] for n in inner if n in w.phases)
    return 1e3 * (w.phases[RUN]["total_s"] - inside) / w.jobs
