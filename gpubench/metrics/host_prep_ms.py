"""Host ms a job spends in the program's own host-prep phases
(``profiling.phase_report``), whose names the cell's configuration lists
under ``phases.host_prep``: the plan for a noiseless solve; the noise
draws, the step policy and the batched plan for a noisy one."""


def read(w):
    return w.phase_ms_per_job(w.cell.phases("host_prep"))
