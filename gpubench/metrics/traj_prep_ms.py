"""Host ms a job spends preparing its noise realizations' batch, as the
program marks it: the realizations' draws and coefficients, the step
policy they share and the batch's plan, the phases the configuration
lists under ``phases.traj_prep``."""


def read(w):
    return w.phase_ms_per_job(w.cell.phases("traj_prep"))
