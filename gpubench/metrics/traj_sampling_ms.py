"""Host ms a job spends from its realizations' states to its counts, as
the program marks it: each state's measurement weights at every
evaluation time and the shots drawn from them with their SPAM flips, the
phases the configuration lists under ``phases.traj_sampling``."""


def read(w):
    return w.phase_ms_per_job(w.cell.phases("traj_sampling"))
