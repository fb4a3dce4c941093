"""Host ms a job spends in the program's solve call (the phases listed
under ``phases.solve``): dispatch and staging; it ends when the launch
returns unless the call itself waits for the card."""


def read(w):
    return w.phase_ms_per_job(w.cell.phases("solve"))
