"""Host ms a job spends drawing shots from its results
(``sample_state``, which ``sample_final_state`` calls): the phase named
below."""

PHASES = ("results.sample",)


def read(w):
    return w.phase_ms_per_job(PHASES)
