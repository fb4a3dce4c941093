"""Host ms a job spends feeding the states to the backend's observables:
each state made a unit state, the Hamiltonian at its time, and every
observable due then (the phase named below, around each run's results)."""

PHASES = ("backend.observables",)


def read(w):
    return w.phase_ms_per_job(PHASES)
