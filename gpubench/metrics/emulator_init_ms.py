"""Host ms a job spends building the emulator, as the program marks it:
the sampling of the sequence and the emulator's construction (its
Hamiltonian data and first Hamiltonian), the phases named below."""

PHASES = ("emulator.sample_sequence", "emulator.init")


def read(w):
    return w.phase_ms_per_job(PHASES)
