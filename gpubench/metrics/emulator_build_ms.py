"""Host ms a job spends in ``TorchEmulator.from_sequence`` (sampling, the
Hamiltonian's data, the emulator): the harness's ``emulator_build`` span."""


def read(w):
    return w.span_ms_per_job("emulator_build")
