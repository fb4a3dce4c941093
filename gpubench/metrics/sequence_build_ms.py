"""Host ms a job spends in ``build(**values)`` of its parametrized
sequence (the harness's ``sequence`` span); none where jobs build none."""


def read(w):
    return w.span_ms_per_job("sequence")
