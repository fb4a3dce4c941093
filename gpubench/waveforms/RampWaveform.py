"""``RampWaveform(duration, start, stop)``: samples evenly spaced from
``start`` to ``stop``, both included, one a nanosecond."""

import numpy as np


def samples(duration: int, start: float, stop: float) -> np.ndarray:
    return np.linspace(start, stop, duration)
