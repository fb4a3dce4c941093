"""``ConstantWaveform(duration, value)``: every sample ``value``."""

import numpy as np


def samples(duration: int, value: float) -> np.ndarray:
    return np.full(duration, value)
