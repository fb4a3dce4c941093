"""PyTorch/CUDA port of the pulser_tpu neutral-atom emulator.

Mirrors ``pulser_tpu``'s module paths with ``Tpu`` replaced by
``Torch`` in the public names. This slice covers the noiseless
ground-rydberg emulation, entered through
``TorchEmulator(samples, register, device).run()``; the sequence
builder and the noisy solvers come in later slices (see ROADMAP.md).
"""

from pulser_tpu_torch.devices import (
    AnalogDevice,
    DigitalAnalogDevice,
    MockDevice,
)
from pulser_tpu_torch.noise_model import NoiseModel
from pulser_tpu_torch.register import Register

__all__ = [
    "AnalogDevice",
    "DigitalAnalogDevice",
    "MockDevice",
    "NoiseModel",
    "Register",
]
