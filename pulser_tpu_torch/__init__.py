"""PyTorch/CUDA port of the pulser_tpu neutral-atom framework.

Mirrors ``pulser_tpu``'s module paths with ``Tpu`` replaced by
``Torch`` in the public names. A run starts as in the JAX package:
``Sequence(register, device)`` → ``declare_channel`` →
``add(Pulse(...))`` → ``TorchEmulator.from_sequence(seq).run()``, or
through the backend API, ``TorchBackendV2(seq, config=TorchConfig(
observables=[...])).run()``. A sequence travels as abstract-repr JSON
(``seq.to_abstract_repr()``, ``Sequence.from_abstract_repr``), and
``QPUBackend`` submits it through a ``RemoteConnection``.
"""

from pulser_tpu_torch._version import __version__ as __version__

from pulser_tpu_torch.waveforms import (
    CompositeWaveform,
    CustomWaveform,
    ConstantWaveform,
    RampWaveform,
    BlackmanWaveform,
    InterpolatedWaveform,
    KaiserWaveform,
)
from pulser_tpu_torch.pulse import Pulse
from pulser_tpu_torch.parametrized import Variable
from pulser_tpu_torch.register import (
    MappableRegister,
    Register,
    Register3D,
    RegisterLayout,
)
from pulser_tpu_torch.noise_model import NoiseModel
from pulser_tpu_torch.devices import (
    AnalogDevice,
    DigitalAnalogDevice,
    MockDevice,
)

from pulser_tpu_torch import (
    waveforms as waveforms,
    channels as channels,
    register as register,
    devices as devices,
    exceptions as exceptions,
)

__all__ = [
    "CompositeWaveform",
    "CustomWaveform",
    "ConstantWaveform",
    "RampWaveform",
    "BlackmanWaveform",
    "InterpolatedWaveform",
    "KaiserWaveform",
    "Pulse",
    "Variable",
    "MappableRegister",
    "Register",
    "Register3D",
    "RegisterLayout",
    "NoiseModel",
    "AnalogDevice",
    "DigitalAnalogDevice",
    "MockDevice",
    "Sequence",
    "sample",
    "EmulatorConfig",
    "QPUBackend",
]

#: Names resolved lazily from the backend and emulator subpackages.
_BACKEND_NAMES = {
    name: "pulser_tpu_torch.backend"
    for name in (
        "AggregationMethod",
        "BackendConfig",
        "BitStrings",
        "Callback",
        "CorrelationMatrix",
        "EmulationConfig",
        "EmulatorConfig",
        "Energy",
        "EnergySecondMoment",
        "EnergyVariance",
        "Expectation",
        "Fidelity",
        "Observable",
        "Occupation",
        "QPUBackend",
        "Results",
        "ResultsSequence",
        "StateResult",
    )
} | {
    name: "pulser_tpu_torch.emulator"
    for name in (
        "QutipBackend",
        "QutipBackendV2",
        "QutipConfig",
        "QutipOperator",
        "QutipState",
        "TorchBackend",
        "TorchBackendV2",
        "TorchConfig",
        "TorchOperator",
        "TorchState",
    )
}


def __getattr__(name: str):
    # Lazily resolved to avoid import cycles while the package loads.
    if name == "Sequence":
        from pulser_tpu_torch.sequence import Sequence

        return Sequence
    if name == "sample":
        from pulser_tpu_torch.sampler import sample

        return sample
    if name == "sampler":
        import pulser_tpu_torch.sampler as sampler

        return sampler
    if name in _BACKEND_NAMES or name in ("backend", "backends", "emulator"):
        import importlib

        if name in ("backend", "backends", "emulator"):
            return importlib.import_module(f"pulser_tpu_torch.{name}")
        return getattr(importlib.import_module(_BACKEND_NAMES[name]), name)
    if name == "sequence":
        import importlib
        import sys

        # The partially-initialized module must be returned during
        # its own import (submodule imports re-enter this hook)
        mod = sys.modules.get("pulser_tpu_torch.sequence")
        if mod is not None:
            return mod
        return importlib.import_module("pulser_tpu_torch.sequence")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(
        set(globals())
        | {
            "Sequence",
            "sample",
            "sampler",
            "sequence",
            "backend",
            "backends",
            "emulator",
        }
        | set(_BACKEND_NAMES)
    )
