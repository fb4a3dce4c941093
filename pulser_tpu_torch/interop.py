"""Carries sampled sequences, registers, devices and noise models across
from pulser_tpu.

Objects built with the JAX package are rebuilt here as the port's own,
so that both packages can be run on the same inputs (the port builds and
samples its own sequences: ``pulser_tpu_torch.Sequence``,
``pulser_tpu_torch.sampler.sample``). Only plain attributes and numpy
arrays of the given objects are read, and the JAX package is never
imported: each object maps onto the class of the same name at the same
module path under ``pulser_tpu_torch``.

Example::

    samples = pulser_tpu.sampler.sample(seq)
    emu = TorchEmulator(
        from_jax_samples(samples),
        from_jax_register(seq.register),
        from_jax_device(seq.device),
    )
"""

from __future__ import annotations

import dataclasses
import enum
import importlib
import warnings
from typing import Any

import numpy as np

import pulser_tpu_torch.math as pm
from pulser_tpu_torch.devices._device_datacls import BaseDevice
from pulser_tpu_torch.noise_model import NoiseModel
from pulser_tpu_torch.register import Register
from pulser_tpu_torch.register.weight_maps import DetuningMap
from pulser_tpu_torch.pulse import Pulse
from pulser_tpu_torch.sampler.samples import SequenceSamples
from pulser_tpu_torch.sequence._basis_ref import _QubitRef
from pulser_tpu_torch.sequence._schedule import _EOMSettings, _TimeSlot
from pulser_tpu_torch.waveforms import CustomWaveform

_SRC_PKG = "pulser_tpu"
_DST_PKG = "pulser_tpu_torch"

#: The constructor arguments of each register layout class, read back
#: from the attributes of a layout of the JAX package.
_LAYOUT_ARGS = {
    "RegisterLayout": ("coords", "slug"),
    "RectangularLatticeLayout": (
        "_rows", "_columns", "_col_spacing", "_row_spacing"
    ),
    "SquareLatticeLayout": ("_rows", "_columns", "_spacing"),
    "TriangularLatticeLayout": ("number_of_traps", "_spacing"),
}


def _port_class(obj: Any) -> Any:
    """The port's class with the name and module path of ``obj``'s."""
    cls = type(obj)
    module = cls.__module__
    if module != _SRC_PKG and not module.startswith(_SRC_PKG + "."):
        raise TypeError(f"Not a {_SRC_PKG} object: {cls.__qualname__}.")
    port_module = importlib.import_module(_DST_PKG + module[len(_SRC_PKG):])
    return getattr(port_module, cls.__name__)


def _convert(obj: Any) -> Any:
    """Rebuilds a value of the JAX package as the port's equivalent."""
    if isinstance(obj, enum.Enum):
        return _port_class(obj)(obj.value)
    if obj is None or isinstance(obj, (str, bool, int, float, complex)):
        return obj
    if isinstance(obj, np.generic):
        return obj
    if isinstance(obj, np.ndarray):
        return obj.copy()
    name = type(obj).__name__
    if name == "AbstractArray":
        return pm.AbstractArray(np.array(obj.as_array(detach=True)))
    if name in _LAYOUT_ARGS:
        args = (_convert(getattr(obj, a)) for a in _LAYOUT_ARGS[name])
        return _port_class(obj)(*args)
    if name == "DetuningMap":
        return DetuningMap(
            np.array(obj.trap_coordinates), list(obj.weights), obj.slug
        )
    if name == "_EOMSettings":
        return _EOMSettings(
            **{
                f.name: _convert(getattr(obj, f.name))
                for f in dataclasses.fields(obj)
            }
        )
    if name == "_TimeSlot":
        return _TimeSlot(
            _convert(obj.type), obj.ti, obj.tf, set(obj.targets)
        )
    if name == "Pulse":
        # The same samples, whatever waveform classes produced them
        return Pulse(
            CustomWaveform(_convert(obj.amplitude.samples)),
            CustomWaveform(_convert(obj.detuning.samples)),
            _convert(obj.phase),
            obj.post_phase_shift,
        )
    if name == "_QubitRef":
        ref = _QubitRef()
        ref.phase._steps = list(obj.phase._steps)
        ref._usage_times = set(obj._usage_times)
        return ref
    if isinstance(obj, (list, tuple, set)):
        return type(obj)(_convert(x) for x in obj)
    if isinstance(obj, dict):
        return {_convert(k): _convert(v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj):
        cls = _port_class(obj)
        ported = {f.name for f in dataclasses.fields(cls) if f.init}
        return cls(
            **{
                f.name: _convert(getattr(obj, f.name))
                for f in dataclasses.fields(obj)
                if f.init and f.name in ported
            }
        )
    raise TypeError(f"Cannot carry a {type(obj).__qualname__} across.")


def from_jax_samples(samples: Any) -> SequenceSamples:
    """The port's SequenceSamples rebuilt from ``pulser_tpu``'s.

    Carries the channel amp/det/phase series, slots, EOM blocks and
    buffers, the channel objects, the basis reference, the SLM mask,
    the magnetic field and the measurement basis.
    """
    return _convert(samples)


def from_jax_register(register: Any) -> Register:
    """The port's Register with the same qubit ids and coordinates."""
    return Register(
        {
            qid: np.array(pos.as_array(detach=True))
            for qid, pos in register.qubits.items()
        }
    )


def from_jax_device(device: Any) -> BaseDevice:
    """The port's Device or VirtualDevice with the same dataclass fields,
    its calibrated layouts included."""
    ported = _convert(device)
    custom_xy = getattr(device, "_custom_interaction_coeff_xy", None)
    if custom_xy is not None:
        object.__setattr__(ported, "_custom_interaction_coeff_xy", custom_xy)
    return ported


def from_jax_noise_model(noise_model: Any) -> NoiseModel:
    """The port's NoiseModel with the same parameters.

    The parameters are carried across as they are stored (the deprecated
    ``runs`` included), so the rebuilt model has the same noise types;
    the warnings the constructor gives for them were already given when
    the original was made.
    """
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return _convert(noise_model)
