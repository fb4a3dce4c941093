"""Top-level aliases for abstract-representation deserialization.

Mirrors the public convenience module of the reference
(``pulser-core/pulser/abstract_repr.py:16-21``): each ``deserialize_*``
function accepts the JSON string of the corresponding abstract-repr
schema and returns the reconstructed object.  The implementations live
in :mod:`pulser_tpu_torch.json.abstract_repr.deserializer`; this module only
provides the short, stable import path users reach for first.
"""

from __future__ import annotations

from pulser_tpu_torch.json.abstract_repr.deserializer import (
    deserialize_abstract_layout as deserialize_layout,
    deserialize_abstract_noise_model as deserialize_noise_model,
    deserialize_abstract_register as deserialize_register,
    deserialize_abstract_sequence as deserialize_sequence,
    deserialize_device,
)

__all__ = [
    "deserialize_layout",
    "deserialize_noise_model",
    "deserialize_register",
    "deserialize_sequence",
    "deserialize_device",
]
