"""Module for sequence sampling."""

from pulser_tpu_torch.sampler.sampler import sample
from pulser_tpu_torch.sampler.samples import (
    ChannelSamples,
    DMMSamples,
    SequenceSamples,
)

__all__ = [
    "sample",
    "ChannelSamples",
    "DMMSamples",
    "SequenceSamples",
]
