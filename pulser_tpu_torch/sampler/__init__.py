"""Sequence samples (the sampler's ``sample(seq)`` is not ported yet)."""

from pulser_tpu_torch.sampler.samples import (
    ChannelSamples,
    DMMSamples,
    SequenceSamples,
)

__all__ = [
    "ChannelSamples",
    "DMMSamples",
    "SequenceSamples",
]
