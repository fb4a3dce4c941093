"""The Sequence class and its support structures."""

from pulser_tpu_torch.sequence.sequence import Sequence

__all__ = ["Sequence"]
