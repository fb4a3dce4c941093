"""The various hardware channel types."""

from pulser_tpu_torch.channels.channels import Microwave, Raman, Rydberg
from pulser_tpu_torch.channels.dmm import DMM
from pulser_tpu_torch.channels.eom import BaseEOM, RydbergBeam, RydbergEOM

__all__ = [
    "Microwave",
    "Raman",
    "Rydberg",
    "DMM",
    "BaseEOM",
    "RydbergBeam",
    "RydbergEOM",
]
