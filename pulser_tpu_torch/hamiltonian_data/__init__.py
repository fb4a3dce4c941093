"""The backend-agnostic physics IR (samples -> Hamiltonian data)."""

from pulser_tpu_torch.hamiltonian_data.basis_data import BasisData
from pulser_tpu_torch.hamiltonian_data.hamiltonian_data import (
    HamiltonianData,
    SamplesWithReps,
    TrajectoryWithReps,
    has_shot_to_shot_except_spam,
)
from pulser_tpu_torch.hamiltonian_data.lindblad_data import LindbladData
from pulser_tpu_torch.hamiltonian_data.noise_trajectory import NoiseTrajectory

__all__ = [
    "BasisData",
    "HamiltonianData",
    "LindbladData",
    "NoiseTrajectory",
    "SamplesWithReps",
    "TrajectoryWithReps",
    "has_shot_to_shot_except_spam",
]
