"""Emulation of sampled sequences with PyTorch solvers."""

from pulser_tpu_torch.emulator.hamiltonian import Hamiltonian
from pulser_tpu_torch.emulator.qobj import Qobj, basis, qeye, tensor
from pulser_tpu_torch.emulator.sim_result import QutipResult, TorchResult
from pulser_tpu_torch.emulator.simconfig import SimConfig
from pulser_tpu_torch.emulator.simresults import (
    CoherentResults,
    NoisyResults,
    SimulationResults,
)
from pulser_tpu_torch.emulator.simulation import (
    QutipEmulator,
    Solver,
    TorchEmulator,
)
from pulser_tpu_torch.noise_model import NoiseModel

__all__ = [
    "CoherentResults",
    "Hamiltonian",
    "NoiseModel",
    "NoisyResults",
    "Qobj",
    "QutipEmulator",
    "QutipResult",
    "SimConfig",
    "SimulationResults",
    "Solver",
    "TorchEmulator",
    "TorchResult",
    "basis",
    "qeye",
    "tensor",
]
