"""Emulation of sampled sequences with PyTorch solvers."""

from pulser_tpu_torch.emulator.hamiltonian import Hamiltonian
from pulser_tpu_torch.backend.config import EmulatorConfig
from pulser_tpu_torch.emulator.aggregators import density_matrix_aggregator
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
from pulser_tpu_torch.emulator.torch_backend import (
    QutipBackend,
    QutipBackendV2,
    TorchBackend,
    TorchBackendV2,
)
from pulser_tpu_torch.emulator.torch_config import QutipConfig, TorchConfig
from pulser_tpu_torch.emulator.torch_op import QutipOperator, TorchOperator
from pulser_tpu_torch.emulator.torch_state import QutipState, TorchState
from pulser_tpu_torch.noise_model import NoiseModel

__all__ = [
    "CoherentResults",
    "EmulatorConfig",
    "Hamiltonian",
    "NoiseModel",
    "NoisyResults",
    "Qobj",
    "QutipBackend",
    "QutipBackendV2",
    "QutipConfig",
    "QutipEmulator",
    "QutipOperator",
    "QutipResult",
    "QutipState",
    "SimConfig",
    "SimulationResults",
    "Solver",
    "TorchBackend",
    "TorchBackendV2",
    "TorchConfig",
    "TorchEmulator",
    "TorchOperator",
    "TorchResult",
    "TorchState",
    "basis",
    "density_matrix_aggregator",
    "qeye",
    "tensor",
]
