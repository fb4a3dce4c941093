"""Classes for backend execution."""

import pulser_tpu_torch.noise_model as noise_model  # For backwards compat
from pulser_tpu_torch.noise_model import (  # For backwards compat
    NoiseModel as NoiseModel,
)

from pulser_tpu_torch.backend.abc import Backend, EmulatorBackend
from pulser_tpu_torch.backend.config import (
    BackendConfig,
    EmulationConfig,
    EmulatorConfig,
)
from pulser_tpu_torch.backend.default_observables import (
    BitStrings,
    CorrelationMatrix,
    Energy,
    EnergySecondMoment,
    EnergyVariance,
    Expectation,
    Fidelity,
    Occupation,
    StateResult,
)
from pulser_tpu_torch.backend.observable import (
    AggregationMethod,
    Callback,
    Observable,
)
from pulser_tpu_torch.backend.operator import Operator, OperatorRepr
from pulser_tpu_torch.backend.qpu import QPUBackend
from pulser_tpu_torch.backend.remote import (
    BatchStatus,
    JobParams,
    JobStatus,
    RemoteBackend,
    RemoteConnection,
    RemoteResults,
    RemoteResultsError,
)
from pulser_tpu_torch.backend.results import Results, ResultsSequence
from pulser_tpu_torch.backend.state import State, StateRepr

__all__ = [
    "AggregationMethod",
    "Backend",
    "EmulatorBackend",
    "BackendConfig",
    "EmulationConfig",
    "EmulatorConfig",
    "BitStrings",
    "CorrelationMatrix",
    "Energy",
    "EnergySecondMoment",
    "EnergyVariance",
    "Expectation",
    "Fidelity",
    "Occupation",
    "StateResult",
    "Callback",
    "Observable",
    "Operator",
    "OperatorRepr",
    "QPUBackend",
    "BatchStatus",
    "JobParams",
    "JobStatus",
    "RemoteBackend",
    "RemoteConnection",
    "RemoteResults",
    "RemoteResultsError",
    "Results",
    "ResultsSequence",
    "State",
    "StateRepr",
]
