"""The backend configuration classes.

API parity with reference
``pulser-core/pulser/backend/config.py:57-578``. Validation is split
into focused helpers; the config itself is an immutable bag of options
exposed through ``__getattr__``.
"""

from __future__ import annotations

import copy
import json
import warnings
from collections import Counter
from dataclasses import dataclass, field
from typing import (
    Any,
    ClassVar,
    Generic,
    Literal,
    Sequence,
    SupportsFloat,
    Type,
    TypeVar,
    cast,
    get_args,
)

import numpy as np
from numpy.typing import ArrayLike, NDArray

import pulser_tpu_torch.math as pm
from pulser_tpu_torch.backend._classproperty import classproperty
from pulser_tpu_torch.backend.observable import Callback, Observable
from pulser_tpu_torch.backend.operator import Operator, OperatorRepr
from pulser_tpu_torch.backend.state import State, StateRepr
from pulser_tpu_torch.json.abstract_repr.serializer import AbstractReprEncoder
from pulser_tpu_torch.json.abstract_repr.validation import validate_abstract_repr
from pulser_tpu_torch.noise_model import NoiseModel

DEFAULT_N_TRAJECTORIES = 40
EVAL_TIMES_LITERAL = Literal["Full", "Minimal", "Final"]

StateType = TypeVar("StateType", bound=State)

Self = TypeVar("Self", bound="BackendConfig")


class BackendConfig:
    """The base backend configuration.

    Args:
        default_num_shots: The default number of shots for the backend.
            Must be a strictly positive integer.

    Note:
        Additional parameters may be provided. It is up to the backend
        that receives a configuration with extra parameters to assess
        whether it recognizes them and how it will use them.
    """

    default_num_shots: int | None
    _backend_options: dict[str, Any]
    # Whether to error if unexpected kwargs are received
    _enforce_expected_kwargs: ClassVar[bool] = True

    def __init__(
        self,
        *,
        default_num_shots: int | None = None,
        **backend_options: Any,
    ) -> None:
        """Initializes the backend config."""
        cls_name = self.__class__.__name__
        if self._enforce_expected_kwargs:
            unknown = set(backend_options) - (
                self._expected_kwargs() | {"backend_options"}
            )
            if unknown:
                raise ValueError(
                    f"{cls_name!r} received unexpected keyword arguments: "
                    f"{unknown}; only the following keyword "
                    f"arguments are expected: {self._expected_kwargs()}. "
                )
        # A deep copy detaches the stored options from caller mutations.
        super().__setattr__(
            "_backend_options", copy.deepcopy(backend_options)
        )
        if "backend_options" in backend_options:
            with warnings.catch_warnings():
                warnings.filterwarnings("always")
                warnings.warn(
                    f"The 'backend_options' argument of {cls_name!r} "
                    "has been deprecated. Please provide the options "
                    f"as keyword arguments directly to '{cls_name}()'.",
                    DeprecationWarning,
                    stacklevel=2,
                )
            self._backend_options.update(
                backend_options["backend_options"]
            )

        if default_num_shots is not None:
            if default_num_shots < 1:
                raise ValueError(
                    "'default_num_shots' must be greater than or equal to"
                    f" 1, not {default_num_shots}."
                )
            default_num_shots = int(default_num_shots)
        self._backend_options["default_num_shots"] = default_num_shots

    def with_changes(self: Self, **changes: Any) -> Self:
        """Returns a copy of the config with the given changes."""
        return type(self)(**(self._backend_options | changes))

    def _expected_kwargs(self) -> set[str]:
        return set()

    def __getattr__(self, name: str) -> Any:
        if (
            "_backend_options" in self.__dict__
            and name in self._backend_options
        ):
            return self._backend_options[name]
        raise AttributeError(
            f"{name!r} has not been passed to {self!r}."
        )

    def __setattr__(self, name: str, value: Any) -> None:
        cls_name = type(self).__name__
        raise AttributeError(
            f"{cls_name!r} is read-only. Please use "
            f"'{cls_name}.with_changes({name}=...)' to make a copy with"
            " the desired changes."
        )

    def __setstate__(self, d: dict) -> None:
        super().__setattr__("__dict__", d)

    def __repr__(self) -> str:
        lines = ",\n    ".join(
            f"{key}={value!r}"
            for key, value in self._backend_options.items()
        )
        return f"{self.__class__.__name__}(\n    {lines},\n)"


def _checked_callbacks(
    callbacks: Sequence[Callback], observables: Sequence[Observable]
) -> None:
    """Type-checks callbacks/observables and rejects tag collisions."""
    for i, cb in enumerate(callbacks):
        if isinstance(cb, Observable):
            raise TypeError(
                "All entries in 'callbacks' must not be instances of"
                " Observable, since those go in 'observables'. "
                f"Instead, got {cb!r} at index {i}."
            )
        if not isinstance(cb, Callback):
            raise TypeError(
                "All entries in 'callbacks' must be instances of "
                "Callback. Instead, got instance of type "
                f"{type(cb)} at index {i}: {cb!r}."
            )
    for i, obs in enumerate(observables):
        if not isinstance(obs, Observable):
            raise TypeError(
                "All entries in 'observables' must be instances of "
                "Observable. Instead, got instance of type "
                f"{type(obs)} at index {i}: {obs!r}."
            )
    tag_counts = Counter(obs.tag for obs in observables)
    clashes = [tag for tag, count in tag_counts.items() if count > 1]
    if clashes:
        raise ValueError(
            "Some of the provided 'observables' share identical tags."
            " Use 'tag_suffix' when instantiating multiple instances"
            " of the same observable so they can be distinguished. "
            f"Repeated tags found: {clashes}"
        )


def _checked_interaction_matrix(
    interaction_matrix: ArrayLike, initial_state: State | None
) -> pm.AbstractArray:
    """Validates and normalizes the interaction-matrix override.

    Accepts (N, N), (1, N, N) or — in XY mode — (2, N, N), always
    returning the 3D form. Matrices must be symmetric; any diagonal
    values are ignored (with a warning).
    """
    matrix = pm.AbstractArray(interaction_matrix)
    shape = matrix.shape
    square_2d = len(shape) == 2 and shape[0] == shape[1]
    stacked_3d = (
        len(shape) == 3 and shape[0] <= 2 and shape[1] == shape[2]
    )
    if not square_2d and not stacked_3d:
        raise ValueError(
            "'interaction_matrix' must be of shape "
            "(N,N) or (1,N,N), or (2,N,N) for XY. Instead, "
            f"an array of shape {shape} was given."
        )
    if (
        initial_state is not None
        and shape[-1] != initial_state.n_qudits
    ):
        raise ValueError(
            f"The received interaction matrix of shape {shape}"
            " is incompatible with the received initial state of "
            f"{initial_state.n_qudits} qudits."
        )
    if square_2d:
        matrix = matrix.reshape((-1,) + shape)
    plain = matrix.as_array(detach=True)
    if not np.allclose(plain, np.transpose(plain, (0, 2, 1))):
        raise ValueError(
            "The received interaction matrix is not symmetric."
        )
    if np.any(np.stack([np.diag(x) for x in plain]) != 0):
        warnings.warn(
            "The received interaction matrix has non-zero values"
            " in its diagonal; keep in mind that these values are"
            " ignored.",
            stacklevel=3,
        )
    return matrix


def _resolve_n_trajectories(
    n_trajectories: int | None,
    noise_model: NoiseModel,
    prefer_device_noise_model: bool,
) -> int:
    """Reconciles the trajectory count with the noise model's 'runs'."""
    if (
        n_trajectories is not None
        and noise_model.runs is not None
        and n_trajectories != noise_model.runs
    ):
        raise ValueError(
            "`EmulationConfig.n_trajectories` and `NoiseModel.runs` "
            "can't be simultaneously defined. Please favour using"
            " only `EmulationConfig.n_trajectories`."
        )
    if n_trajectories is None:
        if prefer_device_noise_model:
            n_trajectories = DEFAULT_N_TRAJECTORIES
        elif noise_model.runs is not None:
            n_trajectories = noise_model.runs
        else:
            n_trajectories = 1
    if n_trajectories < 1 or n_trajectories != int(n_trajectories):
        raise ValueError(
            "`n_trajectories` must be a strictly positive integer, "
            f"not {n_trajectories}."
        )
    return int(n_trajectories)


class EmulationConfig(BackendConfig, Generic[StateType]):
    """Configures an emulation on a backend.

    Args:
        observables: A sequence of observables to compute at specific
            evaluation times. Observables without specified evaluation
            times use 'default_evaluation_times'.
        callbacks: General callbacks that are not observables; called at
            every emulation step.
        default_evaluation_times: The default times at which observables
            are computed: a sequence of unique ascending relative times
            between 0 and 1, or "Full" (every emulation step).
        initial_state: The initial state from which emulation starts.
            Defaults to all qudits in the ground state.
        with_modulation: Whether to emulate the sequence with the
            programmed input or the expected output.
        interaction_matrix: An optional replacement for the interaction
            terms in the Hamiltonian: an (N, N) or (1, N, N) symmetric
            matrix, or (2, N, N) in XY (C3 then C6).
        prefer_device_noise_model: If True, uses the noise model of the
            sequence's device (when it has one).
        noise_model: An optional noise model to emulate with.
        n_trajectories: The number of trajectories to average over when
            the emulation includes stochastic noise or uses a Monte Carlo
            solver. Defaults to NoiseModel.runs or 1, or 40 when
            'prefer_device_noise_model=True'.
        default_num_shots: The default number of shots for ``BitStrings``
            observables. Defaults to 1000.
    """

    callbacks: Sequence[Callback]
    observables: Sequence[Observable]
    default_evaluation_times: (
        NDArray[np.floating[Any]] | Literal["Full"]
    )
    initial_state: StateType | None
    with_modulation: bool
    interaction_matrix: pm.AbstractArray | None
    prefer_device_noise_model: bool
    noise_model: NoiseModel
    n_trajectories: int
    default_num_shots: int

    _enforce_expected_kwargs: ClassVar[bool] = False

    _state_type: ClassVar[Type[State]] = StateRepr
    _operator_type: ClassVar[Type[Operator]] = OperatorRepr

    def __init__(
        self,
        *,
        callbacks: Sequence[Callback] = (),
        observables: Sequence[Observable] = (),
        default_evaluation_times: (
            Sequence[SupportsFloat] | Literal["Full"]
        ) = (1.0,),
        initial_state: StateType | None = None,  # Default is ggg...
        with_modulation: bool = False,
        interaction_matrix: ArrayLike | None = None,
        prefer_device_noise_model: bool = False,
        noise_model: NoiseModel | None = None,
        n_trajectories: int | None = None,
        default_num_shots: int = 1000,
        **backend_options: Any,
    ) -> None:
        """Initializes the EmulationConfig."""
        if not observables and not callbacks:
            warnings.warn(
                f"{self.__class__.__name__!r} was initialized without any"
                " observables. The corresponding emulation results will"
                " be empty.",
                stacklevel=2,
            )
        _checked_callbacks(callbacks, observables)

        if not (
            isinstance(default_evaluation_times, str)
            and default_evaluation_times == "Full"
        ):
            default_evaluation_times = cast(
                Sequence[float],
                Observable._validate_eval_times(
                    list(map(float, default_evaluation_times))
                ),
            )

        if initial_state is not None and not isinstance(
            initial_state, State
        ):
            raise TypeError(
                "When defined, 'initial_state' must be an instance of"
                f" State; got object of type {type(initial_state)}"
                " instead."
            )

        if interaction_matrix is not None:
            interaction_matrix = _checked_interaction_matrix(
                interaction_matrix, initial_state
            )

        if noise_model is None:
            noise_model = NoiseModel()
        elif not isinstance(noise_model, NoiseModel):
            raise TypeError(
                "When defined, 'noise_model' must be a NoiseModel"
                f" instance, not {type(noise_model)}."
            )

        n_trajectories = _resolve_n_trajectories(
            n_trajectories, noise_model, prefer_device_noise_model
        )

        super().__init__(
            callbacks=tuple(callbacks),
            observables=tuple(observables),
            default_evaluation_times=default_evaluation_times,
            initial_state=initial_state,
            with_modulation=bool(with_modulation),
            interaction_matrix=interaction_matrix,
            prefer_device_noise_model=bool(prefer_device_noise_model),
            noise_model=noise_model,
            n_trajectories=n_trajectories,
            default_num_shots=int(default_num_shots),
            **backend_options,
        )

    def _expected_kwargs(self) -> set[str]:
        return super()._expected_kwargs() | {
            "callbacks",
            "observables",
            "default_evaluation_times",
            "initial_state",
            "with_modulation",
            "interaction_matrix",
            "prefer_device_noise_model",
            "noise_model",
            "n_trajectories",
        }

    @classproperty
    def state_type(cls) -> Type[State]:
        """The preferred state type to use with this config class."""
        return cls._state_type

    @classproperty
    def operator_type(cls) -> Type[Operator]:
        """The preferred operator type to use with this config class."""
        return cls._operator_type

    def is_evaluation_time(self, t: float, tol: float = 1e-6) -> bool:
        """Assesses whether a relative time is an evaluation time."""
        eval_times = self.default_evaluation_times
        if isinstance(eval_times, str) and eval_times == "Full":
            return 0.0 <= t <= 1.0
        return self.is_time_in_evaluation_times(t, eval_times, tol=tol)

    @staticmethod
    def is_time_in_evaluation_times(
        t: float, evaluation_times: ArrayLike, tol: float = 1e-6
    ) -> bool:
        """Checks if a time is within a collection of evaluation times."""
        if not 0.0 <= t <= 1.0:
            return False
        gaps = np.abs(np.array(evaluation_times, dtype=float) - t)
        return bool(np.any(gaps <= tol))

    def _to_abstract_repr(self) -> dict[str, Any]:
        return self._backend_options

    def to_abstract_repr(self, skip_validation: bool = False) -> str:
        """Serialize `EmulationConfig` to a JSON formatted str."""
        obj_str = json.dumps(self, cls=AbstractReprEncoder)
        if not skip_validation:
            validate_abstract_repr(obj_str, "config")
        return obj_str

    @classmethod
    def from_abstract_repr(cls, obj_str: str) -> EmulationConfig:
        """Deserialize an EmulationConfig from an abstract JSON object."""
        if not isinstance(obj_str, str):
            raise TypeError(
                "The serialized EmulationConfig must be given as a"
                f" string. Instead, got object of type {type(obj_str)}."
            )
        validate_abstract_repr(obj_str, "config")
        from pulser_tpu_torch.json.abstract_repr.backend import (
            _deserialize_emulation_config,
        )

        return _deserialize_emulation_config(
            json.loads(obj_str),
            cls,
            cls.state_type,
            cls.operator_type,
        )


# Legacy class


def _legacy_eval_times_check(
    evaluation_times: float | Sequence[float] | EVAL_TIMES_LITERAL,
) -> None:
    """Validates the legacy (EmulatorConfig) evaluation-times forms."""
    if isinstance(evaluation_times, str):
        if evaluation_times not in get_args(EVAL_TIMES_LITERAL):
            raise ValueError(
                "If provided as a string, 'evaluation_times' must be"
                " one of the following options:"
                f" {get_args(EVAL_TIMES_LITERAL)}"
            )
    elif isinstance(evaluation_times, float):
        if not (0 < evaluation_times <= 1.0):
            raise ValueError(
                "If provided as a float, 'evaluation_times' must be"
                " greater than 0 and less than or equal to 1."
            )
    elif isinstance(evaluation_times, (list, tuple, np.ndarray)):
        if np.min(evaluation_times, initial=0) < 0:
            raise ValueError(
                "If provided as a sequence of values, "
                "'evaluation_times' must not contain negative values."
            )
    else:
        raise TypeError(
            f"'{type(evaluation_times)}' is not a valid"
            " type for 'evaluation_times'."
        )


@dataclass(frozen=True)
class EmulatorConfig(BackendConfig):
    """The (legacy) configuration for emulator backends.

    Args:
        backend_options: A dictionary of backend-specific options.
        sampling_rate: The fraction of samples to extract from the pulse
            sequence for emulation.
        evaluation_times: "Full", "Minimal", "Final", a list of times in
            µs, or a float acting as a sampling rate for the state.
        initial_state: "all-ground" or an array compatible with the
            system.
        with_modulation: Whether to emulate with the programmed input or
            the expected output.
        prefer_device_noise_model: Prefer the device's default noise
            model, when available.
        noise_model: An optional noise model to emulate the sequence
            with.
    """

    backend_options: dict[str, Any] = field(default_factory=dict)
    sampling_rate: float = 1.0
    evaluation_times: (
        float | Sequence[float] | EVAL_TIMES_LITERAL
    ) = "Full"
    initial_state: (
        Literal["all-ground"] | Sequence[complex] | np.ndarray
    ) = "all-ground"
    with_modulation: bool = False
    prefer_device_noise_model: bool = False
    noise_model: NoiseModel = field(default_factory=NoiseModel)

    def __post_init__(self) -> None:
        if not (0 < self.sampling_rate <= 1.0):
            raise ValueError(
                "The sampling rate (`sampling_rate` = "
                f"{self.sampling_rate}) must be greater than 0 and "
                "less than or equal to 1."
            )
        _legacy_eval_times_check(self.evaluation_times)

        if isinstance(self.initial_state, str):
            if self.initial_state != "all-ground":
                raise ValueError(
                    "If provided as a string, 'initial_state' must be"
                    " 'all-ground'."
                )
        elif not isinstance(
            self.initial_state, (tuple, list, np.ndarray)
        ):
            raise TypeError(
                f"'{type(self.initial_state)}' is not a valid type for"
                " 'initial_state'."
            )

        if not isinstance(self.noise_model, NoiseModel):
            raise TypeError(
                "'noise_model' must be a NoiseModel instance,"
                f" not {type(self.noise_model)}."
            )
