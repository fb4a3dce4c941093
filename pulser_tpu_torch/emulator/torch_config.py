"""The TorchConfig: configuration of a TorchBackendV2.

Port of ``pulser_tpu/emulator/tpu_config.py`` (behavioral parity with
reference ``pulser-simulation/pulser_simulation/qutip_config.py:28-192``,
``QutipConfig``), with the torch device the emulation runs on.
"""

from __future__ import annotations

import warnings
from typing import Any, ClassVar, Literal

import numpy as np
import torch

from pulser_tpu_torch.backend.config import EmulationConfig
from pulser_tpu_torch.emulator.simulation import Solver
from pulser_tpu_torch.emulator.torch_op import TorchOperator
from pulser_tpu_torch.emulator.torch_state import TorchState


class TorchConfig(EmulationConfig[TorchState]):
    """The configuration of a TorchBackendV2.

    - Dedicated ``State`` class: :class:`TorchState`
    - Dedicated ``Operator`` class: :class:`TorchOperator`

    Args:
        observables: A sequence of observables to compute at specific
            evaluation times.
        sampling_rate: The fraction of samples to extract from the pulse
            sequence for emulation.
        default_evaluation_times: The default times at which observables
            are computed ("Full" or ascending relative times in [0, 1]).
        initial_state: The initial state (a TorchState) from which
            emulation starts; defaults to all qudits in the ground state.
        with_modulation: Whether to emulate the programmed input or the
            expected output.
        prefer_device_noise_model: Prefer the device's noise model, when
            available.
        noise_model: An optional noise model to emulate with.
        solver: Solver selection (see :class:`Solver`).
        print_progress: Whether to print the trajectory being emulated.
        progress_bar: Kept for API parity.
        torch_device: The torch device the emulator runs on (default: the
            first CUDA device; without one the backend raises, and
            ``"cpu"`` must be asked for).
    """

    _enforce_expected_kwargs: ClassVar[bool] = True

    sampling_rate: float
    """The fraction of sequence samples to extract for emulation."""

    _state_type = TorchState
    _operator_type = TorchOperator

    solver: Solver

    def __init__(
        self,
        *,
        sampling_rate: float = 1.0,
        solver: (
            Solver | Literal["default", "MasterEquation", "MonteCarlo"]
        ) = Solver.DEFAULT,
        print_progress: bool = False,
        progress_bar: bool = False,
        torch_device: str | torch.device | None = None,
        **backend_options: Any,
    ):
        """Initializes a TorchConfig."""
        self._screen_options(sampling_rate, backend_options)
        super().__init__(
            sampling_rate=sampling_rate,
            solver=self._coerce_solver(solver),
            print_progress=print_progress,
            progress_bar=progress_bar,
            torch_device=(
                None if torch_device is None else str(torch_device)
            ),
            **backend_options,
        )

    @staticmethod
    def _screen_options(
        sampling_rate: float, backend_options: dict[str, Any]
    ) -> None:
        """Rejects/flags option combinations this backend can't run."""
        if backend_options.setdefault("interaction_matrix") is not None:
            raise NotImplementedError(
                "'TorchBackendV2' does not handle custom interaction"
                " matrices."
            )
        if not (0 < sampling_rate <= 1.0):
            raise ValueError(
                f"The sampling rate (`sampling_rate` = {sampling_rate})"
                " must be greater than 0 and less than or equal to 1."
            )
        initial_state = backend_options.setdefault("initial_state")
        if initial_state and not isinstance(initial_state, TorchState):
            raise TypeError(
                "If provided, `initial_state` must be an instance of "
                f"`TorchState`, not {type(initial_state)}."
            )
        noise_model = backend_options.get("noise_model")
        if (
            noise_model is not None
            and noise_model.samples_per_run not in (None, 1)
        ):
            warnings.warn(
                f"The number of samples per run (`samples_per_run` "
                f"= {noise_model.samples_per_run}) "
                f"is ignored when using TorchBackendV2.",
                stacklevel=2,
            )

    @staticmethod
    def _coerce_solver(solver: Any) -> Solver:
        try:
            return Solver(solver)
        except ValueError:
            allowed_str = ", ".join(s.value for s in Solver)
            raise ValueError(
                f"Invalid solver '{solver}'. "
                f"Allowed solvers are: {allowed_str}."
            )

    def _expected_kwargs(self) -> set[str]:
        return super()._expected_kwargs() | {
            "sampling_rate",
            "solver",
            "print_progress",
            "progress_bar",
            "torch_device",
        }

    def _to_abstract_repr(self) -> dict[str, Any]:
        # The torch device says where this process emulates, not what:
        # it stays off the wire, and a loaded config takes the default
        options = dict(super()._to_abstract_repr())
        options.pop("torch_device", None)
        return options

    def _get_sampling_indices(
        self, total_duration_ns: int
    ) -> np.ndarray:
        """The indices at which samples are taken."""
        return self._calculate_sampling_indices(
            self.sampling_rate, total_duration_ns
        )

    @staticmethod
    def _calculate_sampling_indices(
        sampling_rate: float, total_duration_ns: int
    ) -> np.ndarray:
        return np.linspace(
            0,
            total_duration_ns - 1,
            int(sampling_rate * total_duration_ns),
            dtype=int,
        )

    def _get_legacy_evaluation_times(
        self, total_duration_ns: int
    ) -> Literal["Full"] | np.ndarray:
        """Merges per-observable times into the legacy spec.

        Callbacks need every step, so they force "Full"; otherwise
        the default times union with each observable's own times
        (materializing "Full" onto the sampling grid if needed).
        """
        if self.callbacks:
            return "Full"
        per_obs = {
            t
            for obs in self.observables
            if obs.evaluation_times is not None
            for t in obs.evaluation_times
        }
        rel = self.default_evaluation_times
        is_full = isinstance(rel, str) and rel == "Full"
        if not per_obs:
            if is_full:
                return "Full"
        else:
            if is_full:
                rel = (
                    self._get_sampling_indices(total_duration_ns)
                    / total_duration_ns
                )
            rel = np.union1d(rel, list(per_obs))
        return np.asarray(rel) * total_duration_ns * 1e-3


# Drop-in alias matching the reference class name
QutipConfig = TorchConfig
