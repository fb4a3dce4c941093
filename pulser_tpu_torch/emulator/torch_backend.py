"""The TorchBackend/TorchBackendV2 classes.

Port of ``pulser_tpu/emulator/tpu_backend.py`` (behavioral parity with
reference ``pulser-simulation/pulser_simulation/qutip_backend.py:44-325``,
``QutipBackend``/``QutipBackendV2``). The observables read the solver's
states where they lie: a coherent run's states stay on the device
(:meth:`DeviceStateBatch.device_state`), and the Hamiltonian each
consumer gets is a :class:`HamiltonianOperator` over the noiseless
Hamiltonian, built once per run, that never forms its matrix. The order
of draws from the numpy global RNG is the JAX package's: the trajectory
noise and seeds first, then the observables trajectory by trajectory and
evaluation time by evaluation time.
"""

from __future__ import annotations

import warnings
from typing import TYPE_CHECKING, Any

from pulser_tpu_torch.backend.abc import Backend, EmulatorBackend
from pulser_tpu_torch.backend.config import EmulationConfig, EmulatorConfig
from pulser_tpu_torch.backend.default_observables import (
    BitStrings,
    StateResult,
)
from pulser_tpu_torch.backend.results import Results
from pulser_tpu_torch.devices._device_datacls import BaseDevice
from pulser_tpu_torch.noise_model import NoiseModel
from pulser_tpu_torch.register.base_register import BaseRegister
from pulser_tpu_torch.sampler.samples import SequenceSamples
from pulser_tpu_torch.emulator.aggregators import density_matrix_aggregator
from pulser_tpu_torch.emulator.torch_config import TorchConfig
from pulser_tpu_torch.emulator.torch_op import (
    HamiltonianOperator,
    TorchOperator as TorchOperator,
)
from pulser_tpu_torch.emulator.torch_state import (
    TorchState as TorchState,
    unit_state,
)
from pulser_tpu_torch.emulator.simresults import (
    CoherentResults,
    SimulationResults,
)
from pulser_tpu_torch.emulator.simulation import (
    TorchEmulator,
    _has_stochastic_noise,
)

if TYPE_CHECKING:
    from pulser_tpu_torch.sequence import Sequence


def _get_state_tag(results: Results) -> str | None:
    for tag in results.get_result_tags():
        if tag.startswith(StateResult()._base_tag):
            return tag
    return None


class TorchBackend(Backend):
    """A (legacy-API) backend for emulating sequences.

    Warning:
        Mirrors the deprecated ``QutipBackend``; please use
        :class:`TorchBackendV2`.

    Args:
        sequence: The sequence to emulate.
        config: The configuration for the emulator.
        mimic_qpu: Whether to mimic the validations necessary for
            execution on a QPU.
        torch_device: The torch device the emulator runs on (default: the
            first CUDA device; without one the constructor raises, and
            ``"cpu"`` must be asked for).
    """

    def __init__(
        self,
        sequence: Sequence,
        config: EmulatorConfig = EmulatorConfig(),
        mimic_qpu: bool = False,
        torch_device: Any = None,
    ):
        """Initializes a new TorchBackend."""
        with warnings.catch_warnings():
            warnings.simplefilter("once")
            warnings.warn(
                "'TorchBackend' is deprecated. Please use "
                "'pulser_tpu_torch.emulator.TorchBackendV2' instead.",
                DeprecationWarning,
                stacklevel=2,
            )
        super().__init__(sequence, mimic_qpu=mimic_qpu)
        if not isinstance(config, EmulatorConfig):
            raise TypeError(
                "'config' must be of type 'EmulatorConfig', "
                f"not {type(config)}."
            )
        self._config = config
        noise_model: None | NoiseModel = None
        if self._config.prefer_device_noise_model:
            noise_model = sequence.device.noise_model
        self._sim_obj = TorchEmulator.from_sequence(
            sequence,
            sampling_rate=self._config.sampling_rate,
            noise_model=noise_model or self._config.noise_model,
            evaluation_times=self._config.evaluation_times,
            with_modulation=self._config.with_modulation,
            torch_device=torch_device,
        )
        self._sim_obj.set_initial_state(self._config.initial_state)

    def run(
        self, progress_bar: bool = False, **solver_options: Any
    ) -> SimulationResults:
        """Emulates the sequence with the PyTorch solvers."""
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            return self._sim_obj.run(
                progress_bar=progress_bar, **solver_options
            )


class TorchBackendV2(EmulatorBackend):
    """An emulator backend conforming to the generic pulser backend API.

    Dedicated ``EmulationConfig`` class: :class:`TorchConfig`, whose
    ``torch_device`` the emulator runs on (default: the first CUDA device;
    without one the constructor raises).

    Args:
        sequence: The sequence to emulate.
        config: The configuration for the emulator.
        mimic_qpu: Whether to mimic the validations necessary for
            execution on a QPU.
    """

    default_config = TorchConfig(
        observables=[
            BitStrings(evaluation_times=[1.0]),
            StateResult(),
        ]
    )
    _config: TorchConfig

    def __init__(
        self,
        sequence: Sequence,
        *,
        config: EmulationConfig | None = None,
        mimic_qpu: bool = False,
    ) -> None:
        """Initializes the backend."""
        super().__init__(sequence, config=config, mimic_qpu=mimic_qpu)
        self._sim_obj, self._solver_options = (
            TorchBackendV2._prepare_emulator(
                self._config,
                TorchEmulator.from_sequence(
                    sequence,
                    sampling_rate=self._config.sampling_rate,
                    noise_model=self._get_noise_model(
                        self._config, sequence.device
                    ),
                    with_modulation=self._config.with_modulation,
                    solver=self._config.solver,
                    n_trajectories=self._config.n_trajectories,
                    torch_device=self._config.torch_device,
                ),
            )
        )
        self._sim_obj._validate_options(self._solver_options)

    @staticmethod
    def _get_noise_model(
        config: EmulationConfig, device: BaseDevice
    ) -> NoiseModel:
        noise_model: None | NoiseModel = None
        if config.prefer_device_noise_model:
            noise_model = device.noise_model
        return noise_model or config.noise_model

    @staticmethod
    def _prepare_emulator(
        config: EmulationConfig, sim_obj: TorchEmulator
    ) -> tuple[TorchEmulator, dict[str, Any]]:
        """Applies the config's emulator-side settings.

        Shared by the sequence-based and samples-based entry points:
        evaluation times merged from the observables, the optional
        initial state, and the progress options.
        """
        sim_obj.set_evaluation_times(
            config._get_legacy_evaluation_times(
                sim_obj.total_duration_ns
            ),
        )
        if config.initial_state:
            sim_obj.set_initial_state(config.initial_state.to_qobj())
        solver_options = {
            "print_progress": config.print_progress,
            "progress_bar": config.progress_bar,
        }
        return sim_obj, solver_options

    def run(self) -> Results:
        """Executes the sequence on the backend."""
        return TorchBackendV2._run_raw(
            self._sim_obj,
            self._config,
            self._solver_options,
        )

    @staticmethod
    def run_from_sequence_samples(
        sequence_samples: SequenceSamples,
        register: BaseRegister,
        device: BaseDevice,
        *,
        config: EmulationConfig | None = None,
    ) -> Results:
        """Executes the sampled sequence on the backend.

        Args:
            sequence_samples: The sampled sequence to emulate.
            register: The qubit register.
            device: The device to emulate.
            config: The configuration for the emulation.
        """
        config = config or TorchBackendV2.default_config
        sim_obj, solver_options = TorchBackendV2._prepare_emulator(
            config,
            TorchEmulator(
                sequence_samples,
                register,
                device,
                sampling_rate=config.sampling_rate,
                config=None,
                noise_model=TorchBackendV2._get_noise_model(
                    config, device
                ),
                solver=config.solver,
                n_trajectories=config.n_trajectories,
                torch_device=config.torch_device,
            ),
        )
        return TorchBackendV2._run_raw(sim_obj, config, solver_options)

    @staticmethod
    def _run_raw(
        sim_obj: TorchEmulator,
        config: EmulationConfig,
        solver_options: dict[str, Any],
    ) -> Results:
        """Executes the sequence on the backend."""
        eigenstates = (
            sim_obj._current_hamiltonian.basis_data.eigenbasis
        )
        device = sim_obj._torch_device
        # The device copies of the noiseless Hamiltonian's static parts,
        # shared by every evaluation time of every trajectory
        ham_cache: dict = {}

        def _feed_results(
            coherent_res: CoherentResults, res: Results
        ) -> None:
            consumers = (
                *config.callbacks,
                *config.observables,
            )
            device_states = getattr(coherent_res, "_device_states", None)
            for i, sim_res in enumerate(coherent_res):
                t = sim_res.evaluation_time
                state = unit_state(
                    sim_res.state
                    if device_states is None
                    else device_states.device_state(i),
                    eigenstates,
                    torch_device=device,
                )
                # Built once (and first built here, after the solve: its
                # draw from the numpy global RNG comes where the JAX
                # package's does)
                ham = HamiltonianOperator(
                    sim_obj._get_noiseless_hamiltonian(
                        config.noise_model.with_leakage
                    ),
                    t * res.total_duration / 1000,
                    eigenstates,
                    cache=ham_cache,
                )
                for consume in consumers:
                    consume(
                        config=config,
                        t=float(t),
                        state=state,
                        hamiltonian=ham,
                        result=res,
                    )

        if not _has_stochastic_noise(sim_obj.noise_model):
            # A single run is needed, regardless of the trajectory count
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                single_res = sim_obj.run(**solver_options)
            assert isinstance(single_res, CoherentResults)
            res = Results(
                atom_order=tuple(sim_obj._register.qubit_ids),
                total_duration=sim_obj.total_duration_ns,
            )
            _feed_results(single_res, res)
            return res
        else:
            results: list[Results] = []
            for cleanres_noisyseq, reps in sim_obj._noisy_runs(
                **solver_options
            ):
                for _ in range(reps):
                    res = Results(
                        atom_order=tuple(sim_obj._register.qubit_ids),
                        total_duration=sim_obj.total_duration_ns,
                    )
                    _feed_results(cleanres_noisyseq, res)
                    results.append(res)
            custom_aggregators = {}
            if (state_tag := _get_state_tag(results[0])) is not None:
                custom_aggregators[state_tag] = (
                    density_matrix_aggregator
                )
            return Results.aggregate(results, **custom_aggregators)


# Drop-in aliases matching the reference class names
QutipBackend = TorchBackend
QutipBackendV2 = TorchBackendV2
