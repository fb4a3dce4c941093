"""The TorchEmulator: simulates sampled sequences with PyTorch solvers.

Port of ``pulser_tpu/emulator/simulation.py`` (itself behavioral parity
with reference ``pulser-simulation/pulser_simulation/simulation.py``,
``QutipEmulator``), for the coherent noiseless path: QuTiP's
``sesolve`` becomes :func:`~pulser_tpu_torch.ops.solver.sesolve_rk4` in
the interaction picture, on a CUDA device when there is one.

The evaluation-times semantics (Full/Minimal/array/fraction, union with
{0, T}), the +1 duration extension, the step policy and the
renormalization at evaluation times match the JAX package exactly, so
both build the same plan. Noisy runs, density-matrix inputs, the
lab-frame solve and ``from_sequence`` are not ported yet (see
ROADMAP.md).
"""

from __future__ import annotations

import functools
import os
import warnings
from typing import Any, Optional, Union, cast

import numpy as np
import torch
from numpy.typing import ArrayLike

from pulser_tpu_torch.channels.base_channel import States
from pulser_tpu_torch.devices._device_datacls import BaseDevice
from pulser_tpu_torch.emulator.hamiltonian import Hamiltonian
from pulser_tpu_torch.emulator.qobj import Qobj, tensor
from pulser_tpu_torch.emulator.sim_result import TorchResult
from pulser_tpu_torch.emulator.simconfig import SimConfig
from pulser_tpu_torch.emulator.simresults import CoherentResults
from pulser_tpu_torch.hamiltonian_data import HamiltonianData
from pulser_tpu_torch.noise_model import NoiseModel
from pulser_tpu_torch.ops import solver as _solver_mod
from pulser_tpu_torch.ops.solver import build_plan
from pulser_tpu_torch.register.base_register import BaseRegister
from pulser_tpu_torch.sampler.samples import ChannelSamples, SequenceSamples


def _quantized_step(base_step: float, stability_cap: float) -> float:
    """Halves ``base_step`` until it satisfies the stability cap.

    Snapping the step to a power-of-two ladder keeps the integration
    grid identical across runs whose coefficient magnitudes only
    fluctuate by a few percent.
    """
    step = base_step
    while step > stability_cap:
        step /= 2
    return step


def _default_cdtype() -> torch.dtype:
    """complex128 under a float64 torch default dtype, else complex64."""
    return (
        torch.complex128
        if torch.get_default_dtype() == torch.float64
        else torch.complex64
    )


class TorchEmulator:
    r"""Emulator of a sampled pulse sequence using PyTorch solvers.

    Args:
        sampled_seq: The pulse sequence samples used in the emulation.
        register: The register associating coordinates to the qubits
            targeted by the samples.
        device: The device specifications (register and samples must
            satisfy its constraints).
        sampling_rate: The fraction of samples to extract for the
            simulation (between 0.05 and 1.0).
        config: (Deprecated) SimConfig; use ``noise_model``.
        evaluation_times: "Full", "Minimal", an array of times (in µs)
            or a float sampling fraction.
        noise_model: The noise model for the simulation. Only a model
            without effective noise is supported so far.
        torch_device: The torch device the solver runs on (default: the
            first CUDA device when there is one, else the CPU).
    """

    def __init__(
        self,
        sampled_seq: SequenceSamples,
        register: BaseRegister,
        device: BaseDevice,
        sampling_rate: float = 1.0,
        config: Optional[SimConfig] = None,
        evaluation_times: Union[float, str, ArrayLike] = "Full",
        noise_model: NoiseModel | None = None,
        torch_device: Union[str, torch.device, None] = None,
    ) -> None:
        """Instantiates a TorchEmulator object."""
        if not isinstance(sampled_seq, SequenceSamples):
            raise TypeError(
                "The provided sequence has to be a valid "
                "SequenceSamples instance."
            )
        if sampled_seq.max_duration == 0:
            raise ValueError("SequenceSamples is empty.")
        self._sampling_rate = sampling_rate
        device.validate_register(register)
        self._register = register
        self._torch_device = _solver_mod._resolve_device(torch_device)
        # Smallest quantized step chosen so far, per solver context —
        # see _sticky_quantized_step
        self._sticky_steps: dict[str, float] = {}
        if (
            sampled_seq._slm_mask.end > 0
            and not device.supports_slm_mask
        ):
            raise ValueError(
                "Samples use SLM mask but device does not have one."
            )
        if not sampled_seq.used_bases <= device.supported_bases:
            raise ValueError(
                "Bases used in samples should be supported by device."
            )
        if not sampled_seq._slm_mask.targets <= set(register.qubit_ids):
            raise ValueError(
                "The ids of qubits targeted in SLM mask"
                " should be defined in register."
            )

        self._tot_duration = sampled_seq.max_duration
        self.samples_obj = sampled_seq.extend_duration(
            self._tot_duration + 1
        )

        if not (0 < sampling_rate <= 1.0):
            raise ValueError(
                "The sampling rate (`sampling_rate` = "
                f"{sampling_rate}) must be greater than 0 and "
                "less than or equal to 1."
            )
        if int(self._tot_duration * sampling_rate) < 4:
            raise ValueError(
                "`sampling_rate` is too small, less than 4 data points."
            )

        if noise_model is not None and config is not None:
            raise ValueError(
                "'noise_model' and 'config' cannot both be provided to "
                "'TorchEmulator'. Please provide just a 'noise_model'."
            )
        if config is not None:
            with warnings.catch_warnings():
                warnings.simplefilter("once")
                warnings.warn(
                    "Supplying a 'SimConfig' to the emulator has been "
                    "deprecated. Please instantiate with a 'NoiseModel' "
                    "instead.",
                    DeprecationWarning,
                    stacklevel=2,
                )
            noise_model = config.to_noise_model()
        if not noise_model:
            noise_model = NoiseModel()
        if noise_model.noise_types:
            raise NotImplementedError(
                "Noisy emulation is not ported yet (ROADMAP.md Queue 1,"
                " 'batched plans and MCWF' and 'mesolve')."
            )

        self._hamiltonian_data = HamiltonianData(
            self.samples_obj, register, device, noise_model, 1
        )
        traj, samples, _ = next(self._hamiltonian_data.noisy_samples)
        self._current_hamiltonian = Hamiltonian(
            samples,
            traj,
            self._hamiltonian_data.basis_data,
            self._hamiltonian_data.lindblad_data,
            self._sampling_rate,
        )
        self._eval_times_array: np.ndarray
        self.set_evaluation_times(evaluation_times)

        if self.samples_obj._measurement:
            self._meas_basis = self.samples_obj._measurement
        elif "all" in self.basis_name:
            self._meas_basis = "digital"
        else:
            self._meas_basis = self.basis_name.replace("_with_error", "")
        self.set_initial_state("all-ground")

    @property
    def device(self) -> BaseDevice:
        """The device being simulated."""
        return self._hamiltonian_data.device

    @property
    def sampling_times(self) -> np.ndarray:
        """The times at which the hamiltonian is sampled."""
        return self._current_hamiltonian.sampling_times

    @property
    def dim(self) -> int:
        """The dimension of the basis."""
        return self._hamiltonian_data.basis_data.dim

    @property
    def basis_name(self) -> str:
        """The name of the basis."""
        return self._hamiltonian_data.basis_data.basis_name

    @property
    def basis(self) -> dict[States, Any]:
        """The basis in which results are expressed."""
        return self._current_hamiltonian.basis

    @property
    def noise_model(self) -> NoiseModel:
        """The current NoiseModel being used."""
        return self._hamiltonian_data.noise_model

    @property
    def total_duration_ns(self) -> int:
        """The total duration of the sequence, in ns."""
        return self._tot_duration

    @property
    def initial_state(self) -> Qobj:
        """The initial state of the simulation."""
        return self._initial_state

    def set_initial_state(
        self, state: Union[str, np.ndarray, Qobj]
    ) -> None:
        """Sets the initial state of the simulation.

        Args:
            state: "all-ground", an ArrayLike with a compatible shape,
                or a Qobj.
        """
        self._initial_state: Qobj
        n_qudits = self._hamiltonian_data.n_qudits
        if isinstance(state, str) and state == "all-ground":
            v = self._hamiltonian_data.basis_data.interaction_type
            self._initial_state = tensor(
                [self.basis[("u" if v == "XY" else "g")]] * n_qudits
            )
        else:
            state = cast(Union[np.ndarray, Qobj], state)
            shape = state.shape[0]
            dim = self._hamiltonian_data.basis_data.dim
            legal_shape = dim**n_qudits
            if shape != legal_shape:
                raise ValueError(
                    "Incompatible shape of initial state."
                    + f"Expected {legal_shape}, got {shape}."
                )
            self._initial_state = Qobj(
                np.asarray(state), dims=[[dim] * n_qudits, [1] * n_qudits]
            ).unit()
        self._initial_ket_cache: np.ndarray | None = None

    def _initial_ket(self) -> np.ndarray:
        """The initial statevector, materialized once per state."""
        if self._initial_ket_cache is None:
            self._initial_ket_cache = self.initial_state.full()[:, 0]
        return self._initial_ket_cache

    @property
    def evaluation_times(self) -> np.ndarray:
        """The times at which results are returned."""
        return np.array(self._eval_times_array)

    def set_evaluation_times(
        self, value: Union[str, ArrayLike, float]
    ) -> None:
        """Sets the times at which results are returned.

        Args:
            value: "Full", "Minimal", an array of times (in µs) or a
                float sampling fraction.
        """
        if isinstance(value, str):
            if value == "Full":
                eval_times = np.copy(self.sampling_times)
            elif value == "Minimal":
                eval_times = np.array([])
            else:
                raise ValueError(
                    "Wrong evaluation time label. It should "
                    "be `Full`, `Minimal`, an array of times or"
                    + " a float between 0 and 1."
                )
        elif isinstance(value, float):
            if value > 1 or value <= 0:
                raise ValueError(
                    "evaluation_times float must be between 0 and 1."
                )
            indices = np.linspace(
                0,
                len(self.sampling_times) - 1,
                int(value * len(self.sampling_times)),
                dtype=int,
            )
            eval_times = self.sampling_times[indices]
        elif isinstance(value, (list, tuple, np.ndarray)):
            if np.max(value, initial=0) > self._tot_duration * 1e-3:
                raise ValueError(
                    "Provided evaluation-time list extends "
                    "further than sequence duration."
                )
            if np.min(value, initial=0) < 0:
                raise ValueError(
                    "Provided evaluation-time list contains "
                    "negative values."
                )
            eval_times = np.array(value)
        else:
            raise ValueError(
                "Wrong evaluation time label. It should "
                "be `Full`, `Minimal`, an array of times or a "
                + "float between 0 and 1."
            )
        # Ensure 0 and final time are included:
        self._eval_times_array = np.union1d(
            eval_times, [0.0, self._tot_duration * 1e-3]
        )
        self._eval_times_instruction = value

    @staticmethod
    def _get_min_variation(ch_sample: ChannelSamples) -> int:
        """Minimum nonzero variation interval of the samples (in ns)."""
        end_point = ch_sample.duration - 1
        min_variations: list[int] = []
        for sample in (
            ch_sample.amp.as_array(detach=True),
            ch_sample.det.as_array(detach=True),
        ):
            min_variations.append(
                int(
                    np.min(
                        np.diff(
                            np.nonzero(np.diff(sample)),
                            prepend=-1,
                            append=end_point,
                        )
                    )
                )
            )
        return min(min_variations)

    def _coarse_ip_step(
        self,
        key: str,
        fine_step: float,
        lambda_max: float,
        hamiltonians: "list[Hamiltonian]",
        options: dict,
        margin: "float | None" = None,
    ) -> tuple[float, bool]:
        """Interaction-picture step coarsening.

        The IP solve rotates the full diagonal away with exact
        closed-form phase integrals over every coefficient sample, so
        the integrator need not resolve the 1 ns grid. The step must
        still resolve (a) the rotated drive's fastest oscillation —
        the largest single-flip energy gap plus the detuning — and
        (b) the drive's own RK4 bound. Empirically ω·h ≤ 1.2 holds
        1−F ≤ 1e-9 on the AFM benchmarks. Opt out (or force a cap)
        with ``PULSER_TPU_COARSE_STEP``, as in the JAX package.

        Returns the (possibly enlarged) step and whether the plan
        should be built with ``coarsen=True``.
        """
        coarse_env = os.environ.get("PULSER_TPU_COARSE_STEP", "")
        if coarse_env == "0":
            return fine_step, False
        omega_max = max(
            float(getattr(h, "max_flip_gap", 0.0))
            + (
                float(np.max(np.abs(h.det_coeffs)))
                if h.det_coeffs.size
                else 0.0
            )
            for h in hamiltonians
        )
        # The stage lerp reads the knot data at the stage times only,
        # so sub-step coefficient CURVATURE is a further bound: keep
        # the lerp's quadratic miss below ~1e-3 of the coefficient
        # scale. The 95th percentile ignores isolated kinks (pulse
        # junctions), whose global error contribution is negligible,
        # while broadband per-ns structure clamps the step down.
        h_feat = np.inf
        for ham in hamiltonians:
            times = np.asarray(ham.sampling_times)
            knot_dt = (
                float(np.median(np.diff(times)))
                if len(times) > 1
                else 1e-3
            )
            for arr in (ham.amp_coeffs, ham.det_coeffs):
                arr = np.asarray(arr)
                if arr.shape[-1] < 3:
                    continue
                for comp in (arr.real, arr.imag):
                    scale = float(np.max(np.abs(comp)))
                    if scale == 0.0:
                        continue
                    d2 = (
                        np.abs(np.diff(comp, n=2, axis=-1))
                        / knot_dt**2
                    )
                    q = float(np.quantile(d2, 0.95))
                    if q > 0.0:
                        h_feat = min(
                            h_feat, float(np.sqrt(8e-3 * scale / q))
                        )
        if margin is None:
            margin = 1.3 if len(hamiltonians) > 1 else 1.0
        coarse_cap = float(coarse_env) if coarse_env else 4e-3
        coarse_step = self._sticky_quantized_step(
            key,
            coarse_cap,
            min(
                1.2 / max(margin * omega_max, 1e-9),
                0.8 / max(margin * lambda_max, 1e-9),
                h_feat,
            ),
        )
        if "max_step" in options and not options.get("_max_step_auto"):
            # A user-chosen cap binds; the auto heuristic (minimal
            # sample variation, QuTiP parity) does not.
            coarse_step = min(coarse_step, float(options["max_step"]))
        if coarse_step > fine_step:
            return coarse_step, True
        return fine_step, False

    @staticmethod
    def _sharp_knots(
        hamiltonians: "list[Hamiltonian]", knots: np.ndarray
    ) -> "np.ndarray | None":
        """Knot times where a coefficient's slope jumps sharply.

        Pulse edges (a constant pulse's 1-sample drop to zero, square
        EOM blocks) must anchor the coarsened integration grid — a
        large step would otherwise smear the jump across its stages
        with an O(h) error. Gentle slope changes (ramp junctions)
        stay unanchored: their contribution is O(h³) per kink.
        """
        if len(knots) < 3:
            return None
        marks = np.zeros(len(knots) - 2, dtype=bool)
        for ham in hamiltonians:
            for arr in (ham.amp_coeffs, ham.det_coeffs):
                arr = np.asarray(arr)
                if arr.shape[-1] != len(knots):
                    continue
                for comp in (arr.real, arr.imag):
                    thresh = 0.05 * float(np.max(np.abs(comp)))
                    if thresh == 0.0:
                        continue
                    d2 = np.abs(np.diff(comp, n=2, axis=-1))
                    marks |= (d2 > thresh).any(
                        axis=tuple(range(d2.ndim - 1))
                    )
        times = np.asarray(knots)[1:-1][marks]
        return times if len(times) else None

    def _sticky_quantized_step(
        self, key: str, base_step: float, cap: float
    ) -> float:
        """A quantized step that never grows back across run() calls.

        ``_quantized_step`` only ever halves ``base_step``, so reusing
        the smallest step chosen so far is always stability-safe, and
        it keeps the integration grid fixed across runs.
        """
        step = _quantized_step(base_step, cap)
        prev = self._sticky_steps.get(key)
        if prev is not None and prev < step:
            step = prev
        self._sticky_steps[key] = step
        return step

    def _run_solver(self, **options: Any) -> CoherentResults:
        """Runs the interaction-picture evolution."""
        hamiltonian = self._current_hamiltonian
        if hamiltonian.xy_mat is not None or hamiltonian.int_w is not None:
            raise NotImplementedError(
                "The lab-frame solve (XY mode, SLM-masked interaction"
                " interpolation) is not ported yet (ROADMAP.md Queue 1,"
                " 'lab-frame, XY and int_w sesolve')."
            )
        if self.initial_state.isoper and not self.initial_state.isket:
            raise NotImplementedError(
                "Density-matrix initial states need mesolve, which is"
                " not ported yet (ROADMAP.md Queue 1, 'mesolve')."
            )
        d = hamiltonian.dim
        n = hamiltonian.n_qudits
        knots = hamiltonian.sampling_times
        # Keep steps at or below 1 ns (and below any user max_step, µs).
        # Additionally bound λ_max·h for RK4 stability/accuracy on the
        # drive term (the interaction picture rotates the diagonal away)
        spacings = np.diff(knots)
        lambda_max = float(
            np.sum(
                2 * np.max(np.abs(hamiltonian.amp_coeffs), axis=(1, 2))
            )
        )
        base_step = min(
            float(np.median(spacings)) if len(spacings) else 1e-3,
            1e-3,
        )
        max_step = self._sticky_quantized_step(
            "sesolve", base_step, 0.8 / max(lambda_max, 1e-9)
        )
        if "max_step" in options and options["max_step"]:
            max_step = min(max_step, float(options["max_step"]))
        max_step, coarsen = self._coarse_ip_step(
            "sesolve_coarse", max_step, lambda_max, [hamiltonian], options
        )

        # Repeat runs with unchanged evaluation times reuse the previous
        # plan object — and with it the staged device inputs (see
        # EvolutionPlan.runtime_cache)
        plan_key = (
            self._eval_times_array.tobytes(),
            float(max_step),
            bool(coarsen),
        )
        cached = getattr(self, "_plan_cache", None)
        if cached is not None and cached[0] == plan_key:
            plan = cached[1]
        else:
            with torch.profiler.record_function("emulator.build_plan"):
                plan = build_plan(
                    knots,
                    {
                        "amp": hamiltonian.amp_coeffs,
                        "det": hamiltonian.det_coeffs,
                    },
                    self._eval_times_array,
                    max_step=max_step,
                    coarsen=coarsen,
                    breakpoints=(
                        self._sharp_knots([hamiltonian], knots)
                        if coarsen
                        else None
                    ),
                )
            self._plan_cache = (plan_key, plan)

        with torch.profiler.record_function("emulator.sesolve"):
            states_arr = _solver_mod.sesolve_rk4(
                self._initial_ket(),
                plan,
                hamiltonian.int_diag,
                hamiltonian.pairs,
                d,
                n,
                dtype=_default_cdtype(),
                # The projector occupancies are synthesized from the
                # basis index; any non-None value selects the
                # interaction picture
                ip_occ=True,
                lazy=True,
                device=self._torch_device,
            )
        # Coarse RK4 steps drift the norm by ~1e-6/µs; the evolution is
        # exactly unitary, so the emitted states are renormalized at
        # fetch time (direction/phase accuracy is separately held at
        # ~1e-10 by the ω·h bound).
        states_arr.normalize = bool(coarsen)
        dims_ket = [[d] * n, [1] * n]
        states = [
            Qobj.deferred(
                functools.partial(states_arr.state, i), (d**n, 1), dims_ket
            )
            for i in range(len(states_arr))
        ]
        return self._wrap_coherent(states)

    @staticmethod
    def _make_ip_occ(hamiltonian: Hamiltonian) -> np.ndarray:
        """Detuning-projector occupancy masks: (n_bases, n, dim)."""
        d = hamiltonian.dim
        n = hamiltonian.n_qudits
        dim = d**n
        idx = np.arange(dim)
        ip_occ = np.zeros(
            (len(hamiltonian.pairs), n, dim), dtype=np.float32
        )
        for b, (_, _, k) in enumerate(hamiltonian.pairs):
            for q in range(n):
                digits = (idx // d ** (n - q - 1)) % d
                ip_occ[b, q] = digits == k
        return ip_occ

    def _wrap_coherent(self, states: list[Qobj]) -> CoherentResults:
        """Wraps per-eval-time states into CoherentResults."""
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", category=DeprecationWarning)
            results = [
                TorchResult(
                    tuple(self._hamiltonian_data.register.qubits),
                    self._meas_basis,
                    state,
                    self._meas_basis in self.basis_name,
                    evaluation_time=t / (self._tot_duration * 1e-3),
                )
                for state, t in zip(states, self._eval_times_array)
            ]
        return CoherentResults(
            results,
            self._hamiltonian_data.n_qudits,
            self.basis_name,
            self._eval_times_array,
            self._meas_basis,
        )

    def _validate_options(self, options: Any) -> None:
        if "max_step" not in options:
            # Remember that this cap is the heuristic default, not a
            # user choice: the interaction-picture coarsening may
            # exceed it, but never a user-provided cap.
            options["_max_step_auto"] = True
        options.setdefault(
            "max_step",
            min(
                self._get_min_variation(ch_sample)
                for ch_sample in self.samples_obj.samples_list
            )
            / 1000,
        )

    def run(self, progress_bar: bool = False, **options: Any) -> CoherentResults:
        """Simulates the sequence.

        Args:
            progress_bar: Kept for API parity (the solver has no
                incremental progress to report).
            options: Solver options; `max_step` (µs) caps the
                integration step.

        Returns:
            The states at the evaluation times, as CoherentResults.
        """
        if not (progress_bar is True or progress_bar is False or progress_bar is None):
            raise ValueError("`progress_bar` must be a bool.")
        self._validate_options(options)
        return self._run_solver(**options)


# Drop-in alias matching the reference class name
QutipEmulator = TorchEmulator
