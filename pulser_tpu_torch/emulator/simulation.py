"""The TorchEmulator: simulates sampled sequences with PyTorch solvers.

Port of ``pulser_tpu/emulator/simulation.py`` (itself behavioral parity
with reference ``pulser-simulation/pulser_simulation/simulation.py``,
``QutipEmulator``), on a CUDA device unless the CPU is asked for:

- noiseless: QuTiP's ``sesolve`` becomes
  :func:`~pulser_tpu_torch.ops.solver.sesolve_rk4`, in the interaction
  picture, or in the lab frame with the XY term or the SLM mask's
  interaction interpolation;
- noisy with shot-to-shot noise and no collapse operators (SPAM,
  doppler, amplitude): the whole trajectory batch in one
  interaction-picture solve
  (:func:`~pulser_tpu_torch.ops.solver.sesolve_rk4_batched`), the
  states fetched once and sampled on the host, ending in
  ``NoisyResults``;
- noisy with shot-to-shot noise and collapse operators: one quantum-jump
  realization per noise trajectory, the whole batch in one solve, ending
  in ``NoisyResults`` of bitstring counts. With diagonal collapse
  operators (SPAM, doppler, amplitude, dephasing) on the interaction-
  picture grid, the row-batched solve runs with the measurement draws
  fused after it (:func:`~pulser_tpu_torch.ops.solver.mcsolve_rows_codes`);
  otherwise :func:`~pulser_tpu_torch.ops.solver.mcsolve_rk4_batched`
  returns the states (the lab-frame kernel with general collapse
  operators, or the torch scan: relaxation, other bases, more atoms,
  float64) and the draws run on the host;
- the Lindblad master equation: collapse operators without shot-to-shot
  noise, or ``Solver.MESOLVER``, or a density-matrix initial state run
  :func:`~pulser_tpu_torch.ops.solver.mesolve_rk4` (one solve) or
  :func:`~pulser_tpu_torch.ops.solver.mesolve_rk4_batched` (one
  density matrix per noise trajectory), in the interaction picture on
  the coarsened grid when every collapse operator is diagonal, in the
  lab frame otherwise; the device-memory contract of
  :mod:`pulser_tpu_torch.parallel.capacity` is checked first;
- ``Solver.MCSOLVER`` without shot-to-shot noise runs the serial
  quantum-jump solve :func:`~pulser_tpu_torch.ops.solver.mcsolve_rk4`
  (``n_trajectories`` trajectories averaged into density matrices), and
  so does each trajectory of a noisy run that does not batch
  (depolarizing noise, the XY term), one solve per trajectory.

The evaluation-times semantics (Full/Minimal/array/fraction, union with
{0, T}), the +1 duration extension, the step policy, the noise draws and
the order in which the numpy global RNG is consumed match the JAX
package exactly, so both build the same plan and a seeded run gives the
same counts. Register noise gives each trajectory its own jittered
``Register3D``, and so its own interaction diagonal and waist profile.
"""

from __future__ import annotations

import functools
import os
import warnings
from collections import Counter
from collections.abc import Iterable, Iterator
from enum import Enum
from typing import Any, NamedTuple, Optional, Union, cast

import numpy as np
import torch
from numpy.typing import ArrayLike

from pulser_tpu_torch.channels.base_channel import States
from pulser_tpu_torch.devices._device_datacls import BaseDevice
from pulser_tpu_torch.emulator.hamiltonian import Hamiltonian
from pulser_tpu_torch.emulator.qobj import Qobj, tensor
from pulser_tpu_torch.emulator.sim_result import TorchResult
from pulser_tpu_torch.emulator.simconfig import SimConfig
from pulser_tpu_torch.emulator.simresults import (
    CoherentResults,
    NoisyResults,
    SimulationResults,
)
from pulser_tpu_torch.hamiltonian_data import (
    HamiltonianData,
    has_shot_to_shot_except_spam,
)
from pulser_tpu_torch import profiling
from pulser_tpu_torch.noise_model import NoiseModel
from pulser_tpu_torch.ops import solver as _solver_mod
from pulser_tpu_torch.ops.solver import build_plan
from pulser_tpu_torch.parallel import (
    comm,
    mesh2d,
    state_sharding,
    trajectories,
)
from pulser_tpu_torch.parallel.capacity import check_capacity
from pulser_tpu_torch.register.base_register import BaseRegister
from pulser_tpu_torch.result import SampledResult, _labels_of
from pulser_tpu_torch.sequence import Sequence
from pulser_tpu_torch.sampler.samples import (
    ChannelSamples,
    DMMSamples,
    SequenceSamples,
)


class HamiltonianWithReps(NamedTuple):
    """A Hamiltonian and the number of times it should be simulated."""

    hamiltonian: Hamiltonian
    reps: int


class _CoeffBatch:
    """Per-trajectory solver inputs for one batched noisy run.

    Built either the generic way (one :class:`Hamiltonian` object per
    trajectory) or — when every sample modification the active noise
    types make is a per-(trajectory, channel, qubit) scalar — by
    broadcasting over the noiseless coefficients
    (:meth:`TorchEmulator._fast_coeff_batch`).

    The fast path carries the coefficients as rank factorizations
    (``amp_factors`` / ``det_factors``: profiles ``(R, nb, N, K)``,
    coeffs ``(B, R, nb, N)`` with ``batch[b] = Σ_r coeffs[b, r] ·
    profiles[r]``) and never materializes the dense ``(B, nb, N, K)``
    batch on the hot path. The dense ``amp`` / ``det`` views
    materialize lazily (via ``dense_fn``, which replays the generic
    path's operation order) for the pure-state batched path and the
    parity tests.
    """

    def __init__(
        self,
        diags: np.ndarray,
        reps: list,
        template: Hamiltonian,
        last_ham: Any,
        shims: "list | None" = None,
        amp: "np.ndarray | None" = None,
        det: "np.ndarray | None" = None,
        det_factors: Any = None,
        amp_factors: Any = None,
        dense_fn: Any = None,
        flip_gaps: "np.ndarray | None" = None,
    ) -> None:
        self.diags = diags  # (T, dim) interaction diagonals
        self.reps = reps  # repetition count per trajectory
        self.template = template  # pairs / dims / knots / collapse
        self.last_ham = last_ham  # () -> Hamiltonian
        self._shims = shims  # per-trajectory step-policy views
        self._amp = amp  # (T, nb, N, K) complex, or lazy
        self._det = det  # (T, nb, N, K) real, or lazy
        self.det_factors = det_factors
        self.amp_factors = amp_factors
        self._dense_fn = dense_fn
        self._flip_gaps = flip_gaps
        assert (amp is not None and det is not None) or (
            dense_fn is not None
        ), "need dense arrays or a materializer"

    def _materialize(self) -> None:
        if self._amp is None or self._det is None:
            self._amp, self._det = self._dense_fn()

    @property
    def amp(self) -> np.ndarray:
        """Dense complex drive batch (lazy on the factored path)."""
        self._materialize()
        return self._amp

    @property
    def det(self) -> np.ndarray:
        """Dense real detuning batch (lazy on the factored path)."""
        self._materialize()
        return self._det

    @property
    def shims(self) -> list:
        """Per-trajectory step-policy views (lazy, like the dense batch
        they slice)."""
        if self._shims is None:
            knots = np.asarray(self.template.sampling_times)
            self._shims = [
                _CoeffShim(
                    self.amp[t],
                    self.det[t],
                    knots,
                    float(self._flip_gaps[t]),
                )
                for t in range(len(self.reps))
            ]
        return self._shims


class _CoeffShim(NamedTuple):
    """Duck-typed stand-in for a per-trajectory Hamiltonian, carrying
    exactly the fields the step-policy helpers read."""

    amp_coeffs: np.ndarray
    det_coeffs: np.ndarray
    sampling_times: np.ndarray
    max_flip_gap: float


class _LindbladPrep(NamedTuple):
    """Host-prep outputs of :meth:`TorchEmulator._lindblad_batch_prep`."""

    batch: _CoeffBatch
    plans: Any  # solver.BatchedPlan
    d: int
    n: int
    pairs: tuple
    collapse_mats: list
    psi0: np.ndarray  # complex, solver dtype
    mcwf_ip: bool
    mesolve_ip: bool


class _StepChoice(NamedTuple):
    """The integration grid :meth:`TorchEmulator._step_policy` chose."""

    max_step: float
    coarsen: bool  # the interaction picture's coarsened grid
    mcwf_ip: bool  # the quantum jumps in the interaction picture
    mesolve_ip: bool  # the master equation in the interaction picture
    knots: np.ndarray
    marks: Any  # what the breakpoints are marked from

    def breakpoints(self) -> "np.ndarray | None":
        """The knots that anchor the coarsened grid (None on the fine
        grid), marked when the plan is built."""
        if not self.coarsen:
            return None
        if isinstance(self.marks, (list, _CoeffBatch)):
            return TorchEmulator._sharp_knots(self.marks, self.knots)
        return self.marks


def _lab_only(ham: Any) -> bool:
    """Whether the XY term or ``int_w`` keeps ``ham`` in the lab frame."""
    return ham.xy_mat is not None or ham.int_w is not None


def _has_stochastic_noise(noise_model: NoiseModel) -> bool:
    return has_shot_to_shot_except_spam(noise_model) or (
        "SPAM" in noise_model.noise_types
        and noise_model.state_prep_error != 0
    )


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


class Solver(str, Enum):
    """Solver selection.

    If the noise model has no effective noise, the Schrödinger solver is
    used (this setting is ignored). With effective noise:
        - ``DEFAULT``: quantum-jump Monte-Carlo under stochastic noise,
          master equation otherwise (the reference's auto-selection),
        - ``MESOLVER``: master-equation solver,
        - ``MCSOLVER``: quantum-jump Monte-Carlo (MCWF) solver.
    """

    DEFAULT = "default"
    MESOLVER = "MasterEquation"
    MCSOLVER = "MonteCarlo"


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
        noise_model: The noise model for the simulation.
        solver: Solver selection (see :class:`Solver`).
        n_trajectories: The number of noise trajectories to average over
            when the emulation includes stochastic noise.
        torch_device: The torch device the solver runs on (default: the
            first CUDA device; without one the constructor raises, and
            ``"cpu"`` must be asked for).
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
        solver: Solver = Solver.DEFAULT,
        n_trajectories: int | None = None,
        torch_device: Union[str, torch.device, None] = None,
    ) -> None:
        """Instantiates a TorchEmulator object."""
        with profiling.phase("emulator.init"):
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
            self.solver = Solver(solver)
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
            self._n_trajectories = n_trajectories

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

            self._noise_trajectories_used = False
            with profiling.phase("emulator.hamiltonian_data"):
                self._hamiltonian_data = HamiltonianData(
                    self.samples_obj,
                    register,
                    device,
                    noise_model,
                    self._get_n_trajectories(noise_model, check_value=True),
                )
                self._current_hamiltonian = next(
                    self._hamiltonians
                ).hamiltonian
            self._eval_times_array: np.ndarray
            self.set_evaluation_times(evaluation_times)

            if self.samples_obj._measurement:
                self._meas_basis = self.samples_obj._measurement
            elif "all" in self.basis_name:
                self._meas_basis = "digital"
            else:
                self._meas_basis = self.basis_name.replace("_with_error", "")
            self.set_initial_state("all-ground")

    def _get_n_trajectories(
        self, noise_model: NoiseModel, check_value: bool
    ) -> int | None:
        n_trajectories = (
            self._n_trajectories
            if self._n_trajectories is not None
            else noise_model.runs
        )
        if (
            check_value
            and _has_stochastic_noise(noise_model)
            and n_trajectories is None
        ):
            raise ValueError(
                "'n_trajectories' must be defined when the NoiseModel"
                " contains stochastic noise, which is the case for the"
                f" given noise model: {noise_model!r}"
            )
        return n_trajectories

    @property
    def n_trajectories(self) -> int | None:
        """The number of trajectories to average over."""
        return self._get_n_trajectories(self.noise_model, check_value=False)

    @property
    def _hamiltonians(self) -> Iterator[HamiltonianWithReps]:
        for traj, noisy_samples, reps in (
            self._hamiltonian_data.noisy_samples
        ):
            yield HamiltonianWithReps(
                Hamiltonian(
                    noisy_samples,
                    traj,
                    self._hamiltonian_data.basis_data,
                    self._hamiltonian_data.lindblad_data,
                    self._sampling_rate,
                ),
                reps,
            )

    @property
    def _noiseless_hamiltonian(self) -> Hamiltonian:
        return self._get_noiseless_hamiltonian(False)

    def _get_noiseless_hamiltonian(self, leakage: bool) -> Hamiltonian:
        """The noiseless Hamiltonian, built once per basis (its
        HamiltonianData draws from the numpy global RNG where the JAX
        package's does).

        Args:
            leakage: Whether to include the leakage state in the basis.
        """
        cache = self.__dict__.setdefault("_noiseless_ham_cache", {})
        if leakage not in cache:
            if leakage:
                noise = NoiseModel(
                    eff_noise_opers=(np.zeros((3, 3)),),
                    eff_noise_rates=(0.0,),
                    with_leakage=leakage,
                )
            else:
                noise = NoiseModel()
            noiseless_data = HamiltonianData(
                self.samples_obj,
                self._register,
                self.device,
                noise,
                n_trajectories=1,
            )
            cache[leakage] = Hamiltonian(
                noiseless_data.samples,
                noiseless_data.noise_trajectories[0].trajectory,
                noiseless_data.basis_data,
                noiseless_data.lindblad_data,
                self._sampling_rate,
            )
        return cache[leakage]

    def _one_trajectory_hamiltonian(self, traj: Any) -> Hamiltonian:
        """The full (generic-path) Hamiltonian of ONE trajectory."""
        hd = self._hamiltonian_data
        return Hamiltonian(
            hd._sample_with_trajectory(traj),
            traj,
            hd.basis_data,
            hd.lindblad_data,
            self._sampling_rate,
        )

    def _noisy_coeff_batch(self) -> _CoeffBatch:
        """Per-trajectory coefficient batch for the batched runner.

        Prefers the vectorized fast path; falls back to building one
        Hamiltonian object per trajectory when the noise configuration
        modifies samples in a way the broadcast cannot express.
        """
        trajs = list(self._hamiltonian_data.noise_trajectories)
        fast = self._fast_coeff_batch(trajs)
        if fast is not None:
            return fast
        hams = list(self._hamiltonians)
        return _CoeffBatch(
            amp=np.stack([h.hamiltonian.amp_coeffs for h in hams]),
            det=np.stack([h.hamiltonian.det_coeffs for h in hams]),
            diags=np.stack([h.hamiltonian.int_diag for h in hams]),
            reps=[h.reps for h in hams],
            template=hams[0].hamiltonian,
            shims=[h.hamiltonian for h in hams],
            last_ham=lambda: hams[-1].hamiltonian,
        )

    def _fast_coeff_batch(self, trajs: list) -> "_CoeffBatch | None":
        """Vectorized per-trajectory coefficients, or None.

        When every sample modification the active noise types make is a
        per-(trajectory, channel, qubit) scalar scale (amplitude sigma,
        finite beam waist, badly-prepared atoms) or a slot-masked
        constant detuning offset (doppler), the whole batch is a
        broadcast over the noiseless coefficient arrays instead of one
        Hamiltonian per trajectory. Ineligible (returns None):
        time-dependent detuning noise, DMM noise, XY mode, interaction
        interpolation, several channels driving one basis. The noisy
        modifications replay the generic path's operation order, so the
        two agree to the last bit.
        """
        nm = self.noise_model
        ntypes = set(nm.noise_types)
        if "detuning" in ntypes:
            return None
        hd = self._hamiltonian_data
        samples = hd.samples
        if any(
            isinstance(cs, DMMSamples)
            for cs in samples.channel_samples.values()
        ):
            return None
        ch_objs = samples._ch_objs
        basis_ch: dict[str, str] = {}
        for ch, obj in ch_objs.items():
            if obj.basis in basis_ch:
                return None  # several channels per basis: fall back
            basis_ch[obj.basis] = ch
        if not trajs:
            return None
        # Template: noiseless samples, the real basis/lindblad data
        # (collapse operators are trajectory-independent), any
        # trajectory for the constructor's interaction inputs (its
        # int_diag is recomputed per trajectory below).
        template = Hamiltonian(
            samples,
            trajs[0].trajectory,
            hd.basis_data,
            hd.lindblad_data,
            self._sampling_rate,
        )
        if template.xy_mat is not None or template.int_w is not None:
            return None

        n = template.n_qudits
        dim = template.dim**n
        nb = len(template.bases)
        n_traj = len(trajs)
        qid_order = list(template._qid_index)

        # Raw per-(basis, qubit) sample rows in knot space; they are
        # trajectory-independent, so repeat run() calls reuse them.
        use_doppler = "doppler" in ntypes
        raw_key = (
            id(self.samples_obj),
            self._sampling_rate,
            template._duration,
            tuple(template.bases),
            use_doppler,
        )
        cached_raw = getattr(self, "_fast_raw_rows", None)
        if cached_raw is not None and cached_raw[0] == raw_key:
            _, amp_raw, ph_exp, det_raw, mask_k = cached_raw
        else:
            nested = samples.to_nested_dict(all_local=True)
            amp_raw = np.zeros((nb, n, template._duration))
            ph_raw = np.zeros((nb, n, template._duration))
            det_raw = np.zeros((nb, n, template._duration))
            for bi, basis in enumerate(template.bases):
                for qid, qs in nested["Local"].get(basis, {}).items():
                    qi = template._qid_index[qid]
                    amp_raw[bi, qi] = qs["amp"]
                    ph_raw[bi, qi] = qs["phase"]
                    det_raw[bi, qi] = qs["det"]
            amp_raw = template._adapt_last_axis(amp_raw)
            ph_raw = template._adapt_last_axis(ph_raw)
            det_raw = template._adapt_last_axis(det_raw)
            ph_exp = np.exp(-1j * ph_raw[None])

            # Slot-support masks per (basis, qubit) in knot space:
            # doppler offsets apply only where the channel addresses
            # the qubit (matches _apply_slot_noise's time window).
            mask_k = None
            if use_doppler:
                mask_t = np.zeros((nb, n, template._duration))
                for bi, basis in enumerate(template.bases):
                    ch = basis_ch.get(basis)
                    if ch is None:
                        continue
                    cs = samples.channel_samples[ch]
                    for slot in cs.slots:
                        for qid in slot.targets:
                            qi = template._qid_index[qid]
                            mask_t[bi, qi, slot.ti : slot.tf] = 1.0
                mask_k = template._adapt_last_axis(mask_t)
            self._fast_raw_rows = (raw_key, amp_raw, ph_exp, det_raw, mask_k)

        use_amp = "amplitude" in ntypes
        waist = nm.laser_waist
        amp_scale = np.ones((n_traj, nb, n))
        good = np.ones((n_traj, n))
        dopp = np.zeros((n_traj, n))
        diags = np.empty((n_traj, dim))
        mfgs = np.zeros(n_traj)
        no_int = "digital" in template.basis_data.basis_name or n == 1
        # Absent register noise, every trajectory carries the same
        # register object: the per-channel waist profile is computed
        # once per batch.
        waist_memo: dict = {}

        def waist_frac(reg: Any, ch: str) -> np.ndarray:
            key = (id(reg), ch)
            hit = waist_memo.get(key)
            if hit is None:
                hit = waist_memo[key] = self._waist_fractions(
                    reg, ch_objs[ch].propagation_dir, waist
                )
            return hit

        for t, (traj, _) in enumerate(trajs):
            if any(traj.bad_atoms.values()):
                good[t] = [
                    0.0 if traj.bad_atoms[q] else 1.0 for q in qid_order
                ]
            if use_doppler:
                dopp[t] = [traj.doppler_detune[q] for q in qid_order]
            if use_amp:
                for bi, basis in enumerate(template.bases):
                    ch = basis_ch.get(basis)
                    if ch is None:
                        continue
                    frac = traj.amp_fluctuations.get(ch, 1.0)
                    amp_scale[t, bi, :] = frac
                    if (
                        waist is not None
                        and ch_objs[ch].addressing == "Global"
                    ):
                        amp_scale[t, bi, :] *= waist_frac(traj.register, ch)
            imat = traj.interaction_matrix.as_array(detach=True)
            eff = n - sum(traj.bad_atoms.values())
            if not no_int and eff > 1:
                diags[t] = template._interaction_diag(imat[-1], "r", set())
                mfgs[t] = float(np.max(np.sum(np.abs(imat[-1]), axis=1)))
            else:
                diags[t] = 0.0

        # Rank factorizations — the dense (B, nb, n, K) batches never
        # materialize on the hot path:
        #   amp_b[t]  = (amp_scale[t]·good[t]) · (0.5·amp_raw·e^{-iφ})
        #   det_b[t]  = good[t]·base + (dopp[t]·good[t])·mask
        # (base = det_raw with the 0.5-then-H+H†-doubling applied).
        amp_profile = (0.5 * amp_raw) * ph_exp[0]
        amp_coeffs = amp_scale * good[:, None, :]
        amp_factors = (amp_profile[None], amp_coeffs[:, None])
        profiles = [(0.5 * det_raw) * 2.0]
        coeff_rows = [np.broadcast_to(good[:, None, :], (n_traj, nb, n))]
        if use_doppler:
            profiles.append((0.5 * mask_k) * 2.0)
            coeff_rows.append(
                np.broadcast_to((dopp * good)[:, None, :], (n_traj, nb, n))
            )
        det_factors = (np.stack(profiles), np.stack(coeff_rows, axis=1))

        def dense_fn() -> tuple[np.ndarray, np.ndarray]:
            # The generic path's operation order: amp scales in the
            # "time" domain, then 0.5·amp·e^{-iφ}; det adds the masked
            # doppler offset, bad atoms zero, then 0.5·det and the
            # H+H† doubling.
            amp_t = amp_raw[None] * amp_scale[..., None]
            amp_t = amp_t * good[:, None, :, None]
            amp_b = (0.5 * amp_t) * ph_exp
            det_t = det_raw[None] + (
                dopp[:, None, :, None] * mask_k[None] if use_doppler else 0.0
            )
            det_t = det_t * good[:, None, :, None]
            det_b = (0.5 * det_t) * 2.0
            return amp_b, det_b

        last_traj = trajs[-1].trajectory
        return _CoeffBatch(
            diags=diags,
            reps=[r for _, r in trajs],
            template=template,
            last_ham=functools.partial(
                self._one_trajectory_hamiltonian, last_traj
            ),
            det_factors=det_factors,
            amp_factors=amp_factors,
            dense_fn=dense_fn,
            flip_gaps=mfgs,
        )

    @staticmethod
    def _waist_fractions(
        register: BaseRegister,
        propagation_dir: "tuple | None",
        laser_waist: float,
    ) -> np.ndarray:
        """exp(−(r/w)²) per qubit, r ⊥ to the beam axis (defaults to
        y) — the vectorized twin of
        ``HamiltonianData._finite_waist_amp_fraction``."""
        coords = np.stack(
            [np.asarray(pos.as_array()) for pos in register.qubits.values()]
        )
        p = np.zeros((coords.shape[0], 3))
        p[:, : coords.shape[1]] = coords
        axis = np.asarray(propagation_dir or (0.0, 1.0, 0.0), dtype=float)
        along = p @ axis / np.linalg.norm(axis)
        r_sq = np.maximum(np.einsum("ij,ij->i", p, p) - along**2, 0.0)
        return np.exp(-r_sq / laser_waist**2)

    @property
    def device(self) -> BaseDevice:
        """The device being simulated."""
        return self._hamiltonian_data.device

    @property
    def sampling_times(self) -> np.ndarray:
        """The times at which the hamiltonian is sampled."""
        # As in the JAX package, with its RNG draw: the noiseless
        # Hamiltonian's data draws its one trajectory from numpy's global
        # generator, so a seeded noiseless run samples the same counts
        return self._noiseless_hamiltonian.sampling_times

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
    def config(self) -> SimConfig:
        """The current configuration, as a SimConfig instance."""
        return SimConfig.from_noise_model(
            self._hamiltonian_data.noise_model
        )

    def set_config(self, cfg: SimConfig) -> None:
        """Sets the config (deprecated; prefer a new emulator)."""
        warnings.warn(
            "Supplying a 'SimConfig' to the emulator has been"
            " deprecated. Please instantiate with a 'NoiseModel'"
            " instead.",
            DeprecationWarning,
            stacklevel=2,
        )
        if not isinstance(cfg, SimConfig):
            raise ValueError(
                f"Object {cfg} is not a valid `SimConfig`."
            )
        not_supported = (
            set(cfg.noise)
            - cfg.supported_noises[
                self._hamiltonian_data.basis_data.interaction_type
            ]
        )
        if not_supported:
            v = self._hamiltonian_data.basis_data.interaction_type
            raise NotImplementedError(
                f"Interaction mode '{v}' "
                "does not support simulation of noise types:"
                f"{', '.join(not_supported)}."
            )
        former_dim = self.dim
        former_basis = self.basis
        noise_model = cfg.to_noise_model()
        self._noise_trajectories_used = False
        self._hamiltonian_data = HamiltonianData(
            self.samples_obj,
            self._register,
            self.device,
            noise_model,
            self._get_n_trajectories(noise_model, check_value=True),
        )
        self._current_hamiltonian = next(self._hamiltonians).hamiltonian
        if self.dim == former_dim:
            self.set_initial_state(self._initial_state)
            return
        v = self._hamiltonian_data.basis_data.interaction_type
        if self._initial_state != tensor(
            [
                former_basis[("u" if v == "XY" else "g")]
                for _ in range(self._hamiltonian_data.n_qudits)
            ]
        ):
            warnings.warn(
                "Current initial state's dimension does not match new"
                " dimensions. Setting it to 'all-ground'."
            )
        self.set_initial_state("all-ground")

    def add_config(self, config: SimConfig) -> None:
        """Updates the current config with another one (deprecated)."""
        from dataclasses import asdict

        warnings.warn(
            "Supplying a 'SimConfig' to the emulator has been"
            " deprecated. Please instantiate with a 'NoiseModel'"
            " instead.",
            DeprecationWarning,
            stacklevel=2,
        )
        if not isinstance(config, SimConfig):
            raise ValueError(
                f"Object {config} is not a valid `SimConfig`"
            )

        not_supported = (
            set(config.noise)
            - config.supported_noises[
                self._hamiltonian_data.basis_data.interaction_type
            ]
        )
        if not_supported:
            v = self._hamiltonian_data.basis_data.interaction_type
            raise NotImplementedError(
                f"Interaction mode '{v}' "
                "does not support simulation of noise types: "
                f"{', '.join(not_supported)}."
            )
        noise_model = config.to_noise_model()
        old_noise_set = set(
            self._hamiltonian_data.noise_model.noise_types
        )
        new_noise_set = old_noise_set.union(noise_model.noise_types)
        diff_noise_set = new_noise_set - old_noise_set
        param_dict: dict[str, Any] = asdict(
            self._hamiltonian_data.noise_model
        )
        relevant_params = NoiseModel._find_relevant_params(
            diff_noise_set,
            noise_model.state_prep_error,
            noise_model.amp_sigma,
            noise_model.laser_waist,
        )
        for param in relevant_params:
            param_dict[param] = getattr(noise_model, param)
        param_dict.pop("noise_types")
        self.set_config(
            SimConfig.from_noise_model(NoiseModel(**param_dict))
        )

    def show_config(self, solver_options: bool = False) -> None:
        """Shows current configuration."""
        print(self.config.__str__(solver_options))

    def reset_config(self) -> None:
        """Resets configuration to default."""
        self.set_config(SimConfig())

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

    def build_operator(self, operations: Union[list, tuple]) -> Qobj:
        """Creates an operator with non-trivial actions on some qubits.

        See :meth:`Hamiltonian.build_operator`.
        """
        return self._current_hamiltonian.build_operator(operations)

    def get_hamiltonian(
        self, time: float, noiseless: bool = False
    ) -> Qobj:
        r"""The Hamiltonian created from the sequence at a fixed time.

        Note:
            The whole Hamiltonian is divided by :math:`\hbar`, so its
            units are rad/µs.

        Args:
            time: The time at which to extract the Hamiltonian (in ns).
            noiseless: If True, returns the Hamiltonian without noise.

        Returns:
            A dense operator with coefficients extracted from the
            effective sequence at the specified time.
        """
        if time > self._tot_duration:
            raise ValueError(
                f"Provided time (`time` = {time}) must be "
                "less than or equal to the sequence duration "
                f"({self._tot_duration})."
            )
        if time < 0:
            raise ValueError(
                f"Provided time (`time` = {time}) must be "
                "greater than or equal to 0."
            )

        if noiseless:
            return self._noiseless_hamiltonian._hamiltonian(time / 1000)

        return self._current_hamiltonian._hamiltonian(time / 1000)

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
    def _factored_policy(
        batch: "_CoeffBatch", knots: np.ndarray
    ) -> "tuple[np.ndarray, np.ndarray, np.ndarray | None]":
        """Step-policy inputs straight from the rank factors.

        Computes, without materializing the dense ``(B, nb, n, K)``
        batch, exactly the values of the dense formulas:

        - per-trajectory amp stiffness ``Σ_bi 2·max_{q,k} |amp|``,
        - per-trajectory det stiffness ``Σ_bi max_{q,k} |det|``,
        - the :meth:`_sharp_knots` jump marks (union over trajectories
          with per-trajectory thresholds).

        The amp batch is rank-1 with a real per-trajectory coefficient,
        so ``|amp_t| = |c_t|·|profile|`` and ``d²`` of either real
        component is ``c_t·d²(component)``; the rank-R detuning rows are
        recombined per ``(basis, qubit)`` profile row.

        Returns ``(amp_stiff (B,), det_stiff (B,), sharp_times)``.
        """
        ap, ac = (np.asarray(x) for x in batch.amp_factors)
        dp, dc = (np.asarray(x) for x in batch.det_factors)
        assert ap.shape[0] == 1 and ac.shape[1] == 1
        B, _, nb, n = ac.shape
        K = ap.shape[-1]
        a_abs = np.abs(ac[:, 0])  # (B, nb, n)

        # Signed components: |d²(c·comp)| = |c|·|d² comp| needs the
        # second difference of the signed profile
        amp_components = [ap[0].real, ap[0].imag]
        prof_abs = np.abs(ap[0])  # (nb, n, K) |complex|
        amp_stiff = 2.0 * np.sum(
            (a_abs * prof_abs.max(axis=-1)[None]).max(axis=2), axis=1
        )

        det_rowmax = np.empty((B, nb, n))
        det_d2: list = []
        want_marks = len(knots) >= 3 and K == len(knots)
        for bi in range(nb):
            for q in range(n):
                rows = dc[:, :, bi, q] @ dp[:, bi, q, :]  # (B, K)
                det_rowmax[:, bi, q] = np.abs(rows).max(axis=1)
                if want_marks:
                    det_d2.append(np.abs(np.diff(rows, n=2, axis=1)))
        det_stiff = np.sum(det_rowmax.max(axis=2), axis=1)

        if not want_marks:
            return amp_stiff, det_stiff, None
        marks = np.zeros(K - 2, dtype=bool)
        # amp marks, real and imaginary components separately
        for comp in amp_components:
            thresh = 0.05 * (
                (a_abs * np.abs(comp).max(axis=-1)[None]).max(axis=(1, 2))
            )  # (B,)
            d2p = np.abs(np.diff(comp, n=2, axis=-1))  # (nb, n, K-2)
            # max_t (|c_t| / thresh_t) per (bi, q); trajectories with
            # zero threshold have an all-zero component => no marks
            ok = thresh > 0
            if not ok.any():
                continue
            m_bq = (a_abs[ok] / thresh[ok, None, None]).max(axis=0)
            marks |= (d2p * m_bq[..., None] > 1.0).any(axis=(0, 1))
        # det marks: per-trajectory threshold over the whole det array
        thresh_d = 0.05 * det_rowmax.max(axis=(1, 2))  # (B,)
        for d2 in det_d2:
            marks |= (d2 > thresh_d[:, None]).any(axis=0)
        times = np.asarray(knots)[1:-1][marks]
        return amp_stiff, det_stiff, (times if len(times) else None)

    @staticmethod
    def _sharp_knots(
        hamiltonians: "list[Hamiltonian] | _CoeffBatch",
        knots: np.ndarray,
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

        def mark(comp: np.ndarray, per_traj: bool) -> None:
            """comp: (..., K) real; per_traj scales on axis 0."""
            nonlocal marks
            if per_traj:
                scale = np.max(
                    np.abs(comp), axis=tuple(range(1, comp.ndim))
                )
                thresh = 0.05 * scale.reshape((-1,) + (1,) * (comp.ndim - 1))
            else:
                thresh = 0.05 * float(np.max(np.abs(comp)))
                if thresh == 0.0:
                    return
            d2 = np.abs(np.diff(comp, n=2, axis=-1))
            marks |= (d2 > thresh).any(axis=tuple(range(d2.ndim - 1)))

        if isinstance(hamiltonians, _CoeffBatch):
            # Stacked form: one vectorized pass over the whole batch (a
            # zero-scale trajectory row is all zeros, so its d2 > 0
            # comparison is vacuously false)
            for arr in (hamiltonians.amp, hamiltonians.det):
                arr = np.asarray(arr)
                if arr.shape[-1] != len(knots):
                    continue
                mark(arr.real, per_traj=True)
                mark(arr.imag, per_traj=True)
        else:
            for ham in hamiltonians:
                for arr in (ham.amp_coeffs, ham.det_coeffs):
                    arr = np.asarray(arr)
                    if arr.shape[-1] != len(knots):
                        continue
                    mark(arr.real, per_traj=False)
                    mark(arr.imag, per_traj=False)
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

    def _dissipation(self, ham: Hamiltonian) -> "str | None":
        """The dissipative solve ``ham`` takes: ``"mcwf"`` (quantum
        jumps), ``"mesolve"`` (the master equation, also for a density
        matrix) or None (the Schrödinger solve of a ket)."""
        is_dm = not self.initial_state.isket
        if not is_dm and not ham.lindblad_data.local_collapse_ops:
            return None
        if not is_dm and self._lindblad_solver_choice():
            return "mcwf"
        return "mesolve"

    def _step_policy(
        self,
        ham: Hamiltonian,
        lambda_max: float,
        key: str,
        margin: float,
        marks: "list[Hamiltonian] | _CoeffBatch | np.ndarray | None",
        options: dict,
    ) -> "_StepChoice":
        """The integration step of one solve or of one trajectory batch,
        in the JAX package's order: the median knot spacing, at most
        1 ns, halved until ``0.8 / (margin·λ_max)`` bounds it, never
        grown back across runs (sticky under ``key``), and capped by the
        ``max_step`` option; then, in the interaction picture, coarsened
        by :meth:`_coarse_ip_step`. The quantum jumps (every collapse
        operator diagonal or a single matrix unit) and the master
        equation (every one diagonal: ρ's rotor conjugation then
        commutes with the dissipator) coarsen from the NOISELESS
        Hamiltonian with the batch margin, as the JAX package's do (that
        Hamiltonian draws from the numpy global RNG when first built).

        Args:
            ham: The run's Hamiltonian, or a batch's template: its
                structure picks the frame and the dissipative solve.
            lambda_max: The stiffness, read from what the caller holds.
            key: The sticky step's key.
            margin: 1.0 for one Hamiltonian, 1.3 for a batch (the noise
                draws stay inside one power-of-two step).
            marks: What the coarsening and the breakpoints read: the
                Hamiltonian in a list, the batch (its shims feed the
                coarsening), or :meth:`_factored_policy`'s breakpoints.
            options: The run's options.
        """
        knots = ham.sampling_times
        spacings = np.diff(knots)
        base_step = min(
            float(np.median(spacings)) if len(spacings) else 1e-3, 1e-3
        )
        max_step = self._sticky_quantized_step(
            key, base_step, 0.8 / max(margin * lambda_max, 1e-9)
        )
        if options.get("max_step"):
            max_step = min(max_step, float(options["max_step"]))
        coarsen, ip_kind = False, None
        dissipation = self._dissipation(ham)
        lab = _lab_only(ham)
        if not lab and dissipation is None:
            max_step, coarsen = self._coarse_ip_step(
                key + "_coarse",
                max_step,
                lambda_max,
                marks.shims if isinstance(marks, _CoeffBatch) else marks,
                options,
            )
        elif not lab and (
            _solver_mod.mcwf_ip_eligible
            if dissipation == "mcwf"
            else _solver_mod.mesolve_ip_eligible
        )(ham._local_collapse_mats):
            ham0 = self._noiseless_hamiltonian
            lam_drive = float(
                np.sum(2 * np.max(np.abs(ham0.amp_coeffs), axis=(1, 2)))
            )
            max_step, coarsen = self._coarse_ip_step(
                dissipation + "_coarse", max_step, lam_drive, [ham0],
                options, margin=1.3,
            )
            ip_kind = dissipation if coarsen else None
        return _StepChoice(
            max_step, coarsen, ip_kind == "mcwf", ip_kind == "mesolve", knots,
            marks,
        )

    def _run_solver(
        self,
        hamiltonian: "Hamiltonian | None" = None,
        mcsolve_ntraj: int = 1,
        **options: Any,
    ) -> CoherentResults:
        """Runs one evolution of ``hamiltonian`` (default: the current
        one): the sesolve of a ket (interaction picture, or the lab frame
        with the XY term or ``int_w``), the serial quantum-jump solve of
        ``mcsolve_ntraj`` trajectories, or the master equation with
        collapse operators or a density-matrix input."""
        if hamiltonian is None:
            hamiltonian = self._current_hamiltonian
        d = hamiltonian.dim
        n = hamiltonian.n_qudits
        knots = hamiltonian.sampling_times
        dissipation = self._dissipation(hamiltonian)
        can_use_ip = dissipation is None and not _lab_only(hamiltonian)
        # Without the interaction picture the full diagonal and the XY
        # couplings add to the drive's stiffness
        with profiling.phase("emulator.step_policy"):
            lambda_max = float(
                np.sum(
                    2 * np.max(np.abs(hamiltonian.amp_coeffs), axis=(1, 2))
                )
            )
            if not can_use_ip:
                lambda_max += float(
                    np.max(np.abs(hamiltonian.int_diag))
                ) + float(
                    np.sum(np.max(np.abs(hamiltonian.det_coeffs), axis=(1, 2)))
                )
                if hamiltonian.xy_mat is not None:
                    lambda_max += float(
                        np.max(np.sum(np.abs(hamiltonian.xy_mat[0]), axis=1))
                    )
            step = self._step_policy(
                hamiltonian,
                lambda_max,
                "sesolve" if can_use_ip else "sesolve_lab",
                1.0,
                [hamiltonian],
                options,
            )
        coeffs = {"amp": hamiltonian.amp_coeffs, "det": hamiltonian.det_coeffs}
        if hamiltonian.int_w is not None:
            coeffs["int_w"] = hamiltonian.int_w
        # Repeat runs with an unchanged Hamiltonian and evaluation times
        # reuse the previous plan object — and with it the staged device
        # inputs (see EvolutionPlan.runtime_cache)
        plan_key = (
            self._eval_times_array.tobytes(),
            float(step.max_step),
            bool(step.coarsen),
        )
        cached = getattr(self, "_plan_cache", None)
        if (
            cached is not None
            and cached[0] == plan_key
            and cached[2] is hamiltonian
        ):
            plan = cached[1]
        else:
            with profiling.phase("emulator.build_plan"):
                plan = build_plan(
                    knots,
                    coeffs,
                    self._eval_times_array,
                    max_step=step.max_step,
                    coarsen=step.coarsen,
                    breakpoints=step.breakpoints(),
                )
            self._plan_cache = (plan_key, plan, hamiltonian)

        cdtype = _default_cdtype()
        n_eval = len(self._eval_times_array)
        itemsize = torch.finfo(cdtype).bits // 8
        xy = dict(xy_static=hamiltonian.xy_mat, xy_indices=hamiltonian.xy_indices)
        mats = hamiltonian._local_collapse_mats
        if dissipation == "mcwf":
            # The trajectories are averaged into (n_eval, dim, dim)
            # density matrices on the device, so the footprint contract is
            # the density-matrix model
            check_capacity(
                d, n, n_eval=n_eval, itemsize=itemsize, density_matrix=True,
                what="quantum-jump solve", device=self._torch_device,
            )
            with profiling.phase("emulator.mcsolve"):
                states_arr = _solver_mod.mcsolve_rk4(
                    self._initial_ket(),
                    plan,
                    hamiltonian.int_diag,
                    hamiltonian.pairs,
                    d,
                    n,
                    mats,
                    ntraj=mcsolve_ntraj,
                    seed=int(np.random.randint(2**31)),
                    dtype=cdtype,
                    mesh=trajectories.default_mesh(),
                    ip=step.mcwf_ip,
                    device=self._torch_device,
                    **xy,
                )
            with profiling.phase("emulator.wrap_results"):
                states = [Qobj(s, dims=[[d] * n, [d] * n]) for s in states_arr]
                return self._wrap_coherent(states)
        if dissipation == "mesolve":
            if not self.initial_state.isket:
                rho0: Any = np.asarray(
                    self.initial_state.full(),
                    dtype=_solver_mod._numpy_dtype(cdtype),
                )
            else:
                # ρ = ψψ† is formed on the device
                rho0 = ("pure", self._initial_ket())
            # ρ costs 4^N: beyond roughly half the statevector's qubit
            # ceiling its rows shard over the ranks
            rho_mesh = None
            if d == 2 and n >= state_sharding.rho_shard_min_qubits():
                rho_mesh = state_sharding.default_state_mesh(n)
            check_capacity(
                d, n, n_eval=n_eval, itemsize=itemsize,
                n_devices=_solver_mod._mesh_size(rho_mesh),
                density_matrix=True, what="master-equation solve",
                device=self._torch_device,
            )
            with profiling.phase("emulator.mesolve"):
                states_arr = _solver_mod.mesolve_rk4(
                    rho0,
                    plan,
                    hamiltonian.int_diag,
                    hamiltonian.pairs,
                    d,
                    n,
                    mats,
                    dtype=cdtype,
                    ip=step.mesolve_ip,
                    state_mesh=rho_mesh,
                    lazy=True,
                    device=self._torch_device,
                    **xy,
                )
            shape, dims = (d**n, d**n), [[d] * n, [d] * n]
        else:
            # Beyond the single-device threshold the 2^N axis itself
            # shards over the ranks
            state_mesh = state_sharding.solve_state_mesh(
                d, n, can_use_ip, hamiltonian.xy_mat,
                hamiltonian.int_w is not None,
            )
            check_capacity(
                d, n, n_eval=n_eval, itemsize=itemsize,
                n_devices=_solver_mod._mesh_size(state_mesh),
                what="Schrödinger solve", device=self._torch_device,
            )
            with profiling.phase("emulator.sesolve"):
                states_arr = _solver_mod.sesolve_rk4(
                    self._initial_ket(),
                    plan,
                    hamiltonian.int_diag,
                    hamiltonian.pairs,
                    d,
                    n,
                    dtype=cdtype,
                    # The projector occupancies are synthesized from the
                    # basis index; any non-None value selects the
                    # interaction picture, which the XY term and int_w
                    # rule out
                    ip_occ=True if can_use_ip else None,
                    state_mesh=state_mesh,
                    lazy=True,
                    device=self._torch_device,
                    **xy,
                )
            # Coarse RK4 steps drift the norm by ~1e-6/µs; the evolution
            # is exactly unitary, so the emitted states are renormalized
            # at fetch time (direction/phase accuracy is separately held
            # at ~1e-10 by the ω·h bound).
            states_arr.normalize = bool(step.coarsen)
            shape, dims = (d**n, 1), [[d] * n, [1] * n]
        with profiling.phase("emulator.wrap_results"):
            states = [
                Qobj.deferred(
                    functools.partial(states_arr.state, i), shape, dims
                )
                for i in range(len(states_arr))
            ]
            return self._wrap_coherent(states, device_states=states_arr)

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

    def _wrap_coherent(
        self,
        states: list[Qobj],
        device_states: "_solver_mod.DeviceStateBatch | None" = None,
    ) -> CoherentResults:
        """Wraps per-eval-time states into CoherentResults; a device-
        resident batch rides along as ``_device_states`` (the backend's
        observables read it without fetching the states)."""
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
        coherent = CoherentResults(
            results,
            self._hamiltonian_data.n_qudits,
            self.basis_name,
            self._eval_times_array,
            self._meas_basis,
            self._meas_errors(),
        )
        coherent._device_states = device_states
        return coherent

    def _meas_errors(self) -> "dict[str, float] | None":
        """The SPAM measurement errors the results flip their shots with."""
        if "SPAM" not in self.noise_model.noise_types:
            return None
        return {
            "epsilon": self.noise_model.p_false_pos,
            "epsilon_prime": self.noise_model.p_false_neg,
        }

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
        if "SPAM" in self.noise_model.noise_types:
            v = self._hamiltonian_data.basis_data.interaction_type
            if (
                self.noise_model.state_prep_error > 0
                and self.initial_state
                != tensor(
                    [self.basis[("u" if v == "XY" else "g")]]
                    * self._hamiltonian_data.n_qudits
                )
            ):
                raise NotImplementedError(
                    "Can't combine state preparation errors with an"
                    " initial state different from the ground."
                )

    def run(
        self,
        progress_bar: bool = False,
        print_progress: bool = False,
        **options: Any,
    ) -> SimulationResults:
        """Simulates the sequence.

        Args:
            progress_bar: Kept for API parity (the solver has no
                incremental progress to report).
            print_progress: Whether to print which noise trajectories
                are being emulated.
            options: Solver options; `max_step` (µs) caps the
                integration step.

        Returns:
            NoisyResults (bitstring counts at each evaluation time) when
            the noise is stochastic, CoherentResults otherwise.
        """
        with profiling.phase("emulator.run"):
            self._validate_options(options)
            if not (
                progress_bar is True
                or progress_bar is False
                or progress_bar is None
            ):
                raise ValueError("`progress_bar` must be a bool.")
            if not _has_stochastic_noise(self.noise_model):
                if print_progress:
                    print("Emulating Trajectory 1/1")
                return self._run_solver(
                    mcsolve_ntraj=self.n_trajectories or 1, **options
                )

            # The routes in the JAX package's order. The gates build the
            # noiseless Hamiltonian, whose one draw from the numpy global RNG
            # comes here in the JAX package too.
            total_count = None
            if self._can_batch_lindblad():
                # Quantum jumps: the draws run on the device after the solve
                # where the row-batched solve takes the batch (None, before
                # any draw, under the master equation)
                total_count = self._counts_rows_fused(
                    print_progress=print_progress, **options
                )
            if total_count is None and (
                self._can_batch_trajectories() or self._can_batch_lindblad()
            ):
                # One solve for the batch (pure states, or one density matrix
                # per trajectory), one vectorized sampling pass on the host
                total_count = self._sample_runs_vectorized(
                    progress_bar=progress_bar,
                    print_progress=print_progress,
                    **options,
                )
            elif total_count is None:
                # One solve per trajectory (a density-matrix initial state, or
                # depolarizing noise under the master equation), sampled per
                # trajectory and evaluation time
                spr = self.noise_model.samples_per_run
                total_count = np.array(
                    [Counter() for _ in self._eval_times_array]
                )
                for cres, reps in self._noisy_runs(
                    progress_bar=progress_bar,
                    print_progress=print_progress,
                    **options,
                ):
                    total_count += np.array(
                        [
                            cres.sample_state(t, n_samples=spr * reps)
                            for t in self._eval_times_array
                        ]
                    )
            n_measures = (
                cast(int, self.n_trajectories)
                * self.noise_model.samples_per_run
            )
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", category=DeprecationWarning)
                results = [
                    SampledResult(
                        tuple(self._hamiltonian_data.register.qubits),
                        self._meas_basis,
                        total_count[ind],
                        evaluation_time=t / (self._tot_duration * 1e-3),
                    )
                    for ind, t in enumerate(self._eval_times_array)
                ]
            return NoisyResults(
                results,
                self._hamiltonian_data.n_qudits,
                self.basis_name,
                self._eval_times_array,
                n_measures,
            )

    def _refresh_trajectories(self) -> None:
        """Draws fresh noise trajectories for repeated run() calls."""
        if self._noise_trajectories_used:
            noise_model = self._hamiltonian_data.noise_model
            self._hamiltonian_data = HamiltonianData(
                self.samples_obj,
                self._register,
                self.device,
                noise_model,
                self._get_n_trajectories(noise_model, check_value=True),
            )
        self._noise_trajectories_used = True

    def _can_batch_trajectories(self) -> bool:
        """Whether noise trajectories can integrate as one pure-state
        batch: no collapse operators (read from the true noise model;
        the noiseless Hamiltonian never carries any), no XY coupling or
        interaction interpolation, a ket initial state. Trajectory noise
        then only perturbs the coefficient values and the diagonal."""
        ham0 = self._noiseless_hamiltonian
        lindblad = self._hamiltonian_data.lindblad_data
        return (
            len(lindblad.local_collapse_ops) == 0
            and not _lab_only(ham0)
            and self.initial_state.isket
        )

    def _noisy_runs_batched(
        self,
        print_progress: bool = False,
        **options: Any,
    ) -> Iterator[tuple[SimulationResults, int]]:
        """The pure-state trajectory batch in a single solve: yields one
        ``(CoherentResults, repetitions)`` per trajectory."""
        reps_all, states_batch, coarsen, (d, n) = self._noisy_states_batched(
            print_progress=print_progress, **options
        )
        legal_dims_ket = [[d] * n, [1] * n]
        for reps, states_t in zip(reps_all, states_batch):
            with profiling.phase("emulator.wrap_results"):
                if coarsen:
                    states_t = _renormalized(states_t)
                states_q = [Qobj(s, dims=legal_dims_ket) for s in states_t]
                res = self._wrap_coherent(states_q)
            yield res, reps

    def _noisy_states_batched(
        self,
        print_progress: bool = False,
        lazy: bool = False,
        **options: Any,
    ) -> tuple[list[int], Any, bool, tuple[int, int]]:
        """The pure-state trajectory batch in a single solve:
        ``(repetitions, states, renormalize, (d, n))`` with the
        ``(T, n_eval, d^n)`` states as the solve returns them; under the
        coarsened step each state is to be renormalized
        (:func:`_renormalized`). When ``lazy`` and the batch takes the
        batched kernel, the states are the kernel's output where it lies
        (a :class:`~pulser_tpu_torch.ops.solver.BatchedKets`)."""
        with profiling.phase("emulator.noise_trajectories"):
            with profiling.phase("emulator.traj_draw"):
                self._refresh_trajectories()
            with profiling.phase("emulator.coeff_batch"):
                batch = self._noisy_coeff_batch()
        if print_progress:
            print(
                f"Emulating Trajectories [1 - {self.n_trajectories}]"
                f"/{self.n_trajectories} (batched)"
            )
        first = batch.template
        d, n = first.dim, first.n_qudits
        knots = first.sampling_times
        with profiling.phase("emulator.step_policy"):
            # Shared step cap: the tightest across trajectories. The batch
            # integrates in the interaction picture, so the coherent
            # path's coarsening applies (its 1.3 margin for several
            # trajectories absorbs the fluctuations of their gaps)
            lambda_max = float(
                np.max(
                    np.sum(2 * np.max(np.abs(batch.amp), axis=(2, 3)), axis=1)
                )
            )
            step = self._step_policy(
                first, lambda_max, "sesolve_batch", 1.3, batch, options
            )
        # Beyond the state-sharding threshold, noisy runs use both
        # parallel axes at once: trajectories × state blocks on a 2-D
        # mesh (the collectives ride the state axis only)
        diags = batch.diags
        n_traj_true = len(batch.reps)
        mesh2 = None
        if d == 2 and all({i, j} == {0, 1} for i, j, _ in first.pairs):
            mesh2 = mesh2d.default_2d_mesh(n, n_traj_true)
        amp_b, det_b = batch.amp, batch.det
        if mesh2 is not None:
            (amp_b, det_b, diags), _ = trajectories.pad_to_multiple(
                (np.asarray(amp_b), np.asarray(det_b), diags),
                comm.axis_size(mesh2, "traj"),
            )
        # One plan for the whole batch, staged on the host in float64:
        # the grid is shared, only the coefficient values differ
        with profiling.phase("emulator.build_plan_batched"):
            plans = _solver_mod.build_plan_batched(
                knots,
                {"amp": amp_b, "det": det_b},
                self._eval_times_array,
                max_step=step.max_step,
                coarsen=step.coarsen,
                breakpoints=step.breakpoints(),
            )
        cdtype = _solver_mod._numpy_dtype(_default_cdtype())
        psi0 = np.asarray(self._initial_ket(), dtype=cdtype)
        with profiling.phase("emulator.sesolve_batched"):
            if mesh2 is not None:
                states_batch = mesh2d.sesolve_ip_2d_sharded(
                    psi0, plans, diags, first.pairs, n, mesh2, dtype=cdtype,
                    device=self._torch_device,
                )[:n_traj_true]
            else:
                # Trajectories shard over every rank when the world has
                # more than one
                states_batch = _solver_mod.sesolve_rk4_batched(
                    psi0,
                    plans,
                    diags,
                    first.pairs,
                    d,
                    n,
                    True,
                    dtype=cdtype,
                    mesh=trajectories.default_mesh(),
                    device=self._torch_device,
                    lazy=lazy,
                )
        profiling.count("traj.realizations", n_traj_true)
        self._current_hamiltonian = batch.last_ham()
        return batch.reps, states_batch, step.coarsen, (d, n)

    def _noisy_runs(
        self,
        progress_bar: bool,
        print_progress: bool = False,
        **options: Any,
    ) -> Iterator[tuple[SimulationResults, int]]:
        """Clean results of every noisy trajectory, with its repetitions:
        the pure-state batch, the dissipative batch, or one solve per
        trajectory."""
        if self._can_batch_trajectories():
            yield from self._noisy_runs_batched(
                print_progress=print_progress, **options
            )
            return
        if self._can_batch_lindblad():
            yield from self._noisy_runs_batched_lindblad(
                print_progress=print_progress, **options
            )
            return
        n_trajectories = self.n_trajectories
        traj_nb = 0
        # Repeated run() calls use fresh noise trajectories
        self._refresh_trajectories()
        for ham, reps in self._hamiltonians:
            if print_progress:
                if reps == 1:
                    print(
                        f"Emulating Trajectory {traj_nb + 1}/{n_trajectories}"
                    )
                else:
                    print(
                        "Emulating Trajectories "
                        f"[{traj_nb + 1} - {traj_nb + reps}]/{n_trajectories}"
                    )
            self._current_hamiltonian = ham
            traj_nb += reps
            yield self._run_solver(ham, **options), reps

    def _sample_runs_vectorized(
        self,
        progress_bar: bool,
        print_progress: bool = False,
        **options: Any,
    ) -> np.ndarray:
        """Per-eval-time bitstring Counters over all noisy runs.

        One vectorized pass over the whole (trajectory × eval-time)
        batch: a cumsum and searchsorted sampler per entry and the SPAM
        flips, drawn from the numpy global RNG in the JAX package's order
        (one uniform per measurement sample, trajectory-major and
        eval-time-minor, then the flip uniforms). Where the batch took
        the batched kernel, the outcomes are drawn on its device from
        the same uniforms (:func:`_sample_batched_kets`); elsewhere on
        the host.
        """
        eval_ts = self._eval_times_array
        spr = self.noise_model.samples_per_run
        width = self._hamiltonian_data.n_qudits
        if (
            self._can_batch_trajectories()
            and self._hamiltonian_data.basis_data.dim == 2
            and self._meas_basis in self.basis_name
        ):
            # Qubit kets measured in their own basis: the shots are drawn
            # from the states with the arithmetic of TorchResult._weights,
            # and no result is wrapped; the batched kernel's states stay on
            # its device, where they are drawn from
            reps_all, states, coarsen, _ = self._noisy_states_batched(
                print_progress=print_progress, lazy=True, **options
            )
            sample = (
                _sample_batched_kets
                if isinstance(states, _solver_mod.BatchedKets)
                else _sample_ket_states
            )
            with profiling.phase("emulator.sample_counts"):
                return sample(
                    states,
                    coarsen,
                    [_time_index(eval_ts, t) for t in eval_ts],
                    self._meas_basis == "ground-rydberg",
                    [spr * reps for reps in reps_all for _ in eval_ts],
                    len(eval_ts),
                    width,
                    self._meas_errors(),
                )
        weight_rows: list[np.ndarray] = []
        ns: list[int] = []
        meas_errors = None
        for cres, reps in self._noisy_runs(
            progress_bar=progress_bar,
            print_progress=print_progress,
            **options,
        ):
            with profiling.phase("emulator.traj_weights"):
                meas_errors = getattr(cres, "_meas_errors", None)
                for t in eval_ts:
                    ti = cres._get_index_from_time(t, 1.0e-3)
                    weight_rows.append(cres[ti]._weights())
                    ns.append(spr * reps)
        with profiling.phase("emulator.sample_counts"):
            return _sample_weight_rows(
                weight_rows, ns, len(eval_ts), width, meas_errors
            )

    def _can_batch_lindblad(self) -> bool:
        """Whether dissipative noise trajectories can batch on the device
        (one quantum-jump realization or one density matrix per
        trajectory): collapse operators, no depolarizing, no XY or
        interaction interpolation, a ket initial state."""
        ham0 = self._noiseless_hamiltonian
        lindblad = self._hamiltonian_data.lindblad_data
        return (
            len(lindblad.local_collapse_ops) > 0
            and not lindblad.depolarizing_pauli_2ds
            and not _lab_only(ham0)
            and self.initial_state.isket
        )

    def _lindblad_solver_choice(self) -> bool:
        """True when the quantum-jump solver handles Lindblad terms:
        MCSOLVER, or DEFAULT under stochastic noise (the reference's
        auto-selection)."""
        return self.solver == Solver.MCSOLVER or (
            self.solver == Solver.DEFAULT
            and _has_stochastic_noise(self.noise_model)
        )

    def _lindblad_batch_prep(self, options: Any) -> "_LindbladPrep":
        """Host prep for the batched quantum-jump run.

        Draws fresh noise trajectories, builds the per-trajectory
        coefficient batch and the shared integration plan, and resolves
        the interaction-picture policy. On the factored fast path the
        stiffness and the breakpoint marks come straight from the
        profile rows; the dense batch never materializes.
        """
        with profiling.phase("emulator.noise_trajectories"):
            with profiling.phase("emulator.traj_draw"):
                self._refresh_trajectories()
            with profiling.phase("emulator.coeff_batch"):
                batch = self._noisy_coeff_batch()
        first = batch.template
        d, n = first.dim, first.n_qudits
        knots = first.sampling_times
        factored = (
            batch.amp_factors is not None and batch.det_factors is not None
        )
        # Shared step cap across trajectories: full (lab-frame)
        # stiffness
        with profiling.phase("emulator.step_policy"):
            diag_stiff = np.max(
                np.abs(batch.diags.reshape(len(batch.reps), -1)), axis=1
            )
            if factored:
                amp_stiff, det_stiff, marks = self._factored_policy(
                    batch, knots
                )
            else:
                amp_stiff = np.sum(
                    2 * np.max(np.abs(batch.amp), axis=(2, 3)), axis=1
                )
                det_stiff = np.sum(
                    np.max(np.abs(batch.det), axis=(2, 3)), axis=1
                )
                marks = batch
            lambda_max = float(np.max(amp_stiff + diag_stiff + det_stiff))
            step = self._step_policy(
                first, lambda_max, "lindblad_batch", 1.3, marks, options
            )
        # One plan for the whole batch; the drives and the exact phase
        # integrals are staged on the device from the raw knot values
        if factored:
            coeffs_for_plan = {
                "amp": _solver_mod.RankFactors(*batch.amp_factors),
                "det": _solver_mod.RankFactors(*batch.det_factors),
            }
        else:
            coeffs_for_plan = {"amp": batch.amp, "det": batch.det}
        with profiling.phase("emulator.build_plan_batched"):
            plans = _solver_mod.build_plan_batched(
                knots,
                coeffs_for_plan,
                self._eval_times_array,
                max_step=step.max_step,
                host_stage=False,
                coarsen=step.coarsen,
                breakpoints=step.breakpoints(),
            )
        return _LindbladPrep(
            batch=batch,
            plans=plans,
            d=d,
            n=n,
            pairs=first.pairs,
            collapse_mats=first._local_collapse_mats,
            psi0=np.asarray(
                self._initial_ket(),
                dtype=_solver_mod._numpy_dtype(_default_cdtype()),
            ),
            mcwf_ip=step.mcwf_ip,
            mesolve_ip=step.mesolve_ip,
        )

    def _noisy_runs_batched_lindblad(
        self,
        print_progress: bool = False,
        **options: Any,
    ) -> Iterator[tuple[SimulationResults, int]]:
        """The dissipative trajectory batch in one solve: one quantum-jump
        realization per trajectory under the quantum-jump solver, one
        density matrix per trajectory under the master equation; yields
        one ``(CoherentResults, repetitions)`` per trajectory."""
        p = self._lindblad_batch_prep(options)
        if print_progress:
            self._print_batched_progress()
        d, n = p.d, p.n
        cdtype = p.psi0.dtype
        if self._lindblad_solver_choice():
            # The per-trajectory seed draws of the serial loop
            seeds = [int(np.random.randint(2**31)) for _ in p.batch.reps]
            with profiling.phase("emulator.mcsolve_batched"):
                states_batch = _solver_mod.mcsolve_rk4_batched(
                    p.psi0, p.plans, p.batch.diags, p.pairs, d, n,
                    p.collapse_mats, seeds, dtype=cdtype,
                    mesh=trajectories.default_mesh(), ip=p.mcwf_ip,
                    device=self._torch_device,
                )
            dims = [[d] * n, [1] * n]
        else:
            check_capacity(
                d,
                n,
                n_eval=len(self._eval_times_array),
                itemsize=cdtype.itemsize // 2,
                density_matrix=True,
                what="master-equation solve of one trajectory",
                device=self._torch_device,
            )
            with profiling.phase("emulator.mesolve_batched"):
                states_batch = _solver_mod.mesolve_rk4_batched(
                    np.outer(p.psi0, p.psi0.conj()),
                    p.plans, p.batch.diags, p.pairs, d, n, p.collapse_mats,
                    dtype=cdtype, mesh=trajectories.default_mesh(),
                    ip=p.mesolve_ip, device=self._torch_device,
                )
            dims = [[d] * n, [d] * n]
        self._current_hamiltonian = p.batch.last_ham()
        for reps, states_t in zip(p.batch.reps, states_batch):
            with profiling.phase("emulator.wrap_results"):
                states_q = [Qobj(s, dims=dims) for s in states_t]
                res = self._wrap_coherent(states_q)
            yield res, reps

    def _print_batched_progress(self) -> None:
        print(
            f"Emulating Trajectories [1 - {self.n_trajectories}]"
            f"/{self.n_trajectories} (batched, dissipative)"
        )

    def _counts_rows_fused(
        self, print_progress: bool = False, **options: Any
    ) -> "np.ndarray | None":
        """Per-eval-time bitstring Counters of the batched quantum-jump
        solve.

        When the row-batched solve takes the configuration, the
        measurement draws run on the device after it; otherwise the
        state-returning solve runs and the draws run on the host with
        the uniforms already drawn. The numpy global RNG is consumed in
        the JAX package's order:
        the noise trajectories (drawn at construction, or redrawn for a
        repeated run), the noiseless Hamiltonian's draw, one seed per
        trajectory, one uniform per measurement sample
        (trajectory-major, eval-time-minor), then the SPAM flip
        uniforms. Returns None, before any draw, where the quantum-jump
        solver does not take the batch (the master equation, other
        bases).
        """
        if not self._lindblad_solver_choice():
            return None
        hd = self._hamiltonian_data
        if (
            hd.basis_data.dim != 2
            or self._meas_basis != "ground-rydberg"
            or self._meas_basis not in self.basis_name
        ):
            return None
        p = self._lindblad_batch_prep(options)
        if print_progress:
            self._print_batched_progress()
        d, n = p.d, p.n
        seeds = [int(np.random.randint(2**31)) for _ in p.batch.reps]
        eval_ts = self._eval_times_array
        n_times = len(eval_ts)
        spr = self.noise_model.samples_per_run
        reps_arr = np.asarray(p.batch.reps, dtype=np.int64)
        # Per-(trajectory, eval-time) entries, trajectory-major
        ns = np.repeat(reps_arr * spr, n_times)  # (n_entries,)
        n_entries = len(ns)
        row_traj = np.repeat(np.arange(len(reps_arr), dtype=np.int64), n_times)
        row_ti = np.tile(np.arange(n_times, dtype=np.int64), len(reps_arr))
        rnd = np.random.rand(int(ns.sum()))
        # Row-padded draws: one (n_entries, dim) cumsum gather and
        # (n_entries, m) searches on the device
        m = int(ns.max()) if n_entries else 0
        valid = np.arange(m)[None, :] < ns[:, None]
        u_pad = np.full((n_entries, m), 0.5)
        u_pad[valid] = rnd

        solve_args = (
            p.psi0, p.plans, p.batch.diags, p.pairs, d, n, p.collapse_mats,
            seeds,
        )
        solve_kw = dict(
            dtype=p.psi0.dtype, mesh=trajectories.default_mesh(),
            ip=p.mcwf_ip, device=self._torch_device,
        )
        with profiling.phase("emulator.mcsolve_batched"):
            codes_pad = _solver_mod.mcsolve_rows_codes(
                *solve_args, (u_pad, row_traj, row_ti), **solve_kw
            )
        if codes_pad is not None:
            # Device draws return STATE indices; the ground-rydberg
            # bitstring order is their reversal
            codes = (d**n - 1) - np.asarray(codes_pad, dtype=np.int64)[valid]
        else:
            with profiling.phase("emulator.mcsolve_batched"):
                states = _solver_mod.mcsolve_rk4_batched(
                    *solve_args, **solve_kw
                )
            with profiling.phase("emulator.sample_counts"):
                codes = _host_sample_codes(states, ns, rnd)
        self._current_hamiltonian = p.batch.last_ham()

        with profiling.phase("emulator.sample_counts"):
            width = hd.n_qudits
            bit_pos = np.arange(width - 1, -1, -1)
            bits = (codes[:, None] >> bit_pos) & 1
            nm = self.noise_model
            if "SPAM" in nm.noise_types and (
                nm.p_false_pos != 0.0 or nm.p_false_neg != 0.0
            ):
                flip_probs = np.where(
                    bits == 1, nm.p_false_neg, nm.p_false_pos
                )
                flips = np.random.uniform(size=bits.shape) < flip_probs
                bits = bits ^ flips
            out_codes = bits @ (1 << bit_pos)
            total_count = np.array([Counter() for _ in eval_ts])
            draw_ti = np.repeat(row_ti, ns)
            combo = (draw_ti << width) + out_codes
            vals, cnts = np.unique(combo, return_counts=True)
            labels = _labels_of(vals & ((1 << width) - 1), width)
            for v, lab, c in zip(
                (vals >> width).tolist(), labels, cnts.tolist()
            ):
                total_count[v][lab] += c
        return total_count

    def draw(
        self,
        draw_phase_area: bool = False,
        draw_phase_shifts: bool = False,
        draw_phase_curve: bool = False,
        fig_name: str | None = None,
        kwargs_savefig: dict = {},
    ) -> None:
        """Draws the samples of the sequence used for the simulation."""
        import matplotlib.pyplot as plt

        from pulser_tpu_torch.sequence._seq_drawer import draw_samples

        draw_samples(
            self.samples_obj,
            self._register,
            self._sampling_rate,
            draw_phase_area=draw_phase_area,
            draw_phase_shifts=draw_phase_shifts,
            draw_phase_curve=draw_phase_curve,
        )
        if fig_name is not None:
            plt.savefig(fig_name, **kwargs_savefig)
        plt.show()

    @classmethod
    def from_sequence(
        cls,
        sequence: Sequence,
        sampling_rate: float = 1.0,
        config: Optional[SimConfig] = None,
        evaluation_times: Union[float, str, ArrayLike] = "Full",
        with_modulation: bool = False,
        noise_model: NoiseModel | None = None,
        solver: Solver = Solver.DEFAULT,
        n_trajectories: int | None = None,
        torch_device: Union[str, torch.device, None] = None,
    ) -> TorchEmulator:
        r"""Creates the emulator from a Sequence.

        Args:
            sequence: The Sequence to simulate.
            sampling_rate: The fraction of samples to extract from the
                pulse sequence (between 0.05 and 1.0).
            config: (Deprecated) SimConfig; use 'noise_model'.
            evaluation_times: "Full", "Minimal", an array of times (in
                µs) or a float sampling fraction.
            with_modulation: Whether to simulate the sequence with the
                programmed input or the expected output.
            noise_model: The noise model for the simulation.
            solver: Solver selection.
            n_trajectories: The number of noise trajectories.
            torch_device: The torch device the solver runs on (default:
                the first CUDA device; without one the call raises, and
                ``"cpu"`` must be asked for).
        """
        with profiling.phase("emulator.sample_sequence"):
            samples = HamiltonianData._sequence_samples(
                sequence, with_modulation
            )
        return cls(
            samples,
            sequence.register,
            sequence.device,
            sampling_rate,
            config,
            evaluation_times,
            noise_model=noise_model,
            solver=solver,
            n_trajectories=n_trajectories,
            torch_device=torch_device,
        )


def _renormalized(states: np.ndarray) -> np.ndarray:
    """``(n_eval, dim)`` states each divided by its own norm (a zero
    state stays zero), as the coherent path renormalizes its unitary
    evolution under the coarsened step."""
    norms = np.linalg.norm(states, axis=-1, keepdims=True)
    return states / np.where(norms == 0, 1.0, norms)


def _time_index(times: np.ndarray, t: float, tol: float = 1.0e-3) -> int:
    """The first index of ``times`` within ``tol`` of ``t`` (µs), as
    ``CoherentResults`` looks an evaluation time up."""
    return int(np.where(abs(t - times) < tol)[0][0])


def _sample_ket_states(
    states: np.ndarray,
    renormalize: bool,
    time_index: list[int],
    reverse: bool,
    ns: list[int],
    n_times: int,
    width: int,
    meas_errors: "dict | None",
) -> np.ndarray:
    """Bitstring Counters per evaluation time drawn from ``(T, n_eval,
    2^width)`` qubit kets measured in their own basis, without wrapping
    them into results.

    The draws are those of :func:`_sample_weight_rows` over the weight
    rows of the states' results, bit for bit, a state at a time in
    reused buffers: where ``renormalize``, the state divided by its norm
    as :func:`_renormalized` divides it (the norm's reduction of one
    row, then numpy's complex-by-real division, which multiplies by the
    rounded reciprocal; a zero's sign may differ, no weight does); the
    row at ``time_index[i]`` for evaluation time ``i``; then
    ``TorchResult._weights``: widened to complex128 as its ``Qobj``
    stores it, ``|amplitude|²``, reversed into bitstring order for the
    ground-rydberg basis (its states list the Rydberg level first), over
    its sequential total; then summed cumulatively, after the uniforms
    are drawn. One thread: on a shared host, threads made the pass
    faster on average but far less steady.
    """
    offs = np.concatenate(([0], np.cumsum(ns)))
    rnd = np.random.rand(offs[-1])
    idx = np.empty(offs[-1], dtype=np.int64)
    dim, real = states.shape[-1], states.real.dtype
    square = np.empty(dim, dtype=states.dtype)
    state = np.empty(dim, dtype=states.dtype)
    amps = np.empty(dim, dtype=complex)
    probs, scaled, cum = np.empty((3, dim))
    weights = probs[::-1] if reverse else probs
    entry = 0
    for states_t in states:
        for ti in time_index:
            if renormalize:
                np.conjugate(states_t[ti], out=square)
                np.multiply(square, states_t[ti], out=square)
                norm = np.sqrt(np.add.reduce(square.real))
                inv = real.type(1) / (norm if norm != 0 else real.type(1))
                np.multiply(states_t[ti].view(real), inv, out=state.view(real))
                amps[...] = state
            else:
                amps[...] = states_t[ti]
            np.abs(amps, out=probs)
            np.square(probs, out=probs)
            total = np.add.accumulate(weights, out=scaled)[-1]
            np.divide(weights, total, out=scaled)
            np.cumsum(scaled, out=cum)
            sl = slice(offs[entry], offs[entry + 1])
            idx[sl] = _draw_from(cum, rnd[sl])
            entry += 1
    return _counts_of(idx, offs, n_times, width, meas_errors)


def _sample_batched_kets(
    kets: "_solver_mod.BatchedKets",
    renormalize: bool,
    time_index: list[int],
    reverse: bool,
    ns: list[int],
    n_times: int,
    width: int,
    meas_errors: "dict | None",
) -> np.ndarray:
    """Bitstring Counters per evaluation time drawn from the batched
    kernel's kets where they lie (:meth:`~pulser_tpu_torch.ops.solver.
    BatchedKets.draw`), with the arguments of :func:`_sample_ket_states`.

    The host draws the same uniforms from the numpy global RNG, then the
    same SPAM flips (:func:`_counts_of`), so the generator ends where the
    host pass leaves it; the device reproduces the host pass's weights,
    and an outcome can differ only where a uniform lies within the
    rounding of a cumulative weight.
    """
    offs = np.concatenate(([0], np.cumsum(ns)))
    rnd = np.random.rand(offs[-1])
    idx = kets.draw(
        time_index, offs, rnd, renormalize=renormalize, reverse=reverse
    )
    return _counts_of(idx, offs, n_times, width, meas_errors)


def _draw_from(cum: np.ndarray, u: np.ndarray) -> np.ndarray:
    """Outcome indices of uniforms ``u`` by a searchsorted of cumulative
    weights ``cum``. A row's rounded total can end a few ulps below 1; a
    uniform above it draws the row's last outcome of positive weight."""
    return np.minimum(np.searchsorted(cum, u), np.searchsorted(cum, cum[-1]))


def _sample_weight_rows(
    weights: Iterable[np.ndarray],
    ns: list[int],
    n_times: int,
    width: int,
    meas_errors: "dict | None",
) -> np.ndarray:
    """Bitstring Counters per evaluation time, drawn on the host from
    measurement weights: one row of ``2^width`` per entry.

    Entry ``e`` (trajectory-major, eval-time-minor) takes ``ns[e]``
    uniforms of one draw from the numpy global RNG and a searchsorted of
    its cumulative weights (:func:`_draw_from`); the SPAM flips
    (``meas_errors`` with "epsilon" and "epsilon_prime") are one more
    draw over all the bits (:func:`_counts_of`).
    """
    offs = np.concatenate(([0], np.cumsum(ns)))
    rnd = np.random.rand(offs[-1])
    idx = np.empty(offs[-1], dtype=np.int64)
    for e, row in enumerate(weights):
        sl = slice(offs[e], offs[e + 1])
        idx[sl] = _draw_from(np.cumsum(row), rnd[sl])
    return _counts_of(idx, offs, n_times, width, meas_errors)


def _counts_of(
    idx: np.ndarray,
    offs: np.ndarray,
    n_times: int,
    width: int,
    meas_errors: "dict | None",
) -> np.ndarray:
    """The Counters per evaluation time of drawn outcome indices, entry
    ``e`` (realization ``e // n_times`` at evaluation time ``e %
    n_times``) holding ``idx[offs[e]:offs[e + 1]]``, after the SPAM flips.

    The flips are one uniform per bit, most significant first, compared
    with the bit's flip probability. The tally is one pass over the
    job's draws: each time's Counter lists its outcomes as adding every
    entry's sorted counts in turn would, by the first realization that
    drew them, then by code.
    """
    # The low ``width`` bits of each index, most significant first
    planes = np.unpackbits(
        np.asarray(idx, dtype=">u8").view(np.uint8).reshape(-1, 8), axis=1
    )
    bits = planes[:, planes.shape[1] - width :]
    if meas_errors is not None and (
        meas_errors["epsilon"] != 0.0 or meas_errors["epsilon_prime"] != 0.0
    ):
        u = np.random.uniform(size=bits.shape)
        # A 0 flips where u < epsilon, a 1 where u < epsilon_prime
        # (bitwise: numpy's boolean where is several times slower)
        false_pos = u < meas_errors["epsilon"]
        false_neg = u < meas_errors["epsilon_prime"]
        bits ^= false_pos ^ (bits & (false_pos ^ false_neg))
    codes = np.packbits(planes, axis=1).view(">u8").ravel().astype(np.int64)
    codes &= (1 << width) - 1
    with profiling.phase("emulator.counts"):
        n_entries = len(offs) - 1
        n_real = -(-n_entries // n_times)
        # The job's distinct outcomes in code order, and each draw's rank
        outcomes, rank = np.unique(codes, return_inverse=True)
        n_out = len(outcomes)
        real, times = np.divmod(
            np.repeat(np.arange(n_entries), np.diff(offs)), n_times
        )
        # Sorted by time, then outcome, then realization
        keys, cnts = np.unique(
            (times * n_out + rank) * n_real + real, return_counts=True
        )
        # Each (time, outcome): its first realization and its whole count
        pair, real = np.divmod(keys, n_real)
        first = np.flatnonzero(np.diff(pair, prepend=-1))
        counts = np.add.reduceat(cnts, first)
        times, rank = np.divmod(pair[first], n_out)
        order = np.argsort((times * n_real + real[first]) * n_out + rank)
        labels = np.asarray(_labels_of(outcomes, width), dtype=object)
        labels = labels[rank[order]].tolist()
        counts = counts[order].tolist()
        bounds = np.searchsorted(times[order], np.arange(n_times + 1))
        bounds = bounds.tolist()
        total_count = np.array([Counter() for _ in range(n_times)])
        for t in range(n_times):
            a, b = bounds[t], bounds[t + 1]
            total_count[t].update(dict(zip(labels[a:b], counts[a:b])))
    return total_count


def _host_sample_codes(
    states: np.ndarray, ns: np.ndarray, rnd: np.ndarray
) -> np.ndarray:
    """Bitstring codes drawn on the host from ``(B, n_eval, dim)`` states.

    Entry ``e`` (trajectory-major, eval-time-minor) takes ``ns[e]``
    consecutive uniforms of ``rnd``; its probabilities are summed in
    bitstring order (the reversed state order) in float32, and each draw
    is a searchsorted-left of ``u · total``, as the JAX package draws.
    """
    dim = states.shape[-1]
    probs = np.abs(np.asarray(states)) ** 2
    cum = np.cumsum(probs[..., ::-1].reshape(-1, dim), axis=1)
    offs = np.concatenate(([0], np.cumsum(ns)))
    codes = np.empty(int(offs[-1]), dtype=np.int64)
    for e in range(len(ns)):
        sl = slice(offs[e], offs[e + 1])
        codes[sl] = np.searchsorted(cum[e], rnd[sl] * cum[e, -1])
    return codes


# Drop-in alias matching the reference class name
QutipEmulator = TorchEmulator
