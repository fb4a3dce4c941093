"""The backend-agnostic physics IR bridging samples to Hamiltonians.

Behavioral parity with reference
``pulser-core/pulser/_hamiltonian_data/hamiltonian_data.py:192-943``:
interaction matrices (Ising C6/r⁶; XY C3(1−3cos²θ)/r³ + stacked C6),
noise-trajectory generation matching numpy's global-RNG draw order (so
seeded tests reproduce the reference exactly), trajectory dedup by
repetition count, and the noisy-samples iterator.
"""

from __future__ import annotations

import functools
from collections import Counter
from collections.abc import Mapping
from dataclasses import replace
from typing import Iterator, List, Literal, NamedTuple, cast

import numpy as np
import torch
from numpy.typing import ArrayLike
from scipy.spatial.distance import cdist

import pulser_tpu_torch.math as pm
from pulser_tpu_torch.hamiltonian_data.basis_data import BasisData
from pulser_tpu_torch.hamiltonian_data.lindblad_data import LindbladData
from pulser_tpu_torch.hamiltonian_data.noise_trajectory import NoiseTrajectory
from pulser_tpu_torch.channels import DMM, Microwave, Raman, Rydberg
from pulser_tpu_torch.channels.base_channel import STATES_RANK, Channel, States
from pulser_tpu_torch.devices._device_datacls import COORD_PRECISION, BaseDevice
from pulser_tpu_torch.noise_model import NoiseModel
from pulser_tpu_torch.noise_model import _doppler_sigma as doppler_sigma
from pulser_tpu_torch.noise_model import _register_sigma_xy_z
from pulser_tpu_torch.register import Register3D
from pulser_tpu_torch.register.base_register import BaseRegister, QubitId
from pulser_tpu_torch.sampler.samples import (
    ChannelSamples,
    DMMSamples,
    SequenceSamples,
    _PulseTargetSlot,
)


class TrajectoryWithReps(NamedTuple):
    """A NoiseTrajectory and the number of times it should be simulated."""

    trajectory: NoiseTrajectory
    reps: int


class SamplesWithReps(NamedTuple):
    """A trajectory, samples and how often they should be simulated."""

    trajectory: NoiseTrajectory
    samples: SequenceSamples
    reps: int


# Noise types valid in every interaction mode; Ising additionally
# admits the drive/motion perturbations (amplitude, detuning, doppler,
# relaxation) and the DMM noises.
_MODE_AGNOSTIC_NOISES = frozenset(
    ("dephasing", "depolarizing", "eff_noise", "SPAM", "leakage", "register")
)
_ISING_ONLY_NOISES = frozenset(
    (
        "amplitude",
        "detuning",
        "doppler",
        "relaxation",
        "dmm_sigma",
        "dmm_crosstalk",
    )
)
SUPPORTED_NOISES: dict = {
    "ising": set(_MODE_AGNOSTIC_NOISES | _ISING_ONLY_NOISES),
    "XY": set(_MODE_AGNOSTIC_NOISES),
}

# Noise channels whose effect is captured by collapse operators alone
# (they don't perturb the samples, except through state-prep errors)
_COLLAPSE_ONLY_NOISES = frozenset(
    ("dephasing", "relaxation", "SPAM", "depolarizing", "eff_noise", "leakage")
)


def has_shot_to_shot_except_spam(noise_model: NoiseModel) -> bool:
    """Whether the noise model has stochastic noise, excepting SPAM."""
    if "doppler" in noise_model.noise_types:
        return True
    if "amplitude" in noise_model.noise_types and noise_model.amp_sigma:
        return True
    return bool(
        {"detuning", "register", "dmm_sigma"}
        & set(noise_model.noise_types)
    )


def _noisy_register(
    q_dict: dict[QubitId, pm.AbstractArray], noise_model: NoiseModel
) -> Register3D:
    """Add Gaussian noise to the positions of the register.

    RNG contract: one (N, 2) in-plane normal draw at σ_xy followed by
    one (N,) axial draw at σ_z — this exact order reproduces the
    reference's global-RNG stream under a fixed seed.
    """
    sigma_xy, sigma_z = _register_sigma_xy_z(
        noise_model.temperature,
        noise_model.trap_waist,
        cast(float, noise_model.trap_depth),
    )
    n_atoms = len(q_dict)
    jitter = np.column_stack(
        (
            np.random.normal(0, sigma_xy, (n_atoms, 2)),
            np.random.normal(0, sigma_z, n_atoms),
        )
    )
    noisy = {}
    for (qid, pos), dp in zip(q_dict.items(), jitter):
        if len(pos) == 2:
            pos = pm.concatenate((pos, [0.0]))
        noisy[qid] = pos + dp
    return Register3D(noisy)


def _generate_detuning_fluctuations(
    noise_model: NoiseModel,
    det_cst_term: float,
    phases: np.ndarray,
    times: ArrayLike,
) -> np.ndarray:
    """Compute δ_hf(t) + δ_σ.

    The high-frequency term uses Gaussian stochastic noise with 1-sided
    power spectral density `psd`:
    δ_hf(t) = Σ_k sqrt(2·Δω_k·psd_k)·cos(ω_k·t + φ_k), with
    φ_k ~ U[0, 2π) and Δω_k = omegas[k+1] − omegas[k] (the last entry
    of each series is unused).
    """
    if not noise_model.detuning_hf_psd:
        return det_cst_term + np.zeros_like(times)
    omegas = np.asarray(noise_model.detuning_hf_omegas)
    # Bin k spans [ω_k, ω_{k+1}); the series is evaluated at the bin's
    # UPPER edge (the final PSD entry is therefore never read).
    amp_k = np.sqrt(2.0 * np.diff(omegas) * noise_model.detuning_hf_psd[1:])
    t_us = np.asarray(times) * 1e-3  # ns -> µs
    arg = np.outer(omegas[1:], t_us) + phases[:, None]
    return det_cst_term + amp_k @ np.cos(arg)


def _distances(register: BaseRegister) -> pm.AbstractArray:
    r"""Distances between each pair of qubits (in :math:`\mu m`)."""
    positions = list(register.qubits.values())
    if positions[0].is_tensor:
        ten = torch.stack([x.as_tensor() for x in positions])
        return pm.AbstractArray(torch.cdist(ten, ten))
    dists = cast(
        np.ndarray, cdist(positions, positions, metric="euclidean")
    )
    return pm.AbstractArray(np.round(dists, COORD_PRECISION))


class HamiltonianData:
    r"""Information that can be used to generate a Hamiltonian.

    Takes information defining the noiseless case plus a noise model,
    creates noise trajectories, and lets backends query for noisy data.

    Args:
        samples: The noiseless sequence samples.
        register: The noiseless register.
        device: The device specifications.
        noise_model: NoiseModel to be used to generate noise.
        n_trajectories: The number of noise trajectories to sample.
            Defaults to 1.
    """

    def __init__(
        self,
        samples: SequenceSamples,
        register: BaseRegister,
        device: BaseDevice,
        noise_model: NoiseModel,
        n_trajectories: int | None,
    ) -> None:
        """Instantiates a HamiltonianData object."""
        if not isinstance(samples, SequenceSamples):
            raise TypeError(
                "The provided sequence has to be a valid "
                "SequenceSamples instance."
            )
        if samples.max_duration == 0:
            raise ValueError("SequenceSamples is empty.")
        if not isinstance(device, BaseDevice):
            raise TypeError("The device must be a Device or BaseDevice.")
        self._device = device
        self.device.validate_register(register)
        self._register = register
        self._check_samples_device_compat(samples)

        self._samples = self._delocalize_samples(samples)

        self._size = len(self.register.qubits)
        self._qid_index = {
            qid: i for i, qid in enumerate(self.register.qubits)
        }

        self._noise_model = noise_model
        self._check_noise_model(noise_model)

        # Sample-level noise only matters when something perturbs the
        # drives or the initial preparation; pure collapse noise doesn't.
        self.local_noises = True
        if set(noise_model.noise_types) <= _COLLAPSE_ONLY_NOISES:
            self.local_noises = (
                "SPAM" in noise_model.noise_types
                and noise_model.state_prep_error > 0
            )
        self.noise_trajectories = self._create_noise_trajectories(
            1 if n_trajectories is None else n_trajectories
        )

    def _check_samples_device_compat(
        self, samples: SequenceSamples
    ) -> None:
        if samples._slm_mask.end > 0 and not self.device.supports_slm_mask:
            raise ValueError(
                "Samples use SLM mask but device does not have one."
            )
        if not samples.used_bases <= self.device.supported_bases:
            raise ValueError(
                "Bases used in samples should be supported by device."
            )
        if not samples._slm_mask.targets <= set(
            self.register.qubits.keys()
        ):
            raise ValueError(
                "The ids of qubits targeted in SLM mask"
                " should be defined in register."
            )

    def _delocalize_samples(
        self, samples: SequenceSamples
    ) -> SequenceSamples:
        """Rewrites Global-channel slots to target every register qubit."""
        all_qids = set(self.register.qubits.keys())
        samples_list = []
        for ch, ch_samples in samples.channel_samples.items():
            if samples._ch_objs[ch].addressing == "Local":
                targeted = set().union(
                    *(slot.targets for slot in ch_samples.slots)
                )
                if not targeted <= all_qids:
                    raise ValueError(
                        "The ids of qubits targeted in Local channels"
                        " should be defined in register."
                    )
                samples_list.append(ch_samples)
                continue
            samples_list.append(
                replace(
                    ch_samples,
                    slots=[
                        replace(slot, targets=set(all_qids))
                        for slot in ch_samples.slots
                    ],
                )
            )
        return replace(samples, samples_list=samples_list)

    # -- Constructors -----------------------------------------------------

    # -- Simple accessors ---------------------------------------------------

    @functools.cached_property
    def n_qudits(self) -> int:
        """Number of qudits in the Register."""
        return self._size

    @property
    def samples(self) -> SequenceSamples:
        """The samples without noise."""
        return self._samples

    @property
    def register(self) -> BaseRegister:
        """The noiseless register used."""
        return self._register

    @property
    def device(self) -> BaseDevice:
        """The device used."""
        return self._device

    @property
    def noise_model(self) -> NoiseModel:
        """The current NoiseModel used."""
        return self._noise_model

    @property
    def basis_data(self) -> BasisData:
        """The BasisData defining this Hamiltonian."""
        interaction: Literal["XY", "ising"] = (
            "XY" if self.samples._in_xy else "ising"
        )
        with_leakage = self.noise_model.with_leakage
        eigenbasis = self._get_eigenbasis(with_leakage)
        return BasisData(
            dim=len(eigenbasis),
            basis_name=self._get_basis_name(with_leakage),
            eigenbasis=eigenbasis,
            interaction_type=interaction,
        )

    @property
    def lindblad_data(self) -> LindbladData:
        """The LindbladData defining this Hamiltonian."""
        basis_data = self.basis_data
        op_matrix_names = self._get_projectors(basis_data.eigenbasis)
        local_collapse_ops, paulis = self._build_local_collapse_operators(
            self.noise_model,
            basis_data.basis_name,
            basis_data.eigenbasis,
            op_matrix_names,
        )
        return LindbladData(
            op_matrix_names=op_matrix_names,
            local_collapse_ops=local_collapse_ops,
            depolarizing_pauli_2ds=paulis,
        )

    # -- Noisy sample generation -------------------------------------------

    def _apply_slot_noise(
        self,
        traj: NoiseTrajectory,
        slot: _PulseTargetSlot,
        samples_dict: Mapping[QubitId, dict[str, np.ndarray]],
        is_global_pulse: bool,
        amp_fluctuation: float,
        det_fluctuation: np.ndarray,
        propagation_dir: tuple | None,
        qubit_coords: Mapping[QubitId, tuple] | None = None,
        waist_cache: dict[tuple, float] | None = None,
    ) -> None:
        """Applies local noise effects to the nested samples, in place."""
        noise_types = self.noise_model.noise_types
        t_window = slice(slot.ti, slot.tf)
        for qid in slot.targets:
            if "doppler" in noise_types:
                samples_dict[qid]["det"][t_window] += traj.doppler_detune[
                    qid
                ]
            if "amplitude" in noise_types:
                amp_fraction = amp_fluctuation
                # Finite-waist Gaussian beam loss, global pulses only
                if (
                    self.noise_model.laser_waist is not None
                    and is_global_pulse
                ):
                    # The optical axis defaults to y
                    prop_dir = tuple(
                        propagation_dir or (0.0, 1.0, 0.0)
                    )
                    key = (qid, prop_dir)
                    frac = (
                        waist_cache.get(key)
                        if waist_cache is not None
                        else None
                    )
                    if frac is None:
                        coords = (
                            qubit_coords[qid]
                            if qubit_coords is not None
                            else tuple(
                                traj.register.qubits[qid].as_array()
                            )
                        )
                        frac = self._finite_waist_amp_fraction(
                            coords,
                            prop_dir,
                            self.noise_model.laser_waist,
                        )
                        if waist_cache is not None:
                            waist_cache[key] = frac
                    amp_fraction *= frac
                samples_dict[qid]["amp"][t_window] *= amp_fraction
            if "detuning" in noise_types:
                samples_dict[qid]["det"][t_window] += det_fluctuation[
                    t_window
                ]

    def _localized_noisy_samples(
        self, traj: NoiseTrajectory, samples: dict
    ) -> SequenceSamples:
        """Builds per-qubit virtual channels, zeroing badly prepared atoms."""
        basis_channel_type: dict[str, Channel] = {
            "XY": Microwave,  # type: ignore
            "ground-rydberg": Rydberg,  # type: ignore
        }
        channels = []
        samples_list = []
        ch_objs = {}
        for basis in samples["Local"]:
            type = basis_channel_type.get(basis, Raman)  # type: ignore
            qids = samples["Local"][basis].keys()
            basis_channels = list(f"{x}_{basis}" for x in qids)
            channels += basis_channels
            for qid, ch in zip(qids, basis_channels):
                vals = samples["Local"][basis][qid]
                if traj.bad_atoms[qid]:
                    for qty in ("amp", "det", "phase"):
                        vals[qty] *= 0.0
                samples_list.append(
                    ChannelSamples(
                        **{
                            k: pm.AbstractArray(v) for k, v in vals.items()
                        },
                        slots=[
                            _PulseTargetSlot(
                                ti=0,
                                tf=len(vals["amp"]),
                                targets={qid},
                            )
                        ],
                    )
                )
                ch_objs[ch] = type.Local(
                    max_abs_detuning=None, max_amp=None
                )

        out = SequenceSamples(
            _basis_ref=self._samples._basis_ref,
            _slm_mask=self._samples._slm_mask,
            _magnetic_field=self._samples._magnetic_field,
            _measurement=self._samples._measurement,
            channels=channels,
            samples_list=samples_list,
            _ch_objs=ch_objs,
        )
        # These virtual channels were BUILT from `samples`, so
        # re-deriving a nested dict from them is an identity round
        # trip the Hamiltonian can skip (it costs a per-qubit
        # re-emission per noise trajectory).
        out._nested_dict_hint = samples
        return out

    def _nested_leaf_copy(self, d: Any) -> Any:
        """Fresh-array copy of a nested samples dict."""
        if isinstance(d, dict):
            return {
                k: self._nested_leaf_copy(v) for k, v in d.items()
            }
        arr = np.asarray(d)
        return arr.copy() if arr.ndim else arr

    def _sample_with_trajectory(
        self, traj: NoiseTrajectory
    ) -> SequenceSamples:
        has_dmm = any(
            isinstance(cs, DMMSamples)
            for cs in self._samples.channel_samples.values()
        )
        if not has_dmm:
            # Without per-trajectory DMM noise the channel samples —
            # and hence the (expensive) per-qubit nested expansion —
            # are trajectory-INVARIANT: build it once and hand each
            # trajectory a leaf-copy for its in-place noise edits.
            cached = getattr(self, "_nested_dict_cache", None)
            if cached is None:
                cached = self._samples.to_nested_dict(
                    all_local=self.local_noises
                )
                self._nested_dict_cache = cached
            samples = self._nested_leaf_copy(cached)
        else:
            noisy_samples_list: List[ChannelSamples] = []
            for ch_name, ch_samples in (
                self._samples.channel_samples.items()
            ):
                if isinstance(ch_samples, DMMSamples):
                    # DC intensity noise scales the DMM detuning
                    ch_samples = replace(
                        ch_samples,
                        det=ch_samples.det
                        * traj.dmm_det_fluctuation[ch_name],
                        spot_waist=(
                            self.noise_model.detuning_map_spot_waist
                        ),
                    )
                noisy_samples_list.append(ch_samples)

            noisy_seq_samples = replace(
                self._samples, samples_list=noisy_samples_list
            )

            samples = noisy_seq_samples.to_nested_dict(
                all_local=self.local_noises
            )

        if not self.local_noises:
            return self._samples

        # Per-trajectory caches for the slot loop: the qubit-position
        # dict (rebuilt by the register property on every access) and
        # the finite-waist amplitude fractions (per qubit and beam
        # axis — constant within a trajectory).
        qubit_coords = {
            qid: tuple(pos.as_array())
            for qid, pos in traj.register.qubits.items()
        }
        waist_cache: dict[tuple, float] = {}
        for ch, ch_samples in self._samples.channel_samples.items():
            _ch_obj = self._samples._ch_objs[ch]
            samples_dict = samples["Local"][_ch_obj.basis]
            # Constant across the channel's slots: hoisted out of
            # the per-slot loop.
            det_fluctuation = _generate_detuning_fluctuations(
                self._noise_model,
                traj.det_fluctuations[ch],
                traj.det_phases[ch],
                np.arange(0, self.samples.max_duration, 1),
            )
            for slot in ch_samples.slots:
                self._apply_slot_noise(
                    traj,
                    slot,
                    samples_dict,
                    _ch_obj.addressing == "Global",
                    amp_fluctuation=traj.amp_fluctuations[ch],
                    det_fluctuation=det_fluctuation,
                    propagation_dir=_ch_obj.propagation_dir,
                    qubit_coords=qubit_coords,
                    waist_cache=waist_cache,
                )

        return self._localized_noisy_samples(traj, samples)

    @property
    def noisy_samples(self) -> Iterator[SamplesWithReps]:
        """The noiseless samples modified by the noise trajectories."""
        for traj, reps in self.noise_trajectories:
            yield SamplesWithReps(
                traj, self._sample_with_trajectory(traj), reps
            )

    # -- Interaction matrices -----------------------------------------------

    def _interaction_matrix(self, register: BaseRegister) -> np.ndarray:
        r"""C6/C3 Interactions between the qudits (in rad/µs).

        Returns:
            The pairwise interaction coefficients. In XY mode, shape
            (2, N, N): the C3 interaction first, then C6. In Rydberg
            mode, shape (1, N, N) with the C6 interaction only.
        """
        # Without register-position noise every trajectory passes the
        # SAME register object — memoize the base matrix so a
        # 100-trajectory draw computes it once, not 100 times.
        if register is self._register:
            cached = getattr(self, "_base_int_matrix", None)
            if cached is not None:
                return cached
            out = self._interaction_matrix_impl(register)
            self._base_int_matrix = out
            return out
        return self._interaction_matrix_impl(register)

    def _interaction_matrix_impl(
        self, register: BaseRegister
    ) -> np.ndarray:
        # Time-dependent effects (the SLM mask) are deliberately absent
        is_xy = self.basis_data.interaction_type == "XY"
        d = _distances(register)
        d_arr = d.as_array(detach=True)
        n = self.n_qudits
        interactions = np.zeros((2 if is_xy else 1,) + d.shape)

        if is_xy:
            positions = list(register.qubits.values())
            assert self.samples._magnetic_field is not None
            assert self._device.interaction_coeff_xy is not None
            mag_arr = np.asarray(self.samples._magnetic_field, dtype=float)
            mag_norm = np.linalg.norm(mag_arr)
            assert mag_norm > 0, "There must be a magnetic field in XY."
            for i in range(n):
                for j in range(i + 1, n):
                    diff = (
                        positions[i].as_array(detach=True)
                        - positions[j].as_array(detach=True)
                    )
                    if len(diff) == 2:
                        diff = np.append(diff, 0.0)
                    cosine = np.dot(diff, mag_arr) / (
                        np.linalg.norm(diff) * mag_norm
                    )
                    interactions[[0, 0], [i, j], [j, i]] = (
                        self._device.interaction_coeff_xy
                        * (1 - 3 * cosine**2)
                        / d_arr[i, j] ** 3
                    )

        iu, ju = np.triu_indices(n, k=1)
        c6_vals = self._device.interaction_coeff / d_arr[iu, ju] ** 6
        interactions[-1, iu, ju] = c6_vals
        interactions[-1, ju, iu] = c6_vals
        return interactions

    def _noisy_interaction_matrix(
        self, register: BaseRegister, bad_atoms: dict
    ) -> pm.AbstractArray:
        r"""Interaction matrix with missing qudits masked out."""
        gone = np.array([bool(value) for value in bad_atoms.values()])
        mask2 = gone.reshape(1, -1) | gone.reshape(-1, 1)
        mat = self._interaction_matrix(register).copy()
        mat[:, mask2] = 0.0
        return pm.AbstractArray(mat)

    @property
    def noisy_interaction_matrices(self) -> list[pm.AbstractArray]:
        """The noisy interaction matrix for each noise trajectory."""
        return [x[0].interaction_matrix for x in self.noise_trajectories]

    # -- Collapse operators ---------------------------------------------------

    def _build_local_collapse_operators(
        self,
        noise_model: NoiseModel,
        basis_name: str,
        eigenbasis: list[States],
        op_matrix: list[str],
    ) -> tuple[
        list[tuple[int | float | complex, str | np.ndarray]],
        dict[str, list[tuple[int | complex, str]]],
    ]:
        local_collapse_ops: list[
            tuple[int | float | complex, str | np.ndarray]
        ] = []
        depolarizing_pauli_2ds: dict[
            str, list[tuple[int | complex, str]]
        ] = {}
        noise_types = noise_model.noise_types

        if "dephasing" in noise_types:
            # Which states dephase, and at which model rate
            for state, rate in (
                ("d", noise_model.dephasing_rate),
                ("r", noise_model.dephasing_rate),
                ("h", noise_model.hyperfine_dephasing_rate),
            ):
                if state not in eigenbasis:
                    continue
                op = f"sigma_{state}{state}"
                assert op in op_matrix
                local_collapse_ops.append((np.sqrt(2 * rate), op))

        if "relaxation" in noise_types:
            if "sigma_gr" not in op_matrix:
                raise ValueError(
                    "'relaxation' noise requires addressing of the"
                    " 'ground-rydberg' basis."
                )
            local_collapse_ops.append(
                (np.sqrt(noise_model.relaxation_rate), "sigma_gr")
            )

        if "depolarizing" in noise_types:
            if "all" in basis_name:
                raise NotImplementedError(
                    "Cannot include depolarizing noise in all-basis."
                )
            # Pauli decomposition over the two lowest-energy states
            # (b, a): each label maps to Σ coeff·|i><j| projector
            # terms. Only meaningful when basis != "all".
            b, a = eigenbasis[:2]
            pauli_spec: tuple = (
                ("x", ((1, a + b), (1, b + a))),
                ("y", ((1j, a + b), (-1j, b + a))),
                ("z", ((1, b + b), (-1, a + a))),
            )
            coeff = np.sqrt(noise_model.depolarizing_rate / 4)
            for label, terms in pauli_spec:
                depolarizing_pauli_2ds[label] = [
                    (w, f"sigma_{states}") for w, states in terms
                ]
                local_collapse_ops.append((coeff, label))

        if "eff_noise" in noise_types:
            basis_dim = len(eigenbasis)
            op_shape = (basis_dim, basis_dim)
            for id_, rate in enumerate(noise_model.eff_noise_rates):
                operator = np.array(
                    noise_model.eff_noise_opers[id_], dtype=complex
                )
                if operator.shape != op_shape:
                    raise ValueError(
                        "Incompatible shape for effective noise operator"
                        f" n°{id_}. Operator {operator} should be of"
                        f" shape {op_shape}."
                    )
                local_collapse_ops.append((np.sqrt(rate), operator))
        return local_collapse_ops, depolarizing_pauli_2ds

    def _check_noise_model(self, noise_model: NoiseModel) -> None:
        """Checks that the provided noise_model is a NoiseModel."""
        if not isinstance(noise_model, NoiseModel):
            raise ValueError(
                f"Object {noise_model} is not a valid `NoiseModel`."
            )
        not_supported = (
            set(noise_model.noise_types)
            - SUPPORTED_NOISES[self.basis_data.interaction_type]
        )
        if not_supported:
            raise NotImplementedError(
                f"Interaction mode '{self.basis_data.interaction_type}' "
                "does not support "
                f"simulation of noise types: {', '.join(not_supported)}."
            )

    @staticmethod
    @functools.cache
    def _finite_waist_amp_fraction(
        coords: tuple[float, ...],
        propagation_dir: tuple[float, float, float],
        laser_waist: float,
    ) -> float:
        """Gaussian-beam amplitude at an atom's off-axis distance.

        Assumes a Rayleigh length much larger than the array, so only
        the perpendicular distance r to the optical axis matters:
        the fraction is exp(−(r/w)²). r² is computed from the
        Pythagorean split ‖p‖² = (p·û)² + r².
        """
        p = np.zeros(3)
        p[: len(coords)] = coords
        axis = np.asarray(propagation_dir, dtype=float)
        along = p @ axis / np.linalg.norm(axis)
        r_sq = max(float(p @ p - along**2), 0.0)
        return float(np.exp(-r_sq / laser_waist**2))

    # -- Trajectory sampling ----------------------------------------------

    def _spam_only_trajectories(
        self, ntrajs: int
    ) -> List[TrajectoryWithReps]:
        """SPAM is the only stochastic noise: dedupe repeated configs.

        Draws ntrajs bad-atom bitstrings from the global RNG (matching
        the reference draw order) and collapses identical configurations
        into a single trajectory with a repetition count.
        """
        initial_configs = Counter(
            "".join(
                (
                    np.random.uniform(size=len(self._qid_index))
                    < self.noise_model.state_prep_error
                )
                .astype(int)
                .astype(str)
            )
            for _ in range(ntrajs)
        ).most_common()

        doppler_detune = {qid: 0.0 for qid in self._qid_index}
        amp_fluctuations: dict[str, float] = {}
        det_fluctuations: dict[str, float] = {}
        det_phases: dict[str, np.ndarray] = {}
        dmm_det_fluctuation: dict[str, float] = {}
        for ch in self._samples.channel_samples:
            assert self.noise_model.amp_sigma == 0.0
            amp_fluctuations[ch] = 1.0
            det_fluctuations[ch] = 0.0
            det_phases[ch] = np.array(0.0)
            dmm_det_fluctuation[ch] = 1.0

        trajectories = []
        for bool_string, n in initial_configs:
            bad_atoms = dict(
                zip(self._qid_index, (x == "1" for x in bool_string))
            )
            trajectories.append(
                TrajectoryWithReps(
                    NoiseTrajectory(
                        bad_atoms,
                        doppler_detune,
                        amp_fluctuations,
                        det_fluctuations,
                        det_phases,
                        self._register,
                        self._noisy_interaction_matrix(
                            self._register, bad_atoms
                        ),
                        dmm_det_fluctuation,
                    ),
                    n,
                )
            )
        return trajectories

    def _draw_one_trajectory(self) -> NoiseTrajectory:
        """Draws every random parameter of one trajectory.

        The draw order (bad atoms, doppler, then per-channel amp/det/
        phases/dmm, then register) matches the reference's global-RNG
        consumption exactly.
        """
        noise_types = self.noise_model.noise_types
        if (
            "SPAM" in noise_types
            and self.noise_model.state_prep_error > 0
        ):
            dist = (
                np.random.uniform(size=len(self._qid_index))
                < self.noise_model.state_prep_error
            )
            bad_atoms = dict(zip(self._qid_index, dist))
        else:
            bad_atoms = {qid: False for qid in self._qid_index}

        if "doppler" in noise_types:
            temp = self.noise_model.temperature * 1e-6
            detune = np.random.normal(
                0, doppler_sigma(temp), size=len(self._qid_index)
            )
            doppler_detune = dict(zip(self._qid_index, detune))
        else:
            doppler_detune = {qid: 0.0 for qid in self._qid_index}

        amp_fluctuations: dict[str, float] = {}
        det_fluctuations: dict[str, float] = {}
        det_phases: dict[str, np.ndarray] = {}
        dmm_det_fluctuation: dict[str, float] = {}
        n_omegas = len(self._noise_model.detuning_hf_omegas)
        for ch in self._samples.channel_samples:
            amp_fluctuations[ch] = max(
                0, np.random.normal(1.0, self.noise_model.amp_sigma)
            )
            det_fluctuations[ch] = (
                np.random.normal(0.0, self.noise_model.detuning_sigma)
                if self.noise_model.detuning_sigma
                else 0.0
            )
            if n_omegas:
                det_phases[ch] = np.random.uniform(
                    0.0, 2 * np.pi, size=n_omegas - 1
                )
            else:
                det_phases[ch] = np.array(0.0)

            if self.noise_model.dmm_sigma and isinstance(
                self._samples._ch_objs[ch], DMM
            ):
                dmm_det_fluctuation[ch] = max(
                    0, np.random.normal(1.0, self.noise_model.dmm_sigma)
                )
            else:
                dmm_det_fluctuation[ch] = 1.0

        register: BaseRegister = self._register
        if "register" in noise_types:
            register = _noisy_register(
                self.register.qubits, self._noise_model
            )
        return NoiseTrajectory(
            bad_atoms,
            doppler_detune,
            amp_fluctuations,
            det_fluctuations,
            det_phases,
            register,
            self._noisy_interaction_matrix(register, bad_atoms),
            dmm_det_fluctuation,
        )

    def _create_noise_trajectories(
        self, ntrajs: int
    ) -> List[TrajectoryWithReps]:
        """Draws the noise random parameters for each trajectory.

        When SPAM isn't in the chosen noises, all atoms are correctly
        prepared. The numpy global-RNG draw order matches the reference
        so that seeded tests reproduce it exactly.
        """
        if not has_shot_to_shot_except_spam(self.noise_model):
            return self._spam_only_trajectories(ntrajs)
        return [
            TrajectoryWithReps(self._draw_one_trajectory(), 1)
            for _ in range(ntrajs)
        ]

    # -- Basis bookkeeping --------------------------------------------------

    def _get_basis_name(self, with_leakage: bool) -> str:
        used = self._samples.used_bases
        if len(used) == 1:
            basis_name = list(used)[0]
        elif len(used) == 0:
            basis_name = "XY" if self._samples._in_xy else "ground-rydberg"
        else:
            basis_name = "all"  # All three rydberg states
        if with_leakage:
            basis_name += "_with_error"
        return basis_name

    def _get_eigenbasis(self, with_leakage: bool) -> list[States]:
        eigenbasis = self._samples.eigenbasis
        if with_leakage:
            eigenbasis.append("x")
        return [state for state in STATES_RANK if state in eigenbasis]

    @staticmethod
    def _get_projectors(
        eigenbasis: list[States],
    ) -> list[str]:
        """Determine projector operator names."""
        return ["I"] + [
            f"sigma_{proj0}{proj1}"
            for proj0 in eigenbasis
            for proj1 in eigenbasis
        ]
