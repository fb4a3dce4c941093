"""Hamiltonian generation from sampled sequences and noise.

Functional counterpart of reference
``pulser-simulation/pulser_simulation/hamiltonian.py:32-439``, with the
QobjEvo replaced by a structural decomposition that the solvers
consume directly:

- a static interaction **diagonal** (Ising: ``Σ_{i<j} U_ij n_i n_j``,
  from ``make_vdw_term``; XY: the C6 ``σ_uu σ_uu`` part), with a masked
  variant for the time-dependent XY SLM case;
- an ``(N, N)`` XY flip-flop coupling matrix (from ``make_xy_term``);
- dense per-basis/per-qudit coefficient streams
  ``a_b,q(t) = 0.5 Ω e^{-iφ}`` and ``δ_b,q(t)`` sampled at the knot
  times (the ``H + H†`` doubling of ``hamiltonian.py:436-439`` is folded
  into the term construction).

``build_operator``/``get_hamiltonian`` keep the reference's inspection
API, returning dense :class:`~pulser_tpu_torch.emulator.qobj.Qobj` instances.
"""

from __future__ import annotations

from typing import Union, cast

import numpy as np

from pulser_tpu_torch.hamiltonian_data import (
    BasisData,
    LindbladData,
    NoiseTrajectory,
)
from pulser_tpu_torch.channels.base_channel import States
from pulser_tpu_torch.emulator.qobj import Qobj, basis as basis_ket, qeye, tensor
from pulser_tpu_torch.register import QubitId
from pulser_tpu_torch.register.base_register import BaseRegister
from pulser_tpu_torch.sampler.samples import SequenceSamples

#: Recent interaction diagonals keyed by coupling-matrix bytes (see
#: Hamiltonian._interaction_diag) — insertion-ordered, max 8 entries.
_int_diag_cache: dict = {}

# Which (bra, ket, detuning) eigenstates each basis' drive addresses,
# mirroring build_coeffs_ops (reference hamiltonian.py:333-389).
_DRIVE_STATES: dict[str, tuple[str, str, str]] = {
    # basis: (sigma_ij "i", sigma_ij "j", detuning diagonal state)
    "ground-rydberg": ("g", "r", "r"),
    "digital": ("h", "g", "g"),
    "XY": ("u", "d", "d"),
}


class Hamiltonian:
    r"""Generates a structured Hamiltonian from samples and noise.

    Args:
        samples: A sampled sequence whose ChannelSamples have the same
            duration.
        noise_trajectory: The noise trajectory to apply.
        basis_data: The simulation basis specification.
        lindblad_data: The collapse-operator specification.
        sampling_rate: The fraction of samples to extract for the
            simulation (between 0.05 and 1.0).
    """

    def __init__(
        self,
        samples: SequenceSamples,
        noise_trajectory: NoiseTrajectory,
        basis_data: BasisData,
        lindblad_data: LindbladData,
        sampling_rate: float,
    ) -> None:
        """Instantiates a Hamiltonian object."""
        self.samples = samples
        self.noise_trajectory = noise_trajectory
        self._sampling_rate = sampling_rate
        self._qid_index = {
            qid: i for i, qid in enumerate(self._register.qubits)
        }
        self.basis_data = basis_data
        self.lindblad_data = lindblad_data

        self.op_matrix: dict[str, Qobj]
        self.basis: dict[States, Qobj]

        # Compute sampling times (µs)
        self._duration = self.samples.max_duration
        self.sampling_times = self._adapt_to_sampling_rate(
            np.arange(self._duration, dtype=np.double) / 1000
        )

        # Local (d×d) collapse matrices consumed by the solvers
        self._local_collapse_mats: list[np.ndarray] = []

        self._set_config()

    @property
    def _register(self) -> BaseRegister:
        return self.noise_trajectory.register

    @property
    def n_qudits(self) -> int:
        """Number of qudits in the Register."""
        return len(self._register.qubit_ids)

    @property
    def dim(self) -> int:
        """The per-qudit Hilbert-space dimension."""
        return self.basis_data.dim

    def _adapt_to_sampling_rate(
        self, full_array: np.ndarray
    ) -> np.ndarray:
        """Downsamples an array according to the sampling rate."""
        indices = np.linspace(
            0,
            len(full_array) - 1,
            int(self._sampling_rate * self._duration),
            dtype=int,
        )
        return full_array[indices]

    def _set_config(self) -> None:
        basis, op_matrix = self._get_basis_op_matrices(
            self.basis_data.eigenbasis
        )
        self.basis = basis
        self.op_matrix = op_matrix
        assert set(self.lindblad_data.op_matrix_names) == set(
            self.op_matrix.keys()
        )
        self._build_collapse_operators()
        self._construct_hamiltonian()

    @staticmethod
    def _get_basis_op_matrices(
        eigenbasis: list[States],
    ) -> tuple[dict[States, Qobj], dict[str, Qobj]]:
        """Determines basis kets and projector operators."""
        dim = len(eigenbasis)
        basis = {b: basis_ket(dim, i) for i, b in enumerate(eigenbasis)}
        op_matrix = {"I": qeye(dim)}
        for proj0 in eigenbasis:
            for proj1 in eigenbasis:
                proj_name = "sigma_" + proj0 + proj1
                op_matrix[proj_name] = basis[proj0] @ basis[proj1].dag()
        return basis, op_matrix

    def _local_collapse_matrix(
        self, coeff: complex, collapse_op: Union[str, np.ndarray]
    ) -> np.ndarray:
        """Resolves a LindbladData entry to a dense d×d matrix."""
        if isinstance(collapse_op, str):
            if collapse_op not in self.op_matrix:
                # Depolarizing Pauli label: expand it
                mat = sum(
                    proj_coeff * self.op_matrix[proj_op].full()
                    for (
                        proj_coeff,
                        proj_op,
                    ) in self.lindblad_data.depolarizing_pauli_2ds[
                        collapse_op
                    ]
                )
                return np.asarray(coeff * mat)
            return coeff * self.op_matrix[collapse_op].full()
        return np.asarray(coeff * np.asarray(collapse_op, dtype=complex))

    def _build_collapse_operators(self) -> None:
        """Builds the local (d×d) collapse matrices."""
        self._local_collapse_mats = [
            self._local_collapse_matrix(coeff, op)
            for coeff, op in self.lindblad_data.local_collapse_ops
        ]

    @property
    def _collapse_ops(self) -> list[Qobj]:
        """Full multi-qudit embeddings of the collapse operators.

        The solvers consume the local (d×d) matrices directly and
        apply them axis-wise, so these dense ``dim×dim`` embeddings —
        built with n_ops·n kron products — are only materialized on
        demand (building them per noise trajectory used to dominate
        the noisy-run host time, ~7x the actual device solve).
        """
        return [
            self._build_operator(
                [(Qobj(mat), [qid])], self.op_matrix
            )
            for mat in self._local_collapse_mats
            for qid in self._register.qubit_ids
        ]

    def _build_operator(
        self, operations: Union[list, tuple], op_matrix: dict[str, Qobj]
    ) -> Qobj:
        """Tensor-product operator assembler (dense).

        ``[(op, qubits)]`` applies op on the given qubits and identity
        elsewhere; ``(op, 'global')`` sums the single-qubit embeddings.
        """
        op_list = [op_matrix["I"] for _ in range(self.n_qudits)]

        if not isinstance(operations, list):
            operations = [operations]

        for operator, qubits in operations:
            if qubits == "global":
                return cast(
                    Qobj,
                    sum(
                        self._build_operator(
                            [(operator, [q_id])], op_matrix
                        )
                        for q_id in self._register.qubits
                    ),
                )
            else:
                qubits_set = set(qubits)
                if len(qubits_set) < len(qubits):
                    raise ValueError(
                        "Duplicate atom ids in argument list."
                    )
                if not qubits_set.issubset(
                    self._register.qubits.keys()
                ):
                    v = qubits_set
                    v -= self._register.qubits.keys()
                    raise ValueError(f"Invalid qubit names: {v}")
                if isinstance(operator, str):
                    try:
                        operator = self.op_matrix[operator]
                    except KeyError:
                        raise ValueError(
                            f"{operator} is not a valid operator"
                        )
                elif not isinstance(operator, Qobj):
                    operator = Qobj(np.asarray(operator))
                for qubit in qubits:
                    k = self._qid_index[qubit]
                    op_list[k] = operator
        return tensor(op_list)

    def build_operator(self, operations: Union[list, tuple]) -> Qobj:
        """Creates an operator with non-trivial actions on some qubits.

        Takes a list of tuples ``[(operator_1, qubits_1), ...]`` and
        returns the tensor product of each operator applied on its
        qubits with identity on the rest. ``(operator, 'global')``
        returns the sum over all single-qubit embeddings.
        """
        return self._build_operator(operations, self.op_matrix)

    # ------------------------------------------------------------------
    # Structural construction (solver inputs)
    # ------------------------------------------------------------------

    def _state_index(self, state: str) -> int:
        return self.basis_data.eigenbasis.index(state)

    def _occupancy_diag(self, state: str) -> np.ndarray:
        """Per-basis-state occupancy of `state` on each qudit.

        Returns ``(N, dim_total)`` with entry [q, x] = 1 if qudit q is in
        `state` for the global basis index x.
        """
        d = self.dim
        n = self.n_qudits
        idx = self._state_index(state)
        occ = np.zeros((n, d**n))
        ar = np.arange(d**n)
        for q in range(n):
            digits = (ar // (d ** (n - q - 1))) % d
            occ[q] = digits == idx
        return occ

    def _interaction_diag(
        self, u_mat: np.ndarray, state: str, skip: set[QubitId]
    ) -> np.ndarray:
        """Cached front end of :meth:`_interaction_diag_impl`.

        Noise-trajectory batches rebuild one Hamiltonian per
        trajectory, but absent register-position noise every
        trajectory shares the SAME interaction matrix — memoize the
        O(d^N) diagonal on its bytes (a few recent entries, skipped
        above 2^22 where one entry is tens of MB and batches are
        single-trajectory anyway).
        """
        u_arr = np.ascontiguousarray(np.asarray(u_mat, np.float64))
        if u_arr.size and self.dim**self.n_qudits <= 1 << 22:
            # Key on POSITIONS, not labels: the impl maps `skip`
            # through this Hamiltonian's qubit-id -> index table and
            # `state` through its eigenbasis, either of which may
            # differ between Hamiltonians with byte-identical
            # coupling matrices.
            key = (
                u_arr.tobytes(),
                self._state_index(state),
                frozenset(self._qid_index[q] for q in skip),
                self.dim,
                self.n_qudits,
            )
            hit = _int_diag_cache.get(key)
            if hit is None:
                hit = self._interaction_diag_impl(u_arr, state, skip)
                _int_diag_cache[key] = hit
                while len(_int_diag_cache) > 8:
                    _int_diag_cache.pop(
                        next(iter(_int_diag_cache))
                    )
            return hit.copy()
        return self._interaction_diag_impl(u_arr, state, skip)

    def _interaction_diag_impl(
        self, u_mat: np.ndarray, state: str, skip: set[QubitId]
    ) -> np.ndarray:
        """Builds ``Σ_{i<j} U_ij occ_i occ_j`` as a dense diagonal.

        Works in fixed-size chunks of the ``d**n`` axis so the peak
        footprint stays at ~``n`` MB regardless of the system size (a
        materialized ``(n, d**n)`` occupancy table is 6.7 GB at 25
        qubits), with the pair sum as one ``(n, n) @ (n, chunk)``
        matmul per chunk.

        Args:
            u_mat: (N, N) symmetric couplings.
            state: The occupied eigenstate ('r' for Ising, 'u' for XY).
            skip: Qubits whose pairs are excluded (SLM-masked).
        """
        d = self.dim
        n = self.n_qudits
        dim = d**n
        idx = self._state_index(state)
        skip_idx = [self._qid_index[q] for q in skip]
        u = np.asarray(u_mat, dtype=np.float64).copy()
        np.fill_diagonal(u, 0.0)
        u[skip_idx, :] = 0.0
        u[:, skip_idx] = 0.0

        # Split qubits into the leading n_high (block index) and the
        # trailing n_low (within-block index). The quadratic form
        # splits as low-low (block-independent, computed ONCE) +
        # high-low (a precomputed (n_high, low_dim) cross term dotted
        # with each block's digit vector) + high-high (a scalar per
        # block) — total cost O(n^2 * d^n_low + d^n), instead of a
        # (n, d^n) occupancy table.
        n_low = min(n, 20)
        n_high = n - n_low
        low_dim = d**n_low
        ar = np.arange(low_dim)
        shifts_low = d ** (n_low - 1 - np.arange(n_low))
        b_l = (
            (ar[None, :] // shifts_low[:, None]) % d == idx
        ).astype(np.float64)  # (n_low, low_dim)
        u_ll = u[n_high:, n_high:]
        u_hl = u[:n_high, n_high:]
        u_hh = u[:n_high, :n_high]
        base = 0.5 * np.einsum("qD,qD->D", b_l, u_ll @ b_l)
        cross = u_hl @ b_l if n_high else None  # (n_high, low_dim)

        if n_high == 0:
            return base
        diag = np.empty(dim)
        shifts_high = d ** (n_high - 1 - np.arange(n_high))
        for blk in range(d**n_high):
            h = ((blk // shifts_high) % d == idx).astype(np.float64)
            const = 0.5 * float(h @ u_hh @ h)
            diag[blk * low_dim : (blk + 1) * low_dim] = (
                base + h @ cross + const
            )
        return diag

    def _xy_coupling_matrix(
        self, u_mat: np.ndarray, skip: set[QubitId]
    ) -> np.ndarray:
        """The (N, N) flip-flop coupling matrix, with masked pairs zeroed."""
        out = np.array(u_mat, dtype=float)
        np.fill_diagonal(out, 0.0)
        skip_idx = [self._qid_index[q] for q in skip]
        out[skip_idx, :] = 0.0
        out[:, skip_idx] = 0.0
        return out

    def _construct_hamiltonian(self) -> None:
        """Builds the solver-ready structural representation.

        Produces:
        - ``self.pairs``: static (i, j, k) triples per addressed basis;
        - ``self.amp_coeffs``/``self.det_coeffs``: (n_bases, N, n_knots);
        - ``self.int_diag``: (dim,) or (2, dim) [unmasked, masked];
        - ``self.xy_mat``: None or (1|2, N, N);
        - ``self.int_w``: None or (2, n_knots) interpolation weights.
        """
        n = self.n_qudits
        d = self.dim
        n_knots = len(self.sampling_times)
        imat = self.noise_trajectory.interaction_matrix.as_array(
            detach=True
        )
        bad_atoms = self.noise_trajectory.bad_atoms
        effective_size = n - sum(bad_atoms.values())
        is_xy = self.basis_data.interaction_type == "XY"

        # --- interaction terms ---
        self.xy_mat: np.ndarray | None = None
        self.xy_indices: tuple[int, int] | None = None
        self.int_w: np.ndarray | None = None
        #: Largest single-qudit-flip interaction energy gap (rad/µs):
        #: max over atoms of the row sum of |U|. In the interaction
        #: picture this (plus the detuning) is the fastest oscillation
        #: the rotated drive term carries, which bounds how far the
        #: integration step may be coarsened beyond the coefficient
        #: grid (see simulation._run_solver).
        self.max_flip_gap: float = 0.0
        dim_total = d**n
        int_diag = np.zeros(dim_total)
        if (
            "digital" not in self.basis_data.basis_name
            and effective_size > 1
        ):
            slm_end = self.samples._slm_mask.end
            masked_qubits = (
                set(self.samples._slm_mask.targets) if is_xy else set()
            )
            if is_xy:
                self.xy_indices = (
                    self._state_index("u"),
                    self._state_index("d"),
                )
                full_xy = self._xy_coupling_matrix(imat[0], set())
                full_diag = self._interaction_diag(imat[1], "u", set())
                if slm_end > 0 and masked_qubits:
                    masked_xy = self._xy_coupling_matrix(
                        imat[0], masked_qubits
                    )
                    masked_diag = self._interaction_diag(
                        imat[1], "u", masked_qubits
                    )
                    if effective_size - len(
                        masked_qubits - {q for q, b in bad_atoms.items() if b}
                    ) < 2:
                        masked_xy = np.zeros_like(masked_xy)
                        masked_diag = np.zeros_like(masked_diag)
                    self.xy_mat = np.stack([full_xy, masked_xy])
                    self.int_diag = np.stack([full_diag, masked_diag])
                    # weight streams on the sampling knots (w_unmasked,
                    # w_masked); matches the binary coefficient arrays
                    # of reference hamiltonian.py:399-422
                    coeff = np.ones(self._duration - 1)
                    coeff[0:slm_end] = 0
                    w_un = self._adapt_to_sampling_rate_clipped(
                        coeff, n_knots
                    )
                    self.int_w = np.stack([w_un, 1.0 - w_un])
                else:
                    self.xy_mat = full_xy[None]
                    self.int_diag = full_diag
            else:
                self.int_diag = self._interaction_diag(
                    imat[-1], "r", set()
                )
            self.max_flip_gap = float(
                np.max(np.sum(np.abs(imat[-1]), axis=1))
            )
        else:
            self.int_diag = int_diag

        # --- drive terms ---
        nested = getattr(self.samples, "_nested_dict_hint", None)
        if nested is None:
            nested = self.samples.to_nested_dict()
        bases_present = []
        for addr in ("Global", "Local"):
            for b in nested.get(addr, {}):
                if b not in bases_present and nested[addr][b]:
                    bases_present.append(b)
        # Deterministic order
        bases_present.sort(
            key=lambda b: list(_DRIVE_STATES.keys()).index(b)
        )
        self.bases = bases_present

        amp_full = np.zeros(
            (len(bases_present), n, self._duration), dtype=complex
        )
        det_full = np.zeros((len(bases_present), n, self._duration))
        for bi, b in enumerate(bases_present):
            g = nested.get("Global", {}).get(b)
            if g is not None:
                a = 0.5 * g["amp"] * np.exp(-1j * g["phase"])
                amp_full[bi, :, :] += a[None, :]
                det_full[bi, :, :] += (0.5 * g["det"])[None, :]
            loc = nested.get("Local", {}).get(b, {})
            for qid, qsamples in loc.items():
                qi = self._qid_index[qid]
                amp_full[bi, qi, :] += (
                    0.5
                    * qsamples["amp"]
                    * np.exp(-1j * qsamples["phase"])
                )
                det_full[bi, qi, :] += 0.5 * qsamples["det"]
        # The H + H† doubling is applied in the solver's term
        # construction for the amp part (a + conj transpose) and here
        # for the detuning (−0.5δ + h.c. = −δ on the diagonal).
        det_full *= 2.0

        # Resolve drive states to eigenbasis indices only where their
        # coefficient is nonzero — the reference builds each sigma_ab
        # operator lazily (hamiltonian.py:354-389), so e.g. a digital
        # detuning with zero amplitude runs fine in the 2-level
        # ground-rydberg basis (only sigma_gg is needed).
        eigen = self.basis_data.eigenbasis
        pairs = []
        for bi, b in enumerate(bases_present):
            si, sj, sk = _DRIVE_STATES[b]
            if si in eigen and sj in eigen:
                ii, jj = eigen.index(si), eigen.index(sj)
            elif not np.any(amp_full[bi]):
                ii = jj = 0  # inert: coefficient identically zero
            else:
                raise ValueError(
                    f"sigma_{si}{sj} is not a valid operator"
                )
            if sk in eigen:
                kk = eigen.index(sk)
            elif not np.any(det_full[bi]):
                kk = 0
            else:
                raise ValueError(
                    f"sigma_{sk}{sk} is not a valid operator"
                )
            pairs.append((ii, jj, kk))

        self.pairs = tuple(pairs)
        self.amp_coeffs = self._adapt_last_axis(amp_full)
        self.det_coeffs = self._adapt_last_axis(det_full)

    def _adapt_last_axis(self, arr: np.ndarray) -> np.ndarray:
        indices = np.linspace(
            0,
            self._duration - 1,
            int(self._sampling_rate * self._duration),
            dtype=int,
        )
        return arr[..., indices]

    def _adapt_to_sampling_rate_clipped(
        self, arr: np.ndarray, n_knots: int
    ) -> np.ndarray:
        """Downsamples a (duration-1,)-long array onto the knot count."""
        indices = np.linspace(
            0, len(arr) - 1, n_knots, dtype=int
        )
        return arr[indices]

    # ------------------------------------------------------------------
    # Dense inspection API
    # ------------------------------------------------------------------

    def _coeffs_at(self, t: float) -> tuple[np.ndarray, np.ndarray]:
        """Linear interpolation of the coefficient streams at t (µs)."""
        knots = self.sampling_times
        if len(knots) == 1:
            return self.amp_coeffs[..., 0], self.det_coeffs[..., 0]
        idx = int(
            np.clip(
                np.searchsorted(knots, t, side="right") - 1,
                0,
                len(knots) - 2,
            )
        )
        t0, t1 = knots[idx], knots[idx + 1]
        frac = np.clip((t - t0) / (t1 - t0), 0.0, 1.0)
        amp = (
            self.amp_coeffs[..., idx] * (1 - frac)
            + self.amp_coeffs[..., idx + 1] * frac
        )
        det = (
            self.det_coeffs[..., idx] * (1 - frac)
            + self.det_coeffs[..., idx + 1] * frac
        )
        return amp, det

    def _int_weights_at(self, t: float) -> np.ndarray:
        assert self.int_w is not None
        knots = self.sampling_times
        idx = int(
            np.clip(
                np.searchsorted(knots, t, side="right") - 1,
                0,
                len(knots) - 2,
            )
        )
        t0, t1 = knots[idx], knots[idx + 1]
        frac = np.clip((t - t0) / (t1 - t0), 0.0, 1.0)
        return (
            self.int_w[:, idx] * (1 - frac)
            + self.int_w[:, idx + 1] * frac
        )

    def get_matrix(self, t: float) -> np.ndarray:
        """The dense Hamiltonian matrix at time t (in µs), in rad/µs."""
        n, d = self.n_qudits, self.dim
        dim_total = d**n
        amp, det = self._coeffs_at(t)

        if self.int_diag.ndim == 2:
            w = self._int_weights_at(t)
            diag = w @ self.int_diag
        else:
            diag = self.int_diag
        h = np.diag(diag.astype(complex))

        # per-qudit drives
        for bi, (i, j, k) in enumerate(self.pairs):
            for q in range(n):
                m = np.zeros((d, d), dtype=complex)
                m[i, j] += amp[bi, q]
                m[j, i] += np.conj(amp[bi, q])
                m[k, k] += -det[bi, q]
                h += self._embed(m, q)

        # XY flip-flop
        if self.xy_mat is not None:
            assert self.xy_indices is not None
            if self.xy_mat.shape[0] == 2:
                w = self._int_weights_at(t)
                u = np.tensordot(w, self.xy_mat, axes=1)
            else:
                u = self.xy_mat[0]
            up, down = self.xy_indices
            s_ud = np.zeros((d, d), dtype=complex)
            s_ud[up, down] = 1.0
            s_du = s_ud.T.copy()
            for i in range(n):
                for j in range(n):
                    if i != j and u[i, j]:
                        h += u[i, j] * (
                            self._embed(s_ud, i) @ self._embed(s_du, j)
                        )
        assert h.shape == (dim_total, dim_total)
        return h

    def _embed(self, op: np.ndarray, q: int) -> np.ndarray:
        """Embeds a d×d operator at qudit q (dense Kronecker product)."""
        d, n = self.dim, self.n_qudits
        left = np.eye(d**q)
        right = np.eye(d ** (n - q - 1))
        return np.kron(np.kron(left, op), right)

    def _hamiltonian(self, t: float) -> Qobj:
        """The Hamiltonian at time t (in µs) as a dense Qobj."""
        n, d = self.n_qudits, self.dim
        return Qobj(
            self.get_matrix(t), dims=[[d] * n, [d] * n]
        )
