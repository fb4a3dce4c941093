"""A Result subclass for simulation runs returning quantum states.

Behavioral parity with reference
``pulser-simulation/pulser_simulation/qutip_result.py:31-243``,
including the r-first bitstring-ordering quirk of the ground-rydberg
basis and the dim-3/4 marginalization rules. The marginalization here
is a per-axis tensor contraction (O(n·d^n)) instead of the
reference's loop over all 2^n bitstrings with fancy indexing, and
basis-state eliminations use vectorized digit arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import cast

import numpy as np

from pulser_tpu_torch.channels.base_channel import (
    EIGENSTATES,
    States,
    get_states_from_bases,
)
from pulser_tpu_torch.emulator.qobj import Qobj
from pulser_tpu_torch.result import Result

#: The state counted as '1' in each measurement basis.
_ONE_STATE: dict[str, States] = {
    "ground-rydberg": "r",
    "digital": "h",
    "XY": "d",
}


def _digits(dim: int, size: int) -> np.ndarray:
    """``(size, dim**size)`` base-``dim`` digit table of all indices."""
    idx = np.arange(dim**size)
    strides = dim ** (size - 1 - np.arange(size))
    return (idx[None, :] // strides[:, None]) % dim


@dataclass
class TorchResult(Result):
    """Represents the result of a run as a dense state.

    Args:
        atom_order: The order of the atoms in the bitstrings that
            represent the measured states.
        meas_basis: The measurement basis.
        state: The Qobj representing the state (statevector or density
            matrix).
        matching_meas_basis: Whether the measurement basis is the same
            as the state's basis.
    """

    state: Qobj
    matching_meas_basis: bool
    evaluation_time: float = 1.0

    @property
    def sampling_errors(self) -> dict[str, float]:
        """The sampling error associated to each bitstring's rate."""
        return {bitstr: 0.0 for bitstr in self.sampling_dist}

    @property
    def _dim(self) -> int:
        full_state_size = np.prod(self.state.shape)
        if not self.state.isket:
            full_state_size = np.sqrt(full_state_size)
        return cast(
            int,
            np.rint(full_state_size ** (1 / self._size)).astype(int),
        )

    @property
    def _basis_name(self) -> str:
        """Resolves the state's basis from (mode, dim, matching).

        The decision mirrors the reference's case analysis
        (``qutip_result.py:101-158``): XY only comes in dim 2/3;
        Ising dim 4 is the full error basis; Ising dim 3 is either
        the measured basis + error level (when the bases match) or
        'all'; Ising dim 2 flips basis when they don't match.
        """
        dim, matching = self._dim, self.matching_meas_basis
        if self.meas_basis == "XY":
            assert dim in (2, 3), (
                "In XY, state's dimension can only be 2 or 3, not"
                f" {dim}."
            )
            return "XY_with_error" if dim == 3 else "XY"
        assert dim in (2, 3, 4), (
            f"In Ising, state's dimension can be 2, 3 or 4, not"
            f" {dim}."
        )
        resolve = {
            4: lambda: "all_with_error",
            3: lambda: (
                self.meas_basis + "_with_error" if matching else "all"
            ),
            2: lambda: (
                self.meas_basis
                if matching
                else (
                    "digital"
                    if self.meas_basis == "ground-rydberg"
                    else "ground-rydberg"
                )
            ),
        }
        return resolve[dim]()

    @property
    def _eigenbasis(self) -> list[States]:
        basis, with_error, _ = self._basis_name.partition(
            "_with_error"
        )
        states = get_states_from_bases(
            ["ground-rydberg", "digital"]
            if basis == "all"
            else [basis]
        )
        return states + (["x"] if with_error else [])

    def _state_probs(self) -> np.ndarray:
        if not self.state.isket:
            return np.abs(self.state.diag())
        return (np.abs(np.asarray(self.state)) ** 2).reshape(-1)

    def _weights(self) -> np.ndarray:
        size = self._size
        dim = self._dim
        probs = self._state_probs()

        if dim == 2:
            if not self.matching_meas_basis:
                # Only 000...000 is measured
                weights = np.zeros(probs.size)
                weights[0] = 1.0
            elif self.meas_basis == "ground-rydberg":
                # Statevector ordered with r first, e.g. n=2:
                # [rr, rg, gr, gg] -> [11, 10, 01, 00]; inverting
                # gives the canonical [00, 01, 10, 11] order.
                weights = probs[::-1]
            else:
                weights = probs
        elif dim in (3, 4):
            if self.meas_basis not in _ONE_STATE:
                raise RuntimeError(
                    f"Unknown measurement basis '{self.meas_basis}'."
                )
            one_idx = self._eigenbasis.index(
                _ONE_STATE[self.meas_basis]
            )
            # Collapse each qudit axis to its binary outcome: row 1
            # keeps the 'one' state, row 0 sums everything else
            collapse = np.zeros((2, dim))
            collapse[1, one_idx] = 1.0
            collapse[0] = 1.0 - collapse[1]
            w = probs.reshape([dim] * size)
            for axis in range(size):
                w = np.moveaxis(
                    np.tensordot(collapse, w, axes=(1, axis)),
                    0,
                    axis,
                )
            weights = w.reshape(-1)
        else:
            raise NotImplementedError(
                "Cannot sample system with single-atom state vectors "
                "of dimension > 4."
            )
        # Takes care of numerical artefacts in case sum(weights) != 1;
        # the sum stays sequential (left to right, as Python's ``sum``):
        # a pairwise or exact sum gives other bits, and other shots
        return cast(np.ndarray, weights / np.add.accumulate(weights)[-1])

    def _eliminated_indices(
        self, ex_state_idx: list[int]
    ) -> np.ndarray:
        """Flat indices whose base-d digits touch an excluded state."""
        digits = _digits(self._dim, self._size)
        return np.where(np.isin(digits, ex_state_idx).any(axis=0))[0]

    def get_state(
        self,
        reduce_to_basis: str | None = None,
        ignore_global_phase: bool = True,
        tol: float = 1e-6,
        normalize: bool = True,
    ) -> Qobj:
        """Gets the state with some optional post-processing.

        Args:
            reduce_to_basis: Reduces the full state vector to the given
                basis ("ground-rydberg", "digital" or "XY"), if the
                population of the eliminated states is negligible.
            ignore_global_phase: If True and the state is a vector,
                changes the global phase so the largest term is real.
            tol: Maximum allowed population of each eliminated state.
            normalize: Whether to normalize the reduced state.

        Returns:
            The resulting state.

        Raises:
            TypeError: If trying to reduce to a basis that would
                eliminate states with significant occupation.
        """
        state = Qobj(self.state.full(), dims=self.state.dims)
        is_density_matrix = state.isoper and not state.isket
        if ignore_global_phase and not is_density_matrix:
            full = state.full()
            global_ph = float(
                np.angle(full[np.argmax(np.abs(full))])[0]
            )
            state = state * np.exp(-1j * global_ph)
        if self._dim == 2:
            if reduce_to_basis not in [None, self._basis_name]:
                raise TypeError(
                    f"Can't reduce a system in {self._basis_name}"
                    + f" to the {reduce_to_basis} basis."
                )
            return state.tidyup()
        if reduce_to_basis is None:
            return state.tidyup()

        if is_density_matrix:
            raise NotImplementedError(
                "Reduce to basis not implemented for density matrix"
                " states."
            )
        if reduce_to_basis not in EIGENSTATES:
            raise ValueError(
                "'reduce_to_basis' must be 'ground-rydberg', "
                f"'XY', or 'digital', not '{reduce_to_basis}'."
            )
        basis_states = set(self._eigenbasis)
        target_states = set(EIGENSTATES[reduce_to_basis])
        if not target_states.issubset(basis_states):
            raise ValueError(
                f"Can't reduce a state expressed in"
                f" {self._basis_name} into {reduce_to_basis}"
            )
        ex_inds = self._eliminated_indices(
            [
                self._eigenbasis.index(s)
                for s in basis_states - target_states
            ]
        )
        state_arr = state.full()
        ex_probs = np.abs(state_arr[ex_inds]) ** 2
        if not np.all(np.isclose(ex_probs, 0, atol=tol)):
            raise TypeError(
                "Can't reduce to chosen basis because the population"
                " of a state to eliminate is above the allowed"
                " tolerance."
            )
        mask = np.ones_like(state_arr, dtype=bool)
        mask[ex_inds] = False
        state = Qobj(state_arr[mask])
        if normalize:
            state.unit(inplace=True)
        return state.tidyup()


# Drop-in alias matching the reference class name
QutipResult = TorchResult
