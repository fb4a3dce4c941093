"""Containers for processing the results of a simulation.

Behavioral parity with reference
``pulser-simulation/pulser_simulation/simresults.py:38-568``, over
dense numpy states instead of qutip objects. Only the coherent
(noiseless) results are ported; ``NoisyResults``, the pseudo-density
expectation path, SPAM measurement errors and plotting wait for the
noisy leg (see ROADMAP.md).
"""

from __future__ import annotations

import collections.abc
import typing
from abc import ABC, abstractmethod
from collections import Counter
from typing import Optional, TypeVar, Union, cast

import numpy as np
from numpy.typing import ArrayLike

from pulser_tpu_torch.backend.results import ResultsSequence
from pulser_tpu_torch.emulator.qobj import Qobj
from pulser_tpu_torch.emulator.sim_result import TorchResult

ResultType = TypeVar("ResultType", bound=TorchResult)


class SimulationResults(ABC, ResultsSequence[ResultType]):
    """Results of a simulation run of a pulse sequence.

    Parent class of CoherentResults. Contains methods for studying the
    states and extracting useful information.
    """

    def __init__(
        self, size: int, basis_name: str, sim_times: np.ndarray
    ) -> None:
        """Initializes a new SimulationResults instance.

        Args:
            size: The number of atoms in the register.
            basis_name: The basis indicating the addressed atoms
                ('ground-rydberg', 'digital', 'all', 'XY' or one of
                those with the suffix "_with_error").
            sim_times: Array of times (in µs) when simulation results
                are returned.
        """
        self._size = size
        bases = ["ground-rydberg", "digital", "all", "XY"]
        bases += [basis + "_with_error" for basis in bases]
        if basis_name not in bases:
            raise ValueError(f"`basis_name` must be in {bases}")
        self._basis_name = basis_name
        self._dim = 3 if self._basis_name == "all" else 2
        if "_with_error" in self._basis_name:
            self._dim += 1
        self._sim_times = sim_times

    @property
    @abstractmethod
    def states(self) -> list[Qobj]:
        """Lists states of the system at simulation times."""

    @abstractmethod
    def get_state(self, t: float) -> Qobj:
        """Returns the state of the system at time t."""

    @abstractmethod
    def get_final_state(self) -> Qobj:
        """Returns the final state of the system."""

    def expect(
        self,
        obs_list: collections.abc.Sequence[Union[Qobj, ArrayLike]],
    ) -> list[Union[float, complex, ArrayLike]]:
        """Returns the expectation values of operators in obs_list.

        Args:
            obs_list: Input observable list. ArrayLike objects are
                converted to dense operators.

        Returns:
            Expectation values of obs_list.
        """
        if not isinstance(obs_list, (list, np.ndarray)):
            raise TypeError("`obs_list` must be a list of operators.")

        obs_arrs = []
        dim = self._dim
        legal_shape = (dim**self._size, dim**self._size)
        for obs in obs_list:
            if not (
                isinstance(obs, np.ndarray) or isinstance(obs, Qobj)
            ):
                raise TypeError(
                    f"Incompatible type {type(obs)} of "
                    + "observable. Type must be ArrayLike or "
                    + "Qobj."
                )
            if obs.shape != legal_shape:
                raise ValueError(
                    "Incompatible shape of observable."
                    + f"Expected {legal_shape}, got {obs.shape}."
                )
            obs_arr = np.asarray(
                obs.full() if isinstance(obs, Qobj) else obs
            )
            obs_arrs.append(obs_arr)
        states = self.states

        out = []
        for obs_arr in obs_arrs:
            vals = []
            for st in states:
                arr = st.full()
                if st.isket:
                    v = complex(
                        (arr.conj().T @ obs_arr @ arr)[0, 0]
                    )
                else:
                    v = complex(np.trace(obs_arr @ arr))
                # Real observables produce real expectation values
                is_herm = np.allclose(obs_arr, obs_arr.conj().T)
                vals.append(v.real if is_herm else v)
            out.append(np.array(vals))
        return cast(list, out)

    def sample_state(
        self, t: float, n_samples: int = 1000, t_tol: float = 1.0e-3
    ) -> Counter:
        """Returns the result of multiple measurements at time t.

        Args:
            t: Time at which the state is sampled (in µs).
            n_samples: Number of samples to return.
            t_tol: Tolerance on the difference between t and the
                closest simulation time.

        Returns:
            Sample distribution of bitstrings at time t.
        """
        t_index = self._get_index_from_time(t, t_tol)
        return self[t_index].get_samples(n_samples)

    def sample_final_state(self, N_samples: int = 1000) -> Counter:
        """The result of multiple measurements of the final state."""
        return self.sample_state(self._sim_times[-1], N_samples)

    def _get_index_from_time(
        self, t_float: float, tol: float = 1.0e-3
    ) -> int:
        """The closest index corresponding to time t_float (in µs)."""
        try:
            return int(
                np.where(abs(t_float - self._sim_times) < tol)[0][0]
            )
        except IndexError:
            raise IndexError(
                f"Given time {t_float} is absent from simulation times"
                + f" within tolerance {tol}."
            )


class CoherentResults(SimulationResults[TorchResult]):
    """Results of a coherent simulation run of a pulse sequence."""

    def __init__(
        self,
        run_output: typing.Sequence[TorchResult],
        size: int,
        basis_name: str,
        sim_times: np.ndarray,
        meas_basis: str,
    ) -> None:
        """Initializes a new CoherentResults instance.

        Args:
            run_output: The states at each evaluation time.
            size: The number of atoms in the register.
            basis_name: The basis indicating the addressed atoms.
            sim_times: Times at which results were returned.
            meas_basis: The basis in which sampling measurements are
                performed ("ground-rydberg" or "digital").
        """
        super().__init__(size, basis_name, sim_times)
        self._check_meas_basis(meas_basis)
        self._meas_basis = meas_basis
        self._results_seq = tuple(run_output)

    def _check_meas_basis(self, meas_basis: str) -> None:
        """The measurement basis allowed by the state's basis.

        An 'all'-basis state measures in either single basis; any
        other basis fixes the measurement basis to itself (minus the
        error level).
        """
        if "all" in self._basis_name:
            if meas_basis not in {"ground-rydberg", "digital"}:
                raise ValueError(
                    "`meas_basis` must be 'ground-rydberg' or"
                    " 'digital'."
                )
            return
        expected = self._basis_name.replace("_with_error", "")
        if meas_basis != expected:
            raise ValueError(
                f"`meas_basis` associated to basis_name '"
                f"{self._basis_name}' must be"
                f" '{expected}'."
            )

    @property
    def states(self) -> list[Qobj]:
        """The state at each evaluation time."""
        return [res.state for res in self]

    def get_state(
        self,
        t: float,
        reduce_to_basis: Optional[str] = None,
        ignore_global_phase: bool = True,
        tol: float = 1e-6,
        normalize: bool = True,
        t_tol: float = 1.0e-3,
    ) -> Qobj:
        """Get the state at time t of the simulation.

        Args:
            t: Time (in µs) at which to return the state.
            reduce_to_basis: Reduces the full state vector to the given
                basis, if the eliminated populations are negligible.
            ignore_global_phase: Makes the largest state term real.
            tol: Maximum allowed population of eliminated states.
            normalize: Whether to normalize the reduced state.
            t_tol: Tolerance on the time lookup.

        Returns:
            The resulting state at time t.
        """
        t_index = self._get_index_from_time(t, t_tol)
        return self[t_index].get_state(
            reduce_to_basis, ignore_global_phase, tol, normalize
        )

    def get_final_state(
        self,
        reduce_to_basis: Optional[str] = None,
        ignore_global_phase: bool = True,
        tol: float = 1e-6,
        normalize: bool = True,
    ) -> Qobj:
        """Returns the final state of the simulation."""
        return self.get_state(
            self._sim_times[-1],
            reduce_to_basis,
            ignore_global_phase,
            tol,
            normalize,
        )
