"""Containers for processing the results of a simulation.

Behavioral parity with reference
``pulser-simulation/pulser_simulation/simresults.py:38-568``, over
dense numpy states instead of qutip objects: ``CoherentResults`` and
``NoisyResults`` with its pseudo-density expectation path, and the SPAM
measurement errors of coherent results, and the plots of expectation
values (with error bars for noisy results).
"""

from __future__ import annotations

import collections.abc
import typing
from abc import ABC, abstractmethod
from collections import Counter
from functools import lru_cache
from typing import Optional, Tuple, TypeVar, Union, cast

import numpy as np
from numpy.typing import ArrayLike

from pulser_tpu_torch import profiling
from pulser_tpu_torch.backend.results import ResultsSequence
from pulser_tpu_torch.emulator.qobj import Qobj, basis as basis_ket, tensor
from pulser_tpu_torch.emulator.sim_result import TorchResult
from pulser_tpu_torch.result import SampledResult

ResultType = TypeVar("ResultType", SampledResult, TorchResult)


def _is_diagonal(arr: np.ndarray) -> bool:
    return bool(np.all(arr == np.diag(np.diag(arr))))


class SimulationResults(ABC, ResultsSequence[ResultType]):
    """Results of a simulation run of a pulse sequence.

    Parent class of NoisyResults and CoherentResults. Contains methods
    for studying the states and extracting useful information.
    """

    # Use the pseudo-density matrix when calculating expectation values
    _use_pseudo_dens: bool = False

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
        dim = self._dim if not self._use_pseudo_dens else 2
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
            if self._use_pseudo_dens and not _is_diagonal(obs_arr):
                raise ValueError(f"Observable {obs!r} is non-diagonal.")
        states = (
            [self._calc_pseudo_density(ind) for ind in range(len(self))]
            if self._use_pseudo_dens
            else self.states
        )

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
        with profiling.phase("results.sample"):
            return self._sample_state(t, n_samples, t_tol)

    def _sample_state(
        self, t: float, n_samples: int, t_tol: float
    ) -> Counter:
        """The draws of :meth:`sample_state`."""
        t_index = self._get_index_from_time(t, t_tol)
        return self[t_index].get_samples(n_samples)

    def sample_final_state(self, N_samples: int = 1000) -> Counter:
        """The result of multiple measurements of the final state."""
        return self.sample_state(self._sim_times[-1], N_samples)

    def plot(
        self, op: Qobj, fmt: str = "", label: str = ""
    ) -> None:
        """Plots the expectation value of a given operator op.

        Args:
            op: Operator whose expectation value is wanted.
            fmt: Curve plot format.
            label: Curve label.
        """
        import matplotlib.pyplot as plt

        plt.plot(
            self._sim_times, self.expect([op])[0], fmt, label=label
        )
        plt.xlabel("Time (µs)")
        plt.ylabel("Expectation value")

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

    @lru_cache(maxsize=None)
    def _calc_pseudo_density(self, t_index: int) -> Qobj:
        """The pseudo-density matrix at a given time.

        A diagonal matrix calculated from the probability of obtaining
        each possible state after measurement.
        """

        def _proj_from_bitstring(bitstring: str) -> Qobj:
            return tensor([self._meas_projector(int(i)) for i in bitstring])

        w = self[t_index]._weights()
        # Multiply on the Qobj side: a numpy scalar's __mul__ would
        # absorb the Qobj into a plain ndarray
        return cast(
            Qobj,
            sum(
                _proj_from_bitstring(np.binary_repr(i, width=self._size))
                * float(w[i])
                for i in np.nonzero(w)[0]
            ),
        )

    def _meas_projector(self, state_n: int) -> Qobj:
        """The post-measurement projector for a measured 0 or 1."""
        if self._basis_name == "ground-rydberg":
            # 0 = |g>; 1 = |r>
            return basis_ket(2, 1 - state_n).proj()
        return basis_ket(2, state_n).proj()


class NoisyResults(SimulationResults[SampledResult]):
    """Results of a noisy simulation run of a pulse sequence.

    Contains a list of Counters describing the state distribution over
    time, as produced by a stochastic emulation run.
    """

    _use_pseudo_dens: bool = True

    def __init__(
        self,
        run_output: typing.Sequence[SampledResult],
        size: int,
        basis_name: str,
        sim_times: np.ndarray,
        n_measures: int,
    ) -> None:
        """Initializes a new NoisyResults instance.

        Args:
            run_output: One Counter (as a SampledResult) for each time
                the simulation returned a result.
            size: The number of atoms in the register.
            basis_name: Basis indicating the addressed atoms. Defaults
                to 'digital' if given 'all'/'all_with_error', and strips
                any '_with_error' suffix.
            sim_times: Times at which the results were returned.
            n_measures: Number of measurements used to compute this
                result.
        """
        basis = basis_name.replace("_with_error", "")
        basis_name_ = "digital" if basis == "all" else basis
        super().__init__(size, basis_name_, sim_times)
        self.n_measures = n_measures
        self._results_seq = tuple(run_output)

    @property
    def states(self) -> list[Qobj]:
        """Measured states as a list of diagonal density matrices."""
        return [self.get_state(t) for t in self._sim_times]

    @property
    def results(self) -> list[Counter]:
        """Probability distribution of the bitstrings."""
        return [Counter(res.sampling_dist) for res in self]

    def get_state(self, t: float, t_tol: float = 1.0e-3) -> Qobj:
        """Gets the state at time t as a diagonal density matrix.

        Note:
            This is not the density matrix of the system, but a
            convenient way of computing expectation values of
            observables.
        """
        return self._calc_pseudo_density(self._get_index_from_time(t, t_tol))

    def get_final_state(self) -> Qobj:
        """The final state as a diagonal density matrix."""
        return self.get_state(self._sim_times[-1])

    def plot(
        self,
        op: Qobj,
        fmt: str = ".",
        label: str = "",
        error_bars: bool = True,
    ) -> None:
        """Plots the expectation value of a given (diagonal) operator.

        Args:
            op: Operator whose expectation value is wanted.
            fmt: Curve plot format.
            label: y-Axis label.
            error_bars: Choose to display error bars.
        """
        import matplotlib.pyplot as plt

        def get_error_bars() -> Tuple[ArrayLike, ArrayLike]:
            moy = self.expect([op])[0]
            op_arr = np.asarray(
                op.full() if isinstance(op, Qobj) else op
            )
            op2 = op_arr @ op_arr
            moy2 = self.expect([op2])[0]
            variance = np.asarray(moy2) - np.asarray(moy) ** 2
            standard_dev = np.sqrt(
                np.maximum(variance, 0.0) / self.n_measures
            )
            return moy, standard_dev

        if error_bars:
            moy, st = get_error_bars()
            plt.errorbar(
                self._sim_times,
                moy,
                st,
                fmt=fmt,
                lw=1,
                capsize=3,
                label=label,
            )
            plt.xlabel("Time (µs)")
            plt.ylabel("Expectation value")
        else:
            super().plot(op, fmt, label)


class CoherentResults(SimulationResults[TorchResult]):
    """Results of a coherent simulation run of a pulse sequence."""

    def __init__(
        self,
        run_output: typing.Sequence[TorchResult],
        size: int,
        basis_name: str,
        sim_times: np.ndarray,
        meas_basis: str,
        meas_errors: Optional[collections.abc.Mapping[str, float]] = None,
    ) -> None:
        """Initializes a new CoherentResults instance.

        Args:
            run_output: The states at each evaluation time.
            size: The number of atoms in the register.
            basis_name: The basis indicating the addressed atoms.
            sim_times: Times at which results were returned.
            meas_basis: The basis in which sampling measurements are
                performed ("ground-rydberg" or "digital").
            meas_errors: Optional measurement errors, as a dict with
                "epsilon" and "epsilon_prime".
        """
        super().__init__(size, basis_name, sim_times)
        self._check_meas_basis(meas_basis)
        self._meas_basis = meas_basis
        self._results_seq = tuple(run_output)
        if meas_errors is not None:
            if set(meas_errors) != {"epsilon", "epsilon_prime"}:
                raise ValueError(
                    "When defining measurement errors, only values of "
                    "'epsilon' and 'epsilon_prime' must be given."
                )
            self._use_pseudo_dens = True
        self._meas_errors = meas_errors

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

    def _meas_projector(self, state_n: int) -> Qobj:
        if self._meas_errors:
            err_param = (
                self._meas_errors["epsilon"]
                if state_n == 0
                else self._meas_errors["epsilon_prime"]
            )
            # 'good' is the position of the state measuring to state_n;
            # matches for digital and XY, inverted for ground-rydberg
            good = (
                1 - state_n
                if "ground-rydberg" in self._basis_name
                else state_n
            )
            return (
                basis_ket(2, good).proj() * (1 - err_param)
                + basis_ket(2, 1 - good).proj() * err_param
            )
        return super()._meas_projector(state_n)

    def _sample_state(
        self, t: float, n_samples: int, t_tol: float
    ) -> Counter:
        """The draws of :meth:`sample_state`.

        SPAM measurement errors are applied as vectorized random XOR
        flips, drawn from the numpy global RNG in the JAX package's
        order.
        """
        sampled_state = super()._sample_state(t, n_samples, t_tol)
        if self._meas_errors is None or (
            self._meas_errors["epsilon"] == 0.0
            and self._meas_errors["epsilon_prime"] == 0
        ):
            return sampled_state

        eps = self._meas_errors["epsilon"]
        eps_p = self._meas_errors["epsilon_prime"]
        shots = list(sampled_state.keys())
        n_detects_list = list(sampled_state.values())

        shot_arr = np.array([list(shot) for shot in shots], dtype=int)
        flip_probs = np.where(shot_arr == 1, eps_p, eps)
        flip_probs_repeated = np.repeat(flip_probs, n_detects_list, axis=0)
        random_matrix = np.random.uniform(
            size=(np.sum(n_detects_list), len(shot_arr[0]))
        )
        flips = random_matrix < flip_probs_repeated
        new_shots = shot_arr.repeat(n_detects_list, axis=0) ^ flips
        detected_sample_dict: Counter = Counter(map(tuple, new_shots))
        return Counter(
            {
                "".join(map(str, k)): v
                for k, v in detected_sample_dict.items()
            }
        )
