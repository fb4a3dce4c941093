"""The TorchState: the modern State implementation over torch tensors.

Port of ``pulser_tpu/emulator/tpu_state.py`` (behavioral parity with
reference ``pulser-simulation/pulser_simulation/qutip_state.py:35-282``,
``QutipState``). The amplitudes (a ket or a density matrix) are a torch
tensor on the device where they were made: a solver's output stays on
its device, a state built from a :class:`Qobj` or from amplitudes lives
on the host unless ``torch_device`` says otherwise.

- :meth:`TorchState.overlap` and the operators' ``expect``/``apply_to``
  run on the device, in complex128;
- :meth:`TorchState.probabilities`, :meth:`bitstring_probabilities`,
  :meth:`sample` and :meth:`to_qobj` fetch the amplitudes to the host and
  repeat the JAX package's arithmetic (complex128 copy, ``|·|²`` in
  float64, the same cutoff, :func:`multinomial` and the SPAM flips on the
  global numpy RNG), so seeded counts equal ``TpuState``'s on equal
  amplitudes.
"""

from __future__ import annotations

import functools
import math
from collections import Counter, defaultdict
from collections.abc import Collection, Mapping, Sequence
from typing import Any, Type, TypeVar, Union

import numpy as np
import torch

from pulser_tpu_torch.backend.state import Eigenstate, State
from pulser_tpu_torch.emulator.qobj import Qobj, basis as basis_ket, tensor
from pulser_tpu_torch.math.multinomial import multinomial


def _readout_errors(
    bitstrings: np.ndarray, p_false_pos: float, p_false_neg: float
) -> list[str]:
    """Applies vectorized SPAM bit flips to sampled bitstrings.

    A measured 1 flips to 0 with ``p_false_neg``, a 0 to 1 with
    ``p_false_pos`` (reference ``qutip_state.py:112-217``); all flips
    draw from the global numpy RNG in one call.
    """
    bits = (
        np.frombuffer(
            "".join(bitstrings.tolist()).encode(), dtype=np.uint8
        ).reshape(len(bitstrings), -1)
        - ord("0")
    ).astype(int)
    flip_probs = np.where(bits == 1, p_false_neg, p_false_pos)
    bits ^= np.random.uniform(size=flip_probs.shape) < flip_probs
    # The rows back to '0'/'1' strings in one pass over the bytes
    chars = np.ascontiguousarray(bits.astype(np.uint8) + ord("0"))
    return chars.view(f"S{bits.shape[1]}").ravel().astype(str).tolist()


#: Up to this many basis states, the labels of every index are built once
#: per basis and kept.
_LABEL_TABLE_MAX = 1 << 20


@functools.lru_cache(maxsize=8)
def _basis_labels(n_qudits: int, eigenstates: tuple) -> np.ndarray:
    """``State.get_basis_state_from_index`` of every index at once: the
    base-``d`` digits of the index, qudit 0 the most significant, as
    eigenstate labels."""
    d = len(eigenstates)
    idx = np.arange(d**n_qudits)
    chars = np.array(eigenstates, dtype="U1")
    labels = np.full(idx.shape, "", dtype=f"U{n_qudits}")
    for q in range(n_qudits):
        digit = (idx // d ** (n_qudits - 1 - q)) % d
        labels = np.char.add(labels, chars[digit])
    return labels


TorchStateType = TypeVar("TorchStateType", bound="TorchState")

QuditOp = Mapping[str, complex]
TensorOp = Sequence[tuple[QuditOp, Collection[int]]]
FullOp = Sequence[tuple[complex, TensorOp]]

#: The dtype of the device-side arithmetic (overlaps, expectations).
WORK_DTYPE = torch.complex128


def _as_amplitudes(state: Union[Qobj, torch.Tensor]) -> torch.Tensor:
    """A ket as a 1-D tensor, a bra as its adjoint ket, an operator as a
    square 2-D tensor."""
    if isinstance(state, Qobj):
        data = torch.from_numpy(state.full())
    else:
        data = state
    if data.ndim == 1:
        return data
    if data.ndim != 2:
        raise ValueError(
            f"A state tensor must be 1-D or 2-D, not of shape {data.shape}."
        )
    rows, cols = data.shape
    if cols == 1 and rows > 1:
        return data[:, 0]
    if rows == 1 and cols > 1:
        return data[0].conj().resolve_conj()
    if rows != cols:
        raise ValueError(f"A state of shape {tuple(data.shape)} is neither"
                         " a ket, a bra nor a square operator.")
    return data


class TorchState(State[complex, float]):
    """A quantum state stored as a torch tensor.

    Args:
        state: The state as a Qobj (statevector or density matrix) or a
            torch tensor (a 1-D ket, a column, a row taken as a bra, or a
            square density matrix).
        eigenstates: The eigenstates forming a qudit's eigenbasis, each
            as an individual character, in state-vector order.
        torch_device: Where the amplitudes live (default: where the
            tensor is; a Qobj's on the host).
    """

    def __init__(
        self,
        state: Union[Qobj, torch.Tensor],
        *,
        eigenstates: Sequence[Eigenstate],
        torch_device: Union[str, torch.device, None] = None,
    ):
        """Initializes a TorchState."""
        super().__init__(eigenstates=eigenstates)
        if not isinstance(state, (Qobj, torch.Tensor)):
            raise TypeError(
                "'state' must be a Qobj (ket, bra or operator) or a"
                f" torch.Tensor, not {state!r}."
            )
        amps = _as_amplitudes(state)
        if torch_device is not None:
            amps = amps.to(torch_device)
        self._state = amps
        dim = amps.shape[0]
        self._validate_shape(
            (dim, 1) if amps.ndim == 1 else (dim, dim), self.qudit_dim
        )

    @property
    def n_qudits(self) -> int:
        """The number of qudits in the state."""
        return round(math.log(self._state.shape[0], self.qudit_dim))

    @property
    def isket(self) -> bool:
        """Whether the state is a pure state (a ket)."""
        return self._state.ndim == 1

    @property
    def torch_device(self) -> torch.device:
        """The device the amplitudes live on."""
        return self._state.device

    def to_tensor(self) -> torch.Tensor:
        """The amplitudes on their device: ``(dim,)`` for a ket, ``(dim,
        dim)`` for a density matrix."""
        return self._state

    def _work(self, device: torch.device | None = None) -> torch.Tensor:
        """The amplitudes in the work dtype, on ``device`` (default: their
        own)."""
        return self._state.to(
            device=device or self._state.device, dtype=WORK_DTYPE
        )

    def _host(self) -> np.ndarray:
        """The amplitudes as a complex128 host array (a column for a ket),
        the JAX package's ``Qobj`` data."""
        arr = self._state.detach().resolve_conj().cpu().numpy()
        arr = arr.astype(complex)
        return arr.reshape(-1, 1) if self.isket else arr

    def to_qobj(self) -> Qobj:
        """Returns a copy of the state's Qobj representation (fetched to
        the host)."""
        d, n = self.qudit_dim, self.n_qudits
        dims = [[d] * n, [1] * n] if self.isket else [[d] * n, [d] * n]
        return Qobj(self._host(), dims=dims)

    def overlap(self, other: TorchState) -> float:
        """The overlap between this state and another of the same type.

        ``Tr[AB]`` for mixed states, ``|<a|b>|^2`` for pure states.
        """
        if not isinstance(other, TorchState):
            raise TypeError(
                "'TorchState.overlap()' expects another 'TorchState', not "
                f"{type(other)}."
            )
        if (
            self.n_qudits != other.n_qudits
            or self.qudit_dim != other.qudit_dim
        ):
            raise ValueError(
                "Can't calculate the overlap between a state with "
                f"{self.n_qudits} {self.qudit_dim}-dimensional qudits"
                f" and another with {other.n_qudits}"
                f" {other.qudit_dim}-dimensional qudits."
            )
        if self.eigenstates != other.eigenstates:
            msg = (
                "Can't calculate the overlap between states with"
                f" eigenstates {self.eigenstates} and"
                f" {other.eigenstates}."
            )
            if set(self.eigenstates) != set(other.eigenstates):
                raise ValueError(msg)
            raise NotImplementedError(msg)
        device = _common_device(self, other)
        a, b = self._work(device), other._work(device)
        if self.isket and other.isket:
            return float(abs(torch.vdot(a, b).item()) ** 2)
        if self.isket:
            # <a| B |a>
            return float(torch.vdot(a, b @ a).real.item())
        if other.isket:
            return float(torch.vdot(b, a @ b).real.item())
        return float(torch.trace(a @ b).real.item())

    def probabilities(self, *, cutoff: float = 1e-12) -> dict[str, float]:
        """The probabilities of measuring each basis state combination.

        Normalized to sum to 1.

        Args:
            cutoff: The value below which a probability is considered
                zero.
        """
        q = self.to_qobj()
        if not q.isket:
            probs = np.abs(q.diag()).real
        else:
            probs = (np.abs(q.full()) ** 2).flatten().real
        non_zero = np.argwhere(probs > cutoff).flatten()
        probs = probs[non_zero]
        probs = probs / np.sum(probs)
        if len(probs) and self.qudit_dim**self.n_qudits <= _LABEL_TABLE_MAX:
            table = _basis_labels(self.n_qudits, self.eigenstates)
            labels = table[non_zero].tolist()
        else:
            labels = list(map(self.get_basis_state_from_index, non_zero))
        return dict(zip(labels, probs))

    def bitstring_probabilities(
        self,
        *,
        one_state: Eigenstate | None = None,
        cutoff: float = 1e-12,
    ) -> Mapping[str, float]:
        """The probabilities of measuring each bitstring.

        Args:
            one_state: The eigenstate that measures to 1.
            cutoff: The value below which a probability is considered
                zero.
        """
        one_state = one_state or self.infer_one_state()
        # One translation table maps every eigenstate char to its bit
        to_bits = str.maketrans(
            {s: "1" if s == one_state else "0" for s in self.eigenstates}
        )
        bitstring_probs: dict[str, float] = defaultdict(float)
        for state_str, p in self.probabilities(cutoff=cutoff).items():
            bitstring_probs[state_str.translate(to_bits)] += p
        return dict(bitstring_probs)

    def sample(
        self,
        *,
        num_shots: int,
        one_state: Eigenstate | None = None,
        p_false_pos: float = 0.0,
        p_false_neg: float = 0.0,
    ) -> Counter[str]:
        """Samples bitstrings, taking into account error rates.

        Args:
            num_shots: How many bitstrings to sample.
            one_state: The eigenstate that measures to 1.
            p_false_pos: The rate at which a 0 is read as a 1.
            p_false_neg: The rate at which a 1 is read as a 0.

        Returns:
            The measured bitstrings, by count.
        """
        bitstring_probs = self.bitstring_probabilities(
            one_state=one_state, cutoff=1 / (1000 * num_shots)
        )
        bitstrings = np.array(list(bitstring_probs))
        probs = np.array(list(map(float, bitstring_probs.values())))
        drawn = bitstrings[multinomial(num_shots, probs)]
        if p_false_pos == 0.0 and p_false_neg == 0.0:
            return Counter(drawn.tolist())
        return Counter(_readout_errors(drawn, p_false_pos, p_false_neg))

    @classmethod
    def _from_state_amplitudes(
        cls: Type[TorchStateType],
        *,
        eigenstates: Sequence[Eigenstate],
        n_qudits: int,
        amplitudes: Mapping[str, complex],
    ) -> tuple[TorchStateType, Mapping[str, complex]]:
        """Constructs the state from its basis states' amplitudes."""
        qudit_dim = len(eigenstates)

        def make_qobj(basis_state: str) -> Qobj:
            return tensor(
                [
                    basis_ket(qudit_dim, eigenstates.index(s))
                    for s in basis_state
                ]
            )

        state = make_qobj(eigenstates[0] * n_qudits) * 0
        amps = {k: complex(v) for k, v in amplitudes.items()}
        for basis_state, amp in amps.items():
            state = state + amp * make_qobj(basis_state)

        return cls(state, eigenstates=eigenstates), amps

    def __repr__(self) -> str:
        return "\n".join(
            [
                "TorchState",
                "----------",
                f"Eigenstates: {self.eigenstates}",
                self.to_qobj().__repr__(),
            ]
        )

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, TorchState):
            return False
        return (
            self.eigenstates == other.eigenstates
            and self.to_qobj() == other.to_qobj()
        )

    @staticmethod
    def _validate_shape(shape: tuple[int, int], qudit_dim: int) -> None:
        expected_n_qudits = math.log(shape[0], qudit_dim)
        if not np.isclose(expected_n_qudits, round(expected_n_qudits)):
            raise ValueError(
                f"A Qobj with shape {shape} is incompatible with "
                f"a system of {qudit_dim}-level qudits."
            )


def _common_device(*states: Any) -> torch.device:
    """The device of a binary operation: a card's when either operand
    lives on one, else the host."""
    for st in states:
        if st.torch_device.type != "cpu":
            return st.torch_device
    return states[0].torch_device


def unit_state(
    amps: Union[Qobj, torch.Tensor],
    eigenstates: Sequence[Eigenstate],
    torch_device: Union[str, torch.device, None] = None,
) -> TorchState:
    """The normalized state, as the JAX backend hands its consumers
    (``TpuState(q.unit())``): a host Qobj is normalized on the host in
    complex128, a device tensor on its device in complex128 (a ket by its
    norm, a density matrix by its trace's modulus)."""
    if isinstance(amps, Qobj):
        return TorchState(
            amps.unit(), eigenstates=eigenstates, torch_device=torch_device
        )
    work = amps.to(WORK_DTYPE)
    if work.ndim == 1:
        work = work / torch.linalg.vector_norm(work)
    else:
        work = work / torch.trace(work).abs()
    return TorchState(work, eigenstates=eigenstates, torch_device=torch_device)


# Drop-in alias matching the reference class name
QutipState = TorchState
