"""The TorchOperator: the modern Operator implementation over torch tensors.

Port of ``pulser_tpu/emulator/tpu_op.py`` (behavioral parity with
reference ``pulser-simulation/pulser_simulation/qutip_op.py:30-259``,
``QutipOperator``). The JAX package keeps every operator as a dense
``d^n × d^n`` matrix, which at 16 atoms is 2^32 entries; here an
operator built with :meth:`TorchOperator.from_operator_repr` keeps its
representation instead, a sum of coefficient × tensor products of local
``d × d`` operators:

- :meth:`TorchOperator.expect` and :meth:`TorchOperator.apply_to` apply
  it term by term along the qudit axes, on the state's device, in
  complex128 (:func:`~pulser_tpu_torch.ops.apply.apply_axis_c` on a ket;
  :func:`~pulser_tpu_torch.ops.apply.apply_row_c` then
  :func:`~pulser_tpu_torch.ops.apply.apply_col_c` on a density matrix);
- ``+``, scalar ``*`` and ``@`` combine the term lists;
- only :meth:`TorchOperator.to_qobj` (and an operator given as a dense
  Qobj or tensor) materializes the matrix, with the JAX package's values.

:class:`HamiltonianOperator` is the Hamiltonian a backend hands its
observables: the noiseless :class:`Hamiltonian` and a time, applied with
the structured ``H·ψ`` of :func:`~pulser_tpu_torch.ops.apply._hpsi`.
"""

from __future__ import annotations

from collections.abc import Sequence
from typing import Any, Type, TypeVar, Union

import numpy as np
import torch

from pulser_tpu_torch import profiling
from pulser_tpu_torch.backend.operator import FullOp, Operator, QuditOp
from pulser_tpu_torch.backend.state import Eigenstate
from pulser_tpu_torch.emulator.qobj import Qobj, basis as basis_ket, qeye, tensor
from pulser_tpu_torch.emulator.torch_state import WORK_DTYPE, TorchState
from pulser_tpu_torch.ops.apply import (
    _hpsi,
    apply_axis_c,
    apply_col_c,
    apply_row_c,
)

TorchStateType = TypeVar("TorchStateType", bound=TorchState)
TorchOperatorType = TypeVar("TorchOperatorType", bound="TorchOperator")

#: One term: a coefficient and the local ``d × d`` operators by qudit
#: (absent qudits carry the identity).
Term = tuple[complex, dict[int, np.ndarray]]


def _stage(
    host: Any, device: torch.device, dtype: torch.dtype = WORK_DTYPE
) -> torch.Tensor:
    """A host array as a tensor of ``dtype`` on ``device`` (a copy from
    pageable memory, which waits for the card)."""
    profiling.count("sync.operator.stage")
    return torch.as_tensor(np.asarray(host)).to(device, dtype)


def _term_gram(a: list[Term], b: list[Term], d: int, n: int) -> complex:
    """``Tr[A† B] / d^n`` of two term sums, without forming either: the
    trace of a tensor product is the product of the local traces."""
    total = 0j
    eye = np.eye(d)
    for ca, fa in a:
        for cb, fb in b:
            prod = np.conj(ca) * cb
            for q in set(fa) | set(fb):
                x, y = fa.get(q, eye), fb.get(q, eye)
                prod *= np.trace(x.conj().T @ y) / d
            total += prod
    return total


class TorchOperator(Operator[complex, complex, TorchStateType]):
    """A quantum operator: a dense matrix, or a sum of tensor products.

    Args:
        operator: The operator as a Qobj (type 'oper') or a square torch
            tensor.
        eigenstates: The eigenstates forming a qudit's eigenbasis, each
            as an individual character, in state-vector order.
    """

    _eigenstates: Sequence[Eigenstate]

    def __init__(
        self,
        operator: Union[Qobj, torch.Tensor],
        eigenstates: Sequence[Eigenstate],
    ):
        """Initializes a TorchOperator."""
        super().__init__()
        TorchState._validate_eigenstates(eigenstates)
        self._eigenstates = eigenstates
        if isinstance(operator, Qobj) and operator.isoper:
            dense = torch.from_numpy(operator.full())
        elif (
            isinstance(operator, torch.Tensor)
            and operator.ndim == 2
            and operator.shape[0] == operator.shape[1]
        ):
            dense = operator
        else:
            raise TypeError(
                "'operator' must be a Qobj with type 'oper' (or a square"
                f" torch.Tensor), not {operator!r}."
            )
        TorchState._validate_shape(
            tuple(dense.shape), len(self._eigenstates)
        )
        self._dense: torch.Tensor | None = dense
        self._terms: list[Term] | None = None
        self._n = round(
            np.log(dense.shape[0]) / np.log(len(self._eigenstates))
        )
        self._hermitian: bool | None = None

    @classmethod
    def _of_terms(
        cls: Type[TorchOperatorType],
        terms: list[Term],
        eigenstates: Sequence[Eigenstate],
        n_qudits: int,
    ) -> TorchOperatorType:
        """An operator kept as its term list."""
        obj = cls.__new__(cls)
        Operator.__init__(obj)
        obj._eigenstates = eigenstates
        obj._dense = None
        obj._terms = terms
        obj._n = n_qudits
        obj._hermitian = None
        return obj

    @property
    def eigenstates(self) -> tuple[Eigenstate, ...]:
        """The eigenstates that form a qudit's eigenbasis."""
        return tuple(self._eigenstates)

    @property
    def _d(self) -> int:
        return len(self._eigenstates)

    def _plain(self) -> TorchOperator:
        """This operator as a dense or term-list TorchOperator."""
        return self

    def to_qobj(self) -> Qobj:
        """Returns a copy of the operator's Qobj representation (the dense
        matrix, built on the host)."""
        d, n = self._d, self._n
        dims = [[d] * n, [d] * n]
        if self._dense is not None:
            profiling.count("sync.operator.qobj")
            return Qobj(
                self._dense.detach().resolve_conj().cpu().numpy(), dims=dims
            )
        assert self._terms is not None
        full_op: Qobj = sum(
            c
            * tensor(
                [
                    Qobj(facs[q]) if q in facs else qeye(d)
                    for q in range(n)
                ]
            )
            for c, facs in self._terms
        )
        return Qobj(full_op.full(), dims=dims)

    # -- application on a device ---------------------------------------

    def _local_ops(
        self, device: torch.device
    ) -> list[tuple[complex, list[tuple[int, torch.Tensor]]]]:
        """The term list with its local operators on ``device``."""
        assert self._terms is not None
        cache = self.__dict__.setdefault("_device_terms", {})
        key = str(device)
        if key not in cache:
            cache[key] = [
                (c, [(q, _stage(m, device)) for q, m in sorted(facs.items())])
                for c, facs in self._terms
            ]
        return cache[key]

    def _dense_on(self, device: torch.device) -> torch.Tensor:
        assert self._dense is not None
        return self._dense.to(device=device, dtype=WORK_DTYPE)

    def _left(self, x: torch.Tensor, rows: bool) -> torch.Tensor:
        """``A @ x`` for a ket (``rows=False``) or on the row index of a
        density matrix."""
        if self._dense is not None:
            a = self._dense_on(x.device)
            return a @ x
        d, n = self._d, self._n
        out = torch.zeros_like(x)
        for c, facs in self._local_ops(x.device):
            y = x
            for q, m in facs:
                y = (
                    apply_row_c(m, y, q, d, n)
                    if rows
                    else apply_axis_c(m, y, q, d, n)
                )
            out = out + c * y
        return out

    def _right_dag(self, x: torch.Tensor) -> torch.Tensor:
        """``x @ A†`` on the column index of a density matrix."""
        if self._dense is not None:
            return x @ self._dense_on(x.device).conj().T
        d, n = self._d, self._n
        out = torch.zeros_like(x)
        for c, facs in self._local_ops(x.device):
            y = x
            for q, m in facs:
                y = apply_col_c(m.conj().T, y, q, d, n)
            out = out + np.conj(c) * y
        return out

    def _is_hermitian(self) -> bool:
        """Whether the operator equals its adjoint, to ``np.allclose``'s
        default tolerances: on the dense matrix, or, for a term list, on
        the Frobenius norm of ``A − A†`` (per basis state) computed from
        local traces."""
        if self._hermitian is None:
            if self._dense is not None:
                profiling.count("sync.operator.hermitian")
                a = self._dense.detach().resolve_conj().cpu().numpy()
                self._hermitian = bool(np.allclose(a, a.conj().T))
            else:
                assert self._terms is not None
                d, n = self._d, self._n
                adj = [
                    (-np.conj(c), {q: m.conj().T for q, m in facs.items()})
                    for c, facs in self._terms
                ]
                diff = self._terms + adj
                diff2 = _term_gram(diff, diff, d, n).real
                norm2 = _term_gram(self._terms, self._terms, d, n).real
                self._hermitian = bool(diff2 <= 1e-16 + 1e-10 * norm2)
        return self._hermitian

    def apply_to(self, state: TorchStateType, /) -> TorchStateType:
        """Applies the operator to a state (``AρA†`` on a density
        matrix), on the state's device."""
        self._validate_other(state, TorchState, "TorchOperator.apply_to()")
        x = state._work()
        if state.isket:
            out = self._left(x, rows=False)
        else:
            out = self._right_dag(self._left(x, rows=True))
        return type(state)(out, eigenstates=state.eigenstates)

    def expect(self, state: TorchState, /) -> complex:
        """The expectation value of self on the given state, computed on
        the state's device."""
        self._validate_other(state, TorchState, "TorchOperator.expect()")
        x = state._work()
        # The value is read on the host
        profiling.count("sync.operator.expect")
        if state.isket:
            val = complex(torch.vdot(x, self._left(x, rows=False)).item())
        else:
            val = complex(torch.trace(self._left(x, rows=True)).item())
        if self._is_hermitian():
            return val.real
        return val

    # -- algebra -------------------------------------------------------

    def __add__(
        self: TorchOperatorType, other: TorchOperatorType, /
    ) -> TorchOperatorType:
        """The sum of two operators."""
        self._validate_other(other, TorchOperator, "__add__")
        a, b = self._plain(), other._plain()
        if a._terms is not None and b._terms is not None:
            return a._of_terms(
                a._terms + b._terms, a.eigenstates, a._n
            )
        return type(a)(
            a.to_qobj() + b.to_qobj(), eigenstates=self.eigenstates
        )

    def __rmul__(
        self: TorchOperatorType, scalar: complex
    ) -> TorchOperatorType:
        """The operator scaled by a scalar factor."""
        a = self._plain()
        if a._terms is not None:
            return a._of_terms(
                [(complex(scalar) * c, facs) for c, facs in a._terms],
                a.eigenstates,
                a._n,
            )
        return type(a)(complex(scalar) * a.to_qobj(), eigenstates=a.eigenstates)

    def __matmul__(
        self: TorchOperatorType, other: TorchOperatorType
    ) -> TorchOperatorType:
        """Composes two operators, 'self' applied after 'other'."""
        self._validate_other(other, TorchOperator, "__matmul__")
        a, b = self._plain(), other._plain()
        if a._terms is not None and b._terms is not None:
            eye = np.eye(a._d)
            terms = [
                (
                    ca * cb,
                    {
                        q: fa.get(q, eye) @ fb.get(q, eye)
                        for q in set(fa) | set(fb)
                    },
                )
                for ca, fa in a._terms
                for cb, fb in b._terms
            ]
            return a._of_terms(terms, a.eigenstates, a._n)
        return type(a)(
            a.to_qobj() @ b.to_qobj(), eigenstates=self.eigenstates
        )

    @classmethod
    def _from_operator_repr(
        cls: Type[TorchOperatorType],
        *,
        eigenstates: Sequence[Eigenstate],
        n_qudits: int,
        operations: FullOp[complex],
    ) -> tuple[TorchOperatorType, FullOp[complex]]:
        """Creates an operator from the operator representation, kept as
        its term list."""
        qudit_dim = len(eigenstates)

        def build_qudit_op(qudit_op: QuditOp[complex]) -> np.ndarray:
            op = qeye(qudit_dim) * 0
            for proj_str, coeff in qudit_op.items():
                ket = basis_ket(qudit_dim, eigenstates.index(proj_str[0]))
                bra = basis_ket(
                    qudit_dim, eigenstates.index(proj_str[1])
                ).dag()
                op = op + complex(coeff) * (ket @ bra)
            return op.full()

        terms: list[Term] = []
        reconstructed_ops = []
        for coeff, tensor_op in operations:
            factors: dict[int, np.ndarray] = {}
            re_tensor_op = []
            for qudit_op, qudit_inds in tensor_op:
                for ind in qudit_inds:
                    factors[ind] = build_qudit_op(qudit_op)
                re_qudit_op = {k: complex(v) for k, v in qudit_op.items()}
                re_tensor_op.append((re_qudit_op, set(qudit_inds)))
            terms.append((complex(coeff), factors))
            reconstructed_ops.append((complex(coeff), re_tensor_op))
        return cls._of_terms(terms, eigenstates, n_qudits), reconstructed_ops

    def __repr__(self) -> str:
        return "\n".join(
            [
                "TorchOperator",
                "-------------",
                f"Eigenstates: {self.eigenstates}",
                self.to_qobj().__repr__(),
            ]
        )

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, TorchOperator):
            return False
        return (
            self.eigenstates == other.eigenstates
            and self.to_qobj() == other.to_qobj()
        )

    def _validate_other(
        self,
        other: TorchState | TorchOperator,
        expected_type: Type,
        op_name: str,
    ) -> None:
        if not isinstance(other, expected_type):
            raise TypeError(
                f"'{op_name}' expects a '{expected_type.__name__}'"
                f" instance, not {type(other)}."
            )
        if self.eigenstates != other.eigenstates:
            msg = (
                f"Can't apply {op_name} between a"
                f" {self.__class__.__name__} "
                f"with eigenstates {self.eigenstates} and a "
                f"{other.__class__.__name__} with {other.eigenstates}."
            )
            if set(self.eigenstates) != set(other.eigenstates):
                raise ValueError(msg)
            raise NotImplementedError(msg)


class HamiltonianOperator(TorchOperator):
    """The Hamiltonian at one time, applied without its matrix.

    ``expect`` and ``apply_to`` run the structured ``H(t)·ψ``
    (:func:`~pulser_tpu_torch.ops.apply._hpsi`: the diagonal, the 1-local
    drive and the XY term, with the SLM mask's interaction weights at
    ``t``) on the state's device; only :meth:`to_qobj` (and the algebra,
    through it) calls :meth:`Hamiltonian.get_matrix`. The Hamiltonian is
    Hermitian by construction (each drive term next to its conjugate,
    real detunings, diagonal and couplings), so ``expect`` is real, as
    the JAX package's Hermiticity check finds it.

    Args:
        hamiltonian: The :class:`Hamiltonian` (built once per run).
        t: The time, in µs.
        eigenstates: The eigenstates of a qudit.
        cache: Device copies of the time-independent parts, shared by the
            operators of one run.
    """

    def __init__(
        self,
        hamiltonian: Any,
        t: float,
        eigenstates: Sequence[Eigenstate],
        cache: dict | None = None,
    ):
        """Initializes the operator."""
        Operator.__init__(self)
        TorchState._validate_eigenstates(eigenstates)
        self._eigenstates = eigenstates
        self._ham = hamiltonian
        self._t = float(t)
        self._n = hamiltonian.n_qudits
        self._dense = None
        self._terms = None
        self._hermitian = True
        self._cache = {} if cache is None else cache

    def to_qobj(self) -> Qobj:
        """The dense Hamiltonian at ``t`` (``Hamiltonian._hamiltonian``)."""
        return self._ham._hamiltonian(self._t)

    def _plain(self) -> TorchOperator:
        return TorchOperator(self.to_qobj(), eigenstates=self.eigenstates)

    def _static(self, device: torch.device) -> dict[str, Any]:
        """The diagonal (or its interpolation rows) and the XY couplings
        on ``device``, once per run."""
        key = str(device)
        if key not in self._cache:
            ham = self._ham

            self._cache[key] = {
                "diag": _stage(ham.int_diag, device, torch.float64),
                "xy": (
                    None
                    if ham.xy_mat is None
                    else _stage(
                        np.asarray(ham.xy_mat).real, device, torch.float64
                    )
                ),
            }
        return self._cache[key]

    def _hpsi_rows(self, x: torch.Tensor) -> torch.Tensor:
        """``x @ H(t)ᵀ``: ``H(t)`` applied to each row of ``x`` (a ket is
        one row)."""
        ham, t = self._ham, self._t
        st = self._static(x.device)
        amp, det = ham._coeffs_at(t)
        diag, xy = st["diag"], st["xy"]
        # The SLM mask's interaction weights at t (as in get_matrix)
        if ham.int_w is not None:
            w = _stage(ham._int_weights_at(t), x.device, torch.float64)
            if diag.ndim == 2:
                diag = w @ diag
            if xy is not None and xy.shape[0] == 2:
                xy = torch.tensordot(w, xy, dims=1)
        if xy is not None and xy.ndim == 3:
            xy = xy[0]
        return _hpsi(
            x,
            diag,
            _stage(amp, x.device),
            _stage(np.asarray(det).real, x.device, torch.float64),
            tuple(tuple(p) for p in ham.pairs),
            ham.dim,
            ham.n_qudits,
            xy_mat=xy,
            xy_indices=ham.xy_indices,
        )

    def _left(self, x: torch.Tensor, rows: bool) -> torch.Tensor:
        if not rows:
            return self._hpsi_rows(x)
        # H ρ = (ρᵀ Hᵀ)ᵀ: H on every column
        return self._hpsi_rows(x.transpose(0, 1)).transpose(0, 1)

    def _right_dag(self, x: torch.Tensor) -> torch.Tensor:
        # x H† = conj(conj(x) Hᵀ)
        return self._hpsi_rows(x.conj()).conj()

    @classmethod
    def _of_terms(cls, terms, eigenstates, n_qudits):  # type: ignore[override]
        return TorchOperator._of_terms(terms, eigenstates, n_qudits)

    def __repr__(self) -> str:
        return (
            f"HamiltonianOperator(t={self._t} µs, n_qudits={self._n},"
            f" eigenstates={self.eigenstates})"
        )


# Drop-in alias matching the reference class name
QutipOperator = TorchOperator
