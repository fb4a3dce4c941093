"""A minimal dense operator/state wrapper, standing in for qutip.Qobj.

Backs the emulator's inspection API (``get_hamiltonian``,
``build_operator``) and result states with plain numpy arrays, exposing
the small subset of the ``qutip.Qobj`` interface that reference user
code relies on (``full()``, ``dag()``, ``unit()``, ``isket``/``isoper``,
arithmetic, ``expect``-style products).
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np


class Qobj:
    """Dense matrix/vector wrapper with qutip.Qobj-compatible surface.

    Args:
        data: The underlying array. 1D arrays are treated as kets and
            stored as column vectors.
        dims: Optional qutip-style dims ``[[d]*n, [1]*n]`` (kets) or
            ``[[d]*n, [d]*n]`` (operators).
    """

    def __init__(
        self, data: Any, dims: Sequence[Sequence[int]] | None = None
    ):
        arr = np.asarray(
            data.full() if isinstance(data, Qobj) else data
        )
        if arr.ndim == 1:
            arr = arr.reshape(-1, 1)
        self._store: np.ndarray | None = np.asarray(arr, dtype=complex)
        self._fetch: Any = None
        self._shape: tuple[int, int] = self._store.shape
        if dims is None:
            if self.isket:
                dims = [[self._shape[0]], [1]]
            elif self.isbra:
                dims = [[1], [self._shape[1]]]
            else:
                dims = [[self._shape[0]], [self._shape[1]]]
        self.dims = [list(d) for d in dims]

    @classmethod
    def deferred(
        cls,
        fetch: Any,
        shape: tuple[int, int],
        dims: Sequence[Sequence[int]],
    ) -> Qobj:
        """A Qobj whose data stays device-resident until first touched.

        Solver outputs live in device memory; shipping every evaluation-time
        state to the host eagerly wastes transfer bandwidth when the
        caller only reads a few states (or computes observables on
        device). ``fetch()`` must return the complex host array of
        ``shape`` on first access; structure queries (``shape``,
        ``isket``/``isoper``, ``dims``) never materialize.
        """
        obj = object.__new__(cls)
        obj._store = None
        obj._fetch = fetch
        obj._shape = (int(shape[0]), int(shape[1]))
        obj.dims = [list(d) for d in dims]
        return obj

    @property
    def _data(self) -> np.ndarray:
        if self._store is None:
            arr = np.asarray(self._fetch(), dtype=complex)
            self._store = arr.reshape(self._shape)
            self._fetch = None
        return self._store

    @_data.setter
    def _data(self, value: np.ndarray) -> None:
        self._store = value
        self._fetch = None
        self._shape = value.shape  # type: ignore[assignment]

    # ---- structure ----
    @property
    def shape(self) -> tuple[int, int]:
        """The shape of the underlying matrix."""
        return self._shape

    @property
    def isket(self) -> bool:
        """Whether this is a column vector."""
        return self._shape[1] == 1 and self._shape[0] > 1

    @property
    def isbra(self) -> bool:
        """Whether this is a row vector."""
        return self._shape[0] == 1 and self._shape[1] > 1

    @property
    def isoper(self) -> bool:
        """Whether this is a square operator."""
        return self._shape[0] == self._shape[1]

    def full(self) -> np.ndarray:
        """The dense numpy array."""
        return self._data.copy()

    def diag(self) -> np.ndarray:
        """The diagonal of the matrix."""
        return np.diag(self._data)

    # ---- linear algebra ----
    def dag(self) -> Qobj:
        """The adjoint."""
        return Qobj(
            self._data.conj().T, dims=[self.dims[1], self.dims[0]]
        )

    def tr(self) -> complex:
        """The trace."""
        return complex(np.trace(self._data))

    def norm(self) -> float:
        """Vector 2-norm (kets) or trace norm (operators)."""
        if self.isket or self.isbra:
            return float(np.linalg.norm(self._data))
        return float(np.sum(np.abs(np.linalg.eigvals(self._data))))

    def unit(self, inplace: bool = False) -> Qobj:
        """The normalized state."""
        nrm = (
            float(np.linalg.norm(self._data))
            if (self.isket or self.isbra)
            else abs(self.tr())
        )
        if inplace:
            self._data = self._data / nrm
            return self
        return Qobj(self._data / nrm, dims=self.dims)

    def proj(self) -> Qobj:
        """|ψ><ψ| for a ket."""
        assert self.isket
        return Qobj(
            self._data @ self._data.conj().T,
            dims=[self.dims[0], self.dims[0]],
        )

    def tidyup(self, atol: float = 1e-12) -> Qobj:
        """Zeroes out negligible entries."""
        data = self._data.copy()
        data[np.abs(data) < atol] = 0
        return Qobj(data, dims=self.dims)

    def expect(self, state: Qobj) -> complex:
        """<ψ|A|ψ> or Tr[A ρ]."""
        if state.isket:
            return complex(
                (state._data.conj().T @ self._data @ state._data)[0, 0]
            )
        return complex(np.trace(self._data @ state._data))

    def overlap(self, other: Qobj) -> complex:
        """<self|other> for kets."""
        return complex((self._data.conj().T @ other._data)[0, 0])

    # ---- arithmetic ----
    def _coerce(self, other: Any) -> np.ndarray:
        return other._data if isinstance(other, Qobj) else np.asarray(other)

    def __add__(self, other: Any) -> Qobj:
        if isinstance(other, (int, float, complex)) and other == 0:
            return Qobj(self._data, dims=self.dims)
        return Qobj(self._data + self._coerce(other), dims=self.dims)

    __radd__ = __add__

    def __sub__(self, other: Any) -> Qobj:
        return Qobj(self._data - self._coerce(other), dims=self.dims)

    def __rsub__(self, other: Any) -> Qobj:
        return Qobj(self._coerce(other) - self._data, dims=self.dims)

    def __mul__(self, other: Any) -> Qobj:
        if isinstance(other, Qobj):
            return self.__matmul__(other)
        return Qobj(self._data * other, dims=self.dims)

    def __rmul__(self, other: Any) -> Qobj:
        if isinstance(other, Qobj):
            return other.__matmul__(self)
        return Qobj(self._data * other, dims=self.dims)

    def __truediv__(self, other: Any) -> Qobj:
        return Qobj(self._data / other, dims=self.dims)

    def __neg__(self) -> Qobj:
        return Qobj(-self._data, dims=self.dims)

    def __matmul__(self, other: Qobj) -> Qobj:
        out = self._data @ self._coerce(other)
        if isinstance(other, Qobj):
            dims = [self.dims[0], other.dims[1]]
        else:
            dims = None
        return Qobj(out, dims=dims)

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, Qobj):
            return False
        return self._data.shape == other._data.shape and bool(
            np.allclose(self._data, other._data)
        )

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        return np.asarray(self._data, dtype=dtype)

    def __repr__(self) -> str:
        kind = "ket" if self.isket else ("bra" if self.isbra else "oper")
        return (
            f"Qobj(dims={self.dims}, shape={self.shape}, type={kind})\n"
            f"{self._data!r}"
        )


def basis(dim: int, i: int) -> Qobj:
    """The i-th computational basis ket of dimension dim."""
    v = np.zeros((dim, 1), dtype=complex)
    v[i, 0] = 1.0
    return Qobj(v, dims=[[dim], [1]])


def qeye(dim: int) -> Qobj:
    """The identity operator of dimension dim."""
    return Qobj(np.eye(dim, dtype=complex), dims=[[dim], [dim]])


def tensor(ops: Sequence[Qobj]) -> Qobj:
    """Kronecker product of a list of Qobjs."""
    mats = [op.full() for op in ops]
    dims0 = [d for op in ops for d in op.dims[0]]
    dims1 = [d for op in ops for d in op.dims[1]]
    # One-hot fast path: the kron of single-entry kets is itself a
    # single-entry ket. The all-ground initial state at 25 atoms
    # costs ~12 s and ~1 GB of intermediates through repeated
    # np.kron; here it is one O(d^N) allocation.
    if len(mats) > 1 and all(
        m.ndim == 2
        and m.shape[1] == 1
        and m.shape[0] <= 16
        and np.issubdtype(m.dtype, np.inexact)
        and np.count_nonzero(m) == 1
        for m in mats
    ):
        idx = 0
        val = complex(1.0)
        for m in mats:
            j = int(np.flatnonzero(m[:, 0])[0])
            idx = idx * m.shape[0] + j
            val *= complex(m[j, 0])
        dim = int(np.prod([m.shape[0] for m in mats]))
        dtype = np.result_type(*(m.dtype for m in mats))
        out = np.zeros((dim, 1), dtype=dtype)
        out[idx, 0] = (
            val if np.issubdtype(dtype, np.complexfloating) else val.real
        )
        return Qobj(out, dims=[dims0, dims1])
    out = mats[0]
    for m in mats[1:]:
        out = np.kron(out, m)
    return Qobj(out, dims=[dims0, dims1])
