"""A dual numpy/torch array holder.

Upstream Pulser's original design (``pulser-core/pulser/math/
abstract_array.py:33``): host-side sequence construction and validation
run on concrete numpy arrays; a value that originates from a
``torch.Tensor`` is carried through as a tensor.
"""

from __future__ import annotations

import operator
from typing import Any, Union

import numpy as np
import torch

__all__ = ["AbstractArray", "AbstractArrayLike", "TensorLike"]

#: Things accepted wherever a tensor is accepted.
TensorLike = Union[torch.Tensor, np.ndarray, float, int]


def _torch_dtype(dtype: Any) -> torch.dtype:
    """The torch dtype matching a numpy/python dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype is float:
        return torch.get_default_dtype()
    return torch.from_numpy(np.zeros(0, dtype=dtype)).dtype


class AbstractArray:
    """An abstract array containing either a numpy array or a tensor.

    Args:
        array: The array to store. numpy inputs (or things castable to
            numpy arrays) stay numpy; tensors stay tensors.
        dtype: The data type of the array.
        force_array: Forces the array to be at least 1D.
    """

    def __init__(
        self,
        array: AbstractArrayLike,
        dtype: Any = None,
        force_array: bool = False,
    ):
        if isinstance(array, AbstractArray):
            array = array._array
        self._array: np.ndarray | torch.Tensor
        if isinstance(array, torch.Tensor):
            arr = array
            if dtype is not None:
                arr = arr.to(_torch_dtype(dtype))
            if force_array and arr.ndim == 0:
                arr = arr[None]
            self._array = arr
        else:
            arr_np = np.asarray(array, dtype=dtype)
            if force_array and arr_np.ndim == 0:
                arr_np = arr_np[None]
            self._array = arr_np

    @staticmethod
    def has_torch() -> bool:
        """Whether torch is available (always, in this package)."""
        return True

    @property
    def is_tensor(self) -> bool:
        """Whether the stored array is a torch tensor."""
        return isinstance(self._array, torch.Tensor)

    @property
    def requires_grad(self) -> bool:
        """Whether the stored tensor requires grad."""
        return self.is_tensor and bool(self._array.requires_grad)

    def astype(self, dtype: Any) -> AbstractArray:
        """Casts the data type of the array contents."""
        if self.is_tensor:
            return AbstractArray(self._array.to(_torch_dtype(dtype)))
        return AbstractArray(self._array.astype(dtype))

    def as_tensor(self) -> torch.Tensor:
        """Returns the contents as a torch tensor."""
        if self.is_tensor:
            return self._array  # type: ignore[return-value]
        return torch.as_tensor(self._array)

    def as_array(self, detach: bool = False) -> np.ndarray:
        """Returns the contents as a numpy array.

        Args:
            detach: Required to be ``True`` to convert a tensor that
                requires grad.
        """
        if self.is_tensor:
            if self.requires_grad:
                if not detach:
                    raise RuntimeError(
                        "The tensor requires grad. Use"
                        " `.as_array(detach=True)` or keep it as a"
                        " tensor with `.as_tensor()`."
                    )
                return self._array.detach().cpu().numpy()
            return self._array.cpu().numpy()
        return self._array  # type: ignore[return-value]

    def _to_dict(self) -> dict[str, Any]:
        from pulser_tpu_torch.json.utils import obj_to_dict

        try:
            return obj_to_dict(self, self.as_array())
        except RuntimeError as e:
            raise NotImplementedError(
                "A tensor that requires grad can't be serialized"
                " without losing the computational graph information."
            ) from e

    def _to_abstract_repr(self) -> Any:
        try:
            return self.as_array().tolist()
        except RuntimeError as e:
            raise NotImplementedError(
                "A tensor that requires grad can't be serialized"
                " without losing the computational graph information."
            ) from e

    def copy(self) -> AbstractArray:
        """Returns a copy of the AbstractArray."""
        return AbstractArray(self._array.clone() if self.is_tensor else self._array.copy())

    def tolist(self) -> list:
        """Returns the contents as a python list."""
        return np.asarray(self.as_array(detach=True)).tolist()

    def reshape(self, shape: tuple[int, ...]) -> AbstractArray:
        """Returns a new AbstractArray with the given shape."""
        return AbstractArray(self._array.reshape(shape))

    @property
    def size(self) -> int:
        """The number of elements."""
        return int(np.prod(self._array.shape)) if self._array.shape else 1

    @property
    def ndim(self) -> int:
        """The number of dimensions."""
        return self._array.ndim

    @property
    def shape(self) -> tuple[int, ...]:
        """The shape of the array."""
        return tuple(self._array.shape)

    @property
    def real(self) -> AbstractArray:
        """The real part of each element."""
        return AbstractArray(self._array.real)

    @property
    def dtype(self) -> Any:
        """The data type of the contents."""
        return self._array.dtype

    def detach(self) -> AbstractArray:
        """Returns a new AbstractArray detached from any graph."""
        return AbstractArray(self.as_array(detach=True))

    def __repr__(self) -> str:
        return repr(self._array)

    # ---- conversions ----
    def __int__(self) -> int:
        return int(self.as_array(detach=True))

    def __float__(self) -> float:
        return float(self.as_array(detach=True))

    def __complex__(self) -> complex:
        return complex(self.as_array(detach=True))

    def __bool__(self) -> bool:
        return bool(self._array)

    def __len__(self) -> int:
        return len(self._array)

    def __iter__(self):
        for i in range(len(self)):
            yield AbstractArray(self._array[i])

    def __hash__(self) -> int:
        return hash(tuple(np.ravel(self.as_array(detach=True)).tolist()))

    # ---- binary/unary op machinery ----
    @staticmethod
    def _lift2(a: Any, b: Any) -> tuple[Any, Any]:
        """Coerces two operands to a common backend (torch wins)."""
        a_arr = a._array if isinstance(a, AbstractArray) else a
        b_arr = b._array if isinstance(b, AbstractArray) else b
        if isinstance(a_arr, torch.Tensor) or isinstance(b_arr, torch.Tensor):
            return torch.as_tensor(a_arr), torch.as_tensor(b_arr)
        return a_arr, b_arr

    def _binary_op(self, other: Any, op, reverse: bool = False):
        if other is NotImplemented:
            return NotImplemented
        a, b = AbstractArray._lift2(self, other)
        if reverse:
            a, b = b, a
        return AbstractArray(op(a, b))

    def __neg__(self) -> AbstractArray:
        return AbstractArray(operator.neg(self._array))

    def __abs__(self) -> AbstractArray:
        return AbstractArray(abs(self._array))

    def __round__(self, decimals: int = 0) -> AbstractArray:
        if self.is_tensor:
            return AbstractArray(torch.round(self._array, decimals=decimals))
        return AbstractArray(np.round(self._array, decimals))

    # Comparison / arithmetic operators
    def __eq__(self, other: Any) -> AbstractArray:  # type: ignore[override]
        return self._binary_op(other, operator.eq)

    def __ne__(self, other: Any) -> AbstractArray:  # type: ignore[override]
        return self._binary_op(other, operator.ne)

    def __lt__(self, other: Any) -> AbstractArray:
        return self._binary_op(other, operator.lt)

    def __le__(self, other: Any) -> AbstractArray:
        return self._binary_op(other, operator.le)

    def __gt__(self, other: Any) -> AbstractArray:
        return self._binary_op(other, operator.gt)

    def __ge__(self, other: Any) -> AbstractArray:
        return self._binary_op(other, operator.ge)

    def __add__(self, other: Any) -> AbstractArray:
        return self._binary_op(other, operator.add)

    def __radd__(self, other: Any) -> AbstractArray:
        return self._binary_op(other, operator.add, reverse=True)

    def __sub__(self, other: Any) -> AbstractArray:
        return self._binary_op(other, operator.sub)

    def __rsub__(self, other: Any) -> AbstractArray:
        return self._binary_op(other, operator.sub, reverse=True)

    def __mul__(self, other: Any) -> AbstractArray:
        return self._binary_op(other, operator.mul)

    def __rmul__(self, other: Any) -> AbstractArray:
        return self._binary_op(other, operator.mul, reverse=True)

    def __truediv__(self, other: Any) -> AbstractArray:
        return self._binary_op(other, operator.truediv)

    def __rtruediv__(self, other: Any) -> AbstractArray:
        return self._binary_op(other, operator.truediv, reverse=True)

    def __floordiv__(self, other: Any) -> AbstractArray:
        return self._binary_op(other, operator.floordiv)

    def __rfloordiv__(self, other: Any) -> AbstractArray:
        return self._binary_op(other, operator.floordiv, reverse=True)

    def __pow__(self, other: Any) -> AbstractArray:
        return self._binary_op(other, operator.pow)

    def __rpow__(self, other: Any) -> AbstractArray:
        return self._binary_op(other, operator.pow, reverse=True)

    def __mod__(self, other: Any) -> AbstractArray:
        return self._binary_op(other, operator.mod)

    def __rmod__(self, other: Any) -> AbstractArray:
        return self._binary_op(other, operator.mod, reverse=True)

    def __matmul__(self, other: Any) -> AbstractArray:
        return self._binary_op(other, operator.matmul)

    def __rmatmul__(self, other: Any) -> AbstractArray:
        return self._binary_op(other, operator.matmul, reverse=True)

    # ---- numpy ufunc interception (so np.cos(AbstractArray) works) ----
    #: torch counterparts of numpy ufunc reductions
    _TORCH_REDUCTIONS = {
        "add": "sum",
        "maximum": "amax",
        "minimum": "amin",
        "multiply": "prod",
        "logical_or": "any",
        "logical_and": "all",
    }

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        arrays = [
            x._array if isinstance(x, AbstractArray) else x for x in inputs
        ]
        if any(isinstance(a, torch.Tensor) for a in arrays):
            if method == "__call__":
                tfn = getattr(torch, ufunc.__name__, None)
                if tfn is None:
                    return NotImplemented
                return AbstractArray(
                    tfn(*[torch.as_tensor(a) for a in arrays])
                )
            if method == "reduce":
                red = self._TORCH_REDUCTIONS.get(ufunc.__name__)
                if red is None:
                    return NotImplemented
                axis = kwargs.get("axis")
                t = torch.as_tensor(arrays[0])
                if axis is None:
                    return AbstractArray(getattr(torch, red)(t))
                return AbstractArray(getattr(torch, red)(t, axis))
            return NotImplemented
        result = getattr(ufunc, method)(*arrays, **kwargs)
        if isinstance(result, np.ndarray) or np.isscalar(result):
            return AbstractArray(result)
        return result

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        arr = self.as_array(detach=True)
        return np.asarray(arr, dtype=dtype)

    # ---- indexing ----
    @staticmethod
    def _unwrap_index(indices: Any) -> Any:
        if isinstance(indices, AbstractArray):
            return indices._array
        if isinstance(indices, tuple):
            return tuple(AbstractArray._unwrap_index(i) for i in indices)
        return indices

    def __getitem__(self, indices: Any) -> AbstractArray:
        return AbstractArray(self._array[self._unwrap_index(indices)])

    def __setitem__(self, indices: Any, values: Any) -> None:
        idx = self._unwrap_index(indices)
        vals = values._array if isinstance(values, AbstractArray) else values
        if self.is_tensor or isinstance(vals, torch.Tensor):
            arr = torch.as_tensor(self._array).clone()
            arr[idx] = torch.as_tensor(vals, dtype=arr.dtype)
            self._array = arr
        else:
            self._array[idx] = vals  # type: ignore[index]


AbstractArrayLike = Union[AbstractArray, TensorLike, list, tuple]
