"""Named, typed variables for deferred sequence building.

API parity with reference
``pulser-core/pulser/parametrized/variable.py:32-183``. A ``Variable``
holds no value until ``Sequence.build`` assigns one; ``_count`` bumps
on every (re)assignment so cached ``ParamObj`` results can detect
staleness.
"""

from __future__ import annotations

import collections.abc as abc
import dataclasses
from typing import Any, Iterator, Union, cast

import numpy as np
from numpy.typing import ArrayLike

import pulser_tpu_torch.math as pm
from pulser_tpu_torch.json.utils import obj_to_dict
from pulser_tpu_torch.parametrized.paramabc import Parametrized
from pulser_tpu_torch.parametrized.paramobj import OpSupport


@dataclasses.dataclass(frozen=True, eq=False)
class Variable(Parametrized, OpSupport):
    """A placeholder value, bound only when the sequence is built.

    Args:
        name: The variable's unique name.
        dtype: What the contents are cast to — `float` or `int`.
        size: How many values it holds (a scalar when 1, the default).
    """

    name: str
    dtype: Union[type[float], type[int]]
    size: int = 1

    def __post_init__(self) -> None:
        # Requirement -> complaint, checked in declaration order
        rules: tuple[tuple[bool, Exception], ...] = (
            (
                isinstance(self.name, str),
                TypeError("Variable's 'name' has to be of type 'str'."),
            ),
            (
                self.dtype in (int, float),
                TypeError(
                    f"Invalid data type '{self.dtype}' for Variable."
                ),
            ),
            (
                isinstance(self.size, int),
                TypeError("Given variable 'size' is not of type 'int'."),
            ),
        )
        for ok, complaint in rules:
            if not ok:
                raise complaint
        if self.size < 1:
            raise ValueError("Variables must be of size 1 or larger.")
        object.__setattr__(self, "_count", -1)
        self._clear()

    @property
    def variables(self) -> dict[str, Variable]:
        """Itself, keyed by name (a Variable is its own dependency)."""
        return {self.name: self}

    def _set_state(self, value: pm.AbstractArray | None) -> None:
        """Stores a new value and bumps the assignment counter."""
        object.__setattr__(self, "value", value)
        object.__setattr__(self, "_count", self._count + 1)

    def _clear(self) -> None:
        self._count: int
        self._set_state(None)

    def _assign(self, value: Union[ArrayLike, float, int]) -> None:
        self._set_state(self._validate_value(value))

    def _validate_value(
        self, value: Union[ArrayLike, float, int]
    ) -> pm.AbstractArray:
        val = pm.AbstractArray(value, dtype=self.dtype, force_array=True)
        if val.size != self.size:
            raise ValueError(
                f"Can't assign array of size {val.size} to "
                + f"variable of size {self.size}."
            )
        return val

    def build(self) -> pm.AbstractArray:
        """The currently assigned value; fails when unbound."""
        self.value: pm.AbstractArray | None
        if self.value is None:
            raise ValueError(f"No value assigned to variable '{self.name}'.")
        return cast(pm.AbstractArray, self.value)

    def _to_dict(self) -> dict[str, Any]:
        out = obj_to_dict(self, _build=False)
        out.update(dataclasses.asdict(self))
        return out

    def _to_abstract_repr(self) -> dict[str, str]:
        return {"variable": self.name}

    def __str__(self) -> str:
        return self.name

    def _checked_key(
        self, key: Union[int, slice, abc.Sequence[int]]
    ) -> Union[int, slice, list[int]]:
        """Type- and bounds-checks an indexing key."""
        if isinstance(key, slice):
            return key
        if isinstance(key, int):
            flat: Union[int, list[int]] = key
            to_check = [key]
        elif isinstance(key, abc.Sequence):
            flat = list(key)
            to_check = flat
        else:
            raise TypeError(
                f"Invalid key type {type(key)} for '{self.name}'."
            )
        for entry in to_check:
            if not isinstance(entry, int):
                raise TypeError(
                    f"Invalid index type {type(entry)} for variable "
                    f"'{self.name}'."
                )
            if not -self.size <= entry < self.size:
                raise IndexError(
                    f"Index {entry} out of bounds for variable"
                    f" '{self.name}' with size {self.size}."
                )
        return flat

    def __getitem__(
        self, key: Union[int, slice, abc.Sequence[int]]
    ) -> VariableItem:
        return VariableItem(self, self._checked_key(key))

    def __len__(self) -> int:
        return self.size

    def __iter__(self) -> Iterator[VariableItem]:
        for i in range(self.size):
            yield self[i]


@dataclasses.dataclass(frozen=True)
class VariableItem(Parametrized, OpSupport):
    """Deferred indexing into a multi-valued Variable."""

    var: Variable
    key: Union[int, slice, abc.Sequence[int]]

    @property
    def variables(self) -> dict[str, Variable]:
        """The parent variable, keyed by name."""
        return self.var.variables

    def build(self) -> pm.AbstractArray:
        """The selected entries of the parent variable's value."""
        return self.var.build()[self.key]

    def _to_dict(self) -> dict[str, Any]:
        return obj_to_dict(
            self, self.var, self.key, _module="operator", _name="getitem"
        )

    def _to_abstract_repr(self) -> dict[str, Any]:
        if isinstance(self.key, abc.Sequence):
            picked: Union[int, list[int]] = list(self.key)
        else:
            picked = list(range(self.var.size))[self.key]
        return {"expression": "index", "lhs": self.var, "rhs": picked}

    def __str__(self) -> str:
        if isinstance(self.key, slice):
            parts = (self.key.start, self.key.stop, self.key.step)
            shown = ":".join("" if p is None else str(p) for p in parts)
        else:
            shown = str(self.key)
        return f"{str(self.var)}[{shown}]"

    def __len__(self) -> int:
        if isinstance(self.key, int):
            raise TypeError(f"len() of unsized variable item '{self!s}'.")
        return len(np.arange(self.var.size)[self.key])
