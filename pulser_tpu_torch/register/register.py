"""The configuration of an array of neutral atoms in 2D.

Behavioral parity with reference
``pulser-core/pulser/register/register.py:43-581``, trimmed to the
square and rectangular lattices; the other constructors, drawing and
serialization are not ported yet (see ROADMAP.md).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Optional, Union

from numpy.typing import ArrayLike

import pulser_tpu_torch.math as pm
import pulser_tpu_torch.register._patterns as patterns
from pulser_tpu_torch.register.base_register import BaseRegister


def _count_at_least_one(value: int, name: str, noun: str) -> None:
    """Rejects non-positive lattice extents with a uniform message."""
    if value < 1:
        raise ValueError(
            f"The number of {noun} (`{name}` = {value})"
            " must be greater than or equal to 1."
        )


def _positive_spacing(
    spacing: Union[float, pm.TensorLike], label: bool = True
) -> pm.AbstractArray:
    """Checks a lattice spacing is > 0 and wraps it for scaling."""
    wrapped = pm.AbstractArray(spacing)
    if wrapped <= 0.0:
        raise ValueError(
            f"Spacing between atoms (`spacing` = {spacing})"
            " must be greater than 0."
            if label
            else "Spacing between atoms must be greater than 0."
        )
    return wrapped


class Register(BaseRegister):
    """A set of named qubits at fixed planar positions.

    Args:
        qubits: Maps each qubit's name to its (x, y) position, in μm.
    """

    def __init__(
        self,
        qubits: Mapping[Any, Union[ArrayLike, pm.TensorLike]],
        **kwargs: Any,
    ):
        """Initializes a custom Register."""
        super().__init__(qubits, **kwargs)
        coords_2d = self.dimensionality == 2 and all(
            c.shape == (2,) for c in self._coords_arr
        )
        if not coords_2d:
            raise ValueError(
                "All coordinates must be specified as vectors of size 2."
            )

    @classmethod
    def square(
        cls,
        side: int,
        spacing: Union[float, pm.TensorLike] = 4.0,
        prefix: Optional[str] = None,
    ) -> Register:
        """A side x side square array of qubits.

        Args:
            side: How many qubits long the square's edge is.
            spacing: Nearest-neighbour distance, in μm.
            prefix: Qubit ids become ``f"{prefix}{i}"`` when given.
        """
        _count_at_least_one(side, "side", "atoms per side")
        return cls.rectangle(side, side, spacing=spacing, prefix=prefix)

    @classmethod
    def rectangle(
        cls,
        rows: int,
        columns: int,
        spacing: Union[float, pm.TensorLike] = 4.0,
        prefix: Optional[str] = None,
    ) -> Register:
        """A rows x columns array of qubits with one common pitch.

        Args:
            rows: How many rows.
            columns: How many columns.
            spacing: Nearest-neighbour distance, in μm.
            prefix: Qubit ids become ``f"{prefix}{i}"`` when given.
        """
        return cls.rectangular_lattice(
            rows, columns, spacing, spacing, prefix
        )

    @classmethod
    def rectangular_lattice(
        cls,
        rows: int,
        columns: int,
        row_spacing: Union[float, pm.TensorLike] = 4.0,
        col_spacing: Union[float, pm.TensorLike] = 2.0,
        prefix: Optional[str] = None,
    ) -> Register:
        """A rows x columns array with independent row/column pitches.

        Args:
            rows: How many rows.
            columns: How many columns.
            row_spacing: Vertical pitch, in μm.
            col_spacing: Horizontal pitch, in μm.
            prefix: Qubit ids become ``f"{prefix}{i}"`` when given.
        """
        _count_at_least_one(rows, "rows", "rows")
        _count_at_least_one(columns, "columns", "columns")
        dy = _positive_spacing(row_spacing, label=False)
        dx = _positive_spacing(col_spacing, label=False)
        points = pm.AbstractArray(patterns.square_rect(rows, columns))
        points[:, 0] = points[:, 0] * dx
        points[:, 1] = points[:, 1] * dy
        return cls.from_coordinates(points, center=True, prefix=prefix)
