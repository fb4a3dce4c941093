"""Convenience register layouts for the common lattices.

Behavioral parity with reference
``pulser-core/pulser/register/special_layouts.py:29-145``. All the
register-carving methods share one helper that maps lattice points to
traps and numbers the qubits with a prefix.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, cast

import numpy as np

import pulser_tpu_torch.register._patterns as patterns
from pulser_tpu_torch.json.utils import obj_to_dict
from pulser_tpu_torch.register.register_layout import RegisterLayout

if TYPE_CHECKING:
    from pulser_tpu_torch.register import Register


def _carve_register(
    layout: RegisterLayout, points: np.ndarray, prefix: str
) -> Register:
    """Defines a register on the traps matching the given points."""
    trap_ids = layout.get_traps_from_coordinates(*points)
    names = [f"{prefix}{i}" for i in range(len(trap_ids))]
    return cast(
        "pulser_tpu_torch.Register",
        layout.define_register(*trap_ids, qubit_ids=names),
    )


def _grid_points(
    rows: int, columns: int, col_spacing: float, row_spacing: float
) -> np.ndarray:
    """A centered rectangular grid with the given pitches."""
    return patterns.square_rect(rows, columns) * (col_spacing, row_spacing)


class RectangularLatticeLayout(RegisterLayout):
    """A rectangular grid of traps with independent x/y pitches.

    Args:
        rows: How many trap rows.
        columns: How many trap columns.
        col_spacing: Horizontal pitch between traps (µm).
        row_spacing: Vertical pitch between traps (µm).
    """

    def __init__(
        self,
        rows: int,
        columns: int,
        col_spacing: float,
        row_spacing: float,
    ):
        """Initializes a RectangularLatticeLayout."""
        self._rows = int(rows)
        self._columns = int(columns)
        self._col_spacing = float(col_spacing)
        self._row_spacing = float(row_spacing)
        super().__init__(
            trap_coordinates=_grid_points(
                self._rows,
                self._columns,
                self._col_spacing,
                self._row_spacing,
            ),
            slug=(
                f"RectangularLatticeLayout({self._rows}x{self._columns}, "
                f"{self._col_spacing}x{self._row_spacing}µm)"
            ),
        )

    def square_register(self, side: int, prefix: str = "q") -> Register:
        """Carves a square register out of this layout.

        Args:
            side: Atoms per edge of the square.
            prefix: Qubit ids become ``f"{prefix}{i}"``.

        Returns:
            The register, backed by this layout.
        """
        return self.rectangular_register(side, side, prefix=prefix)

    def rectangular_register(
        self,
        rows: int,
        columns: int,
        prefix: str = "q",
    ) -> Register:
        """Carves a rows x columns register out of this layout.

        Args:
            rows: How many rows of atoms.
            columns: How many columns of atoms.
            prefix: Qubit ids become ``f"{prefix}{i}"``.

        Returns:
            The register, backed by this layout.
        """
        if rows > self._rows or columns > self._columns:
            raise ValueError(
                f"A '{rows}x{columns}' array doesn't fit a "
                f"{self._rows}x{self._columns} RectangularLatticeLayout."
            )
        return _carve_register(
            self,
            _grid_points(
                rows, columns, self._col_spacing, self._row_spacing
            ),
            prefix,
        )

    def _to_dict(self) -> dict[str, Any]:
        return obj_to_dict(
            self,
            self._rows,
            self._columns,
            self._col_spacing,
            self._row_spacing,
        )


class SquareLatticeLayout(RectangularLatticeLayout):
    """A rectangular grid of traps with one common pitch.

    Args:
        rows: How many trap rows.
        columns: How many trap columns.
        spacing: The pitch between neighbouring traps (µm).
    """

    def __init__(self, rows: int, columns: int, spacing: float):
        """Initializes a SquareLatticeLayout."""
        self._spacing = float(spacing)
        super().__init__(rows, columns, self._spacing, self._spacing)
        # Replace the rectangular slug with the square-specific one.
        object.__setattr__(
            self,
            "slug",
            f"SquareLatticeLayout({self._rows}x{self._columns}, "
            f"{self._spacing}µm)",
        )

    def _to_dict(self) -> dict[str, Any]:
        return obj_to_dict(self, self._rows, self._columns, self._spacing)


class TriangularLatticeLayout(RegisterLayout):
    """Traps on a triangular lattice filling a hexagonal area.

    Args:
        n_traps: How many traps the layout holds.
        spacing: The pitch between neighbouring traps (µm).
    """

    def __init__(self, n_traps: int, spacing: float):
        """Initializes a TriangularLatticeLayout."""
        self._spacing = float(spacing)
        super().__init__(
            patterns.triangular_hex(int(n_traps)) * self._spacing,
            slug=(
                f"TriangularLatticeLayout({int(n_traps)},"
                f" {self._spacing}µm)"
            ),
        )

    def hexagonal_register(
        self, n_atoms: int, prefix: str = "q"
    ) -> Register:
        """Carves a hexagon-shaped register out of this layout.

        Args:
            n_atoms: How many atoms the register holds.
            prefix: Qubit ids become ``f"{prefix}{i}"``.

        Returns:
            The register, backed by this layout.
        """
        if n_atoms > self.number_of_traps:
            raise ValueError(
                f"The desired register has more atoms ({n_atoms}) than"
                " there are traps in this TriangularLatticeLayout"
                f" ({self.number_of_traps})."
            )
        return _carve_register(
            self, patterns.triangular_hex(n_atoms) * self._spacing, prefix
        )

    def rectangular_register(
        self, rows: int, atoms_per_row: int, prefix: str = "q"
    ) -> Register:
        """Carves a rectangle out of this triangular lattice.

        Args:
            rows: How many rows of atoms.
            atoms_per_row: Atoms per row.
            prefix: Qubit ids become ``f"{prefix}{i}"``.

        Returns:
            The register, backed by this layout.
        """
        if rows * atoms_per_row > self.number_of_traps:
            raise ValueError(
                f"A '{rows}x{atoms_per_row}' rectangular subset of a "
                "triangular lattice has more atoms than there are traps in"
                f" this TriangularLatticeLayout ({self.number_of_traps})."
            )
        return _carve_register(
            self,
            patterns.triangular_rect(rows, atoms_per_row) * self._spacing,
            prefix,
        )

    def _to_dict(self) -> dict[str, Any]:
        return obj_to_dict(self, self.number_of_traps, self._spacing)
