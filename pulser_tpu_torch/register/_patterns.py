"""Point generators for the built-in lattice patterns.

Produces the same point sets (and generation order) as the reference
``pulser-core/pulser/register/_patterns.py:21-53``. Only the square
lattice is ported so far (see ROADMAP.md).
"""

from __future__ import annotations

import numpy as np


def square_rect(rows: int, columns: int) -> np.ndarray:
    """A square lattice filling a rectangle, centered on the origin.

    Args:
        rows: Number of rows.
        columns: Number of columns.

    Returns:
        The (rows * columns, 2) point coordinates, row-major order.
    """
    xs = np.tile(np.arange(columns, dtype=float), rows)
    ys = np.repeat(np.arange(rows, dtype=float), columns)
    center = np.ceil([columns / 2, rows / 2]) - 1
    return np.column_stack((xs, ys)) - center
