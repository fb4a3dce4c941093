"""Point generators for the built-in lattice patterns.

Produces the same point sets (and generation order) as the reference
``pulser-core/pulser/register/_patterns.py:21-53``, built here on the
complex plane: a hexagonal ring is six vertex rays walked side by side.
"""

from __future__ import annotations

import numpy as np

# Unit hexagon vertices on the complex plane, left vertex first,
# counter-clockwise, with the first vertex repeated to close the loop.
_CREST = np.sqrt(3) / 2.0
_VERTS = np.array(
    [
        -1.0 + 0.0j,
        -0.5 + _CREST * 1j,
        0.5 + _CREST * 1j,
        1.0 + 0.0j,
        0.5 - _CREST * 1j,
        -0.5 - _CREST * 1j,
        -1.0 + 0.0j,
    ]
)


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


def triangular_rect(rows: int, columns: int) -> np.ndarray:
    """A triangular lattice filling a rectangle.

    Odd rows are shifted right by half a site; row pitch is the
    triangle height.

    Args:
        rows: Number of rows.
        columns: Number of columns.

    Returns:
        The (rows * columns, 2) point coordinates.
    """
    pts = square_rect(rows, columns)
    shift = 0.5 * (pts[:, 1] % 2)
    return np.column_stack((pts[:, 0] + shift, pts[:, 1] * _CREST))


def _ring(layer: int, side_counts: list[int]) -> list[complex]:
    """One hexagonal ring at distance ``layer``.

    Each side ``s`` starts just after vertex ``layer * _VERTS[s]`` and
    places ``side_counts[s]`` points stepping towards the next vertex.
    """
    pts: list[complex] = []
    for s in range(6):
        anchor = layer * _VERTS[s]
        step = _VERTS[s + 1] - _VERTS[s]
        pts.extend(anchor + a * step for a in range(1, side_counts[s] + 1))
    return pts


def triangular_hex(n_points: int) -> np.ndarray:
    """A triangular lattice filling a hexagon around a central point.

    Complete rings are laid out from the inside out; a final partial
    ring distributes leftovers so that C3 symmetry (then C6) is kept as
    often as possible.

    Args:
        n_points: The number of points in the pattern.

    Returns:
        The (n_points, 2) point coordinates, center first.
    """
    if n_points < 7:
        # Not even one full ring: center plus up to 5 ring-1 points.
        seed = np.concatenate(([0.0 + 0.0j], _VERTS[1:6]))[:n_points]
        return np.column_stack((seed.real, seed.imag))

    # Largest L with 1 + 3L(L+1) <= n_points
    full_layers = int((np.sqrt(12 * n_points - 3) - 3) // 6)
    pts: list[complex] = [0.0 + 0.0j]
    for layer in range(1, full_layers + 1):
        pts += _ring(layer, [layer] * 6)

    leftover = n_points - len(pts)
    if leftover > 0:
        base, odd = divmod(leftover, 6)
        # Sides ranked by symmetry priority: opposite pairs first
        # (top-left/bottom-right, ...) so C3 holds, then C6.
        priority = (0, 3, 1, 4, 2, 5)
        counts = [base + (1 if odd > priority[s] else 0) for s in range(6)]
        pts += _ring(full_layers + 1, counts)

    zs = np.asarray(pts)
    return np.column_stack((zs.real, zs.imag))
