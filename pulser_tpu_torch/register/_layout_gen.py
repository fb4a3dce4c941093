"""Automatic trap-layout generation around an existing register.

Behavioral parity with reference
``pulser-core/pulser/register/_layout_gen.py:20``: a candidate mesh
covering the allowed disk is thinned greedily, always picking the
remaining point closest to an atom, until the filling targets hold.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.distance import cdist


def _disk_mesh(radius: float, resolution: float) -> np.ndarray:
    """Candidate points: a square mesh clipped to the allowed disk."""
    axis = np.linspace(0, 2 * radius, num=int(2 * radius / resolution))
    axis -= radius
    n = len(axis)
    pts = np.column_stack((np.tile(axis, n), np.repeat(axis, n)))
    return pts[(pts**2).sum(axis=1) <= radius**2]


def generate_trap_coordinates(
    atom_coords: np.ndarray,
    min_trap_dist: float,
    max_radial_dist: int,
    max_layout_filling: float,
    optimal_layout_filling: float | None = None,
    mesh_resolution: float = 1.0,
    min_traps: int = 1,
    max_traps: int | None = None,
) -> list[np.ndarray]:
    """Generates trap coordinates for a collection of atom coordinates.

    Generates a mesh of resolution `mesh_resolution` covering a disk of
    radius `max_radial_dist`.  Deletes all the points of the mesh that are
    within `min_trap_dist` of any atoms or traps and iteratively selects
    from the remaining points the necessary number of traps such that the
    ratio of atoms to traps is at most max_layout_filling and as close as
    possible to optimal_layout_filling, while being above min_traps and
    below max_traps.

    Args:
        atom_coords: The coordinates where atoms will be placed.
        min_trap_dist: The minimum distance between traps, in µm.
        max_radial_dist: The maximum distance from the origin, in µm.
        max_layout_filling: The maximum ratio of atoms to traps.
        optimal_layout_filling: An optional value for the optimal ratio of
            atoms to traps. If not given, takes max_layout_filling.
        mesh_resolution: The spacing between points in the mesh of
            candidate coordinates, in µm.
        min_traps: The minimum number of traps in the resulting layout.
        max_traps: The maximum number of traps in the resulting layout.
    """
    optimal_layout_filling = optimal_layout_filling or max_layout_filling
    assert optimal_layout_filling <= max_layout_filling
    assert max_traps is None or min_traps <= max_traps

    candidates = _disk_mesh(max_radial_dist, mesh_resolution)
    traps: list[np.ndarray] = list(atom_coords)
    n_atoms = len(traps)

    # How many traps we must have / would ideally have:
    need = max(np.ceil(n_atoms / max_layout_filling).astype(int), min_traps)
    want = max(
        np.round(n_atoms / optimal_layout_filling).astype(int), need
    )
    if max_traps:
        want = min(want, max_traps)

    # Distance from every candidate to its nearest atom drives the
    # greedy choice; a running mask tracks which candidates are still
    # far enough from every placed trap.
    dists_to_atoms = cdist(candidates, traps)
    open_sites = np.all(dists_to_atoms > min_trap_dist, axis=1)
    closest_atom = np.min(dists_to_atoms, axis=1)

    for _ in range(want - n_atoms):
        if not open_sites.any():
            break
        ranking = np.where(open_sites, closest_atom, np.inf)
        pick = int(np.argmin(ranking))
        traps.append(candidates[pick])
        to_new_trap = cdist(candidates, [candidates[pick]])[:, 0]
        open_sites &= to_new_trap > min_trap_dist

    if len(traps) < need:
        raise RuntimeError(
            f"Failed to find a site for {need - len(traps)} traps."
        )
    return traps
