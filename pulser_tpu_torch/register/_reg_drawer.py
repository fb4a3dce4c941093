"""Matplotlib drawing mixin for registers and layouts.

Functional counterpart of reference
``pulser-core/pulser/register/_reg_drawer.py:33`` — renders atom/trap
positions, labels, blockade-radius circles and interaction graphs.
"""

from __future__ import annotations

from collections.abc import Mapping, Sequence
from itertools import combinations
from typing import TYPE_CHECKING, Optional

import numpy as np

if TYPE_CHECKING:
    from matplotlib.axes import Axes

    

class RegDrawer:
    """Mixin providing register drawing capabilities."""

    @staticmethod
    def _draw_checks(
        n_atoms: int,
        blockade_radius: Optional[float] = None,
        draw_graph: bool = True,
        draw_half_radius: bool = False,
    ) -> None:
        """Validates the drawing options."""
        if draw_half_radius:
            if blockade_radius is None:
                raise ValueError("Define 'blockade_radius' to draw.")
            if n_atoms < 2:
                raise NotImplementedError(
                    "Needs more than one atom to draw the blockade radius."
                )

    @staticmethod
    def _initialize_fig_axes(
        pos: np.ndarray,
        blockade_radius: Optional[float] = None,
        draw_half_radius: bool = False,
        nregisters: int = 1,
    ) -> tuple:
        """Creates the Figure and Axes for drawing the register."""
        import matplotlib.pyplot as plt

        pos = np.asarray(pos)
        diffs = np.ptp(pos, axis=0).astype(float)
        diffs[diffs < 9] *= 1.5
        diffs[diffs < 9] += 2
        if blockade_radius and draw_half_radius:
            diffs[diffs < blockade_radius] = blockade_radius
        big_side = max(diffs[:2]) if diffs.size >= 2 else diffs[0]
        proportions = diffs[:2] / big_side if diffs.size >= 2 else [1.0, 1.0]
        Ls = 4 + 4 * np.array(proportions)
        fig, axes = plt.subplots(
            nrows=nregisters,
            figsize=(Ls[0], Ls[1] * nregisters),
        )
        return fig, axes

    @staticmethod
    def _draw_2D(
        ax: Axes,
        pos: np.ndarray,
        ids: Sequence,
        plane: tuple = (0, 1),
        with_labels: bool = True,
        blockade_radius: Optional[float] = None,
        draw_graph: bool = True,
        draw_half_radius: bool = False,
        qubit_colors: Mapping = dict(),
        masked_qubits: set = set(),
        are_traps: bool = False,
        dmm_qubits: Mapping = dict(),
        label_name: str | None = None,
    ) -> None:
        """Draws a 2D register (or 2D projection) on the given axes."""
        import matplotlib.pyplot as plt
        from matplotlib.patches import Circle

        pos = np.asarray(pos)
        ix, iy = plane

        if are_traps:
            params = dict(s=50, edgecolors="black", facecolors="none")
        else:
            params = dict(s=30, c="darkgreen")

        if dmm_qubits:
            # Color traps by their weight
            weights = np.array(
                [dmm_qubits.get(id_, 0.0) for id_ in ids], dtype=float
            )
            max_weight = np.max(weights) if np.any(weights) else 1.0
            alphas = 0.2 + 0.8 * weights / max_weight
            for (x, y), alpha in zip(pos[:, (ix, iy)], alphas):
                ax.scatter(
                    [x], [y], s=50, edgecolors="black",
                    facecolors=(0.2, 0.2, 0.8, float(alpha)),
                )
        elif qubit_colors:
            colors = [
                qubit_colors.get(id_, "darkgreen") for id_ in ids
            ]
            ax.scatter(pos[:, ix], pos[:, iy], s=30, c=colors)
        else:
            ax.scatter(pos[:, ix], pos[:, iy], alpha=0.7, **params)

        # Highlight masked qubits
        if masked_qubits:
            mask_inds = [i for i, id_ in enumerate(ids) if id_ in masked_qubits]
            ax.scatter(
                pos[mask_inds, ix],
                pos[mask_inds, iy],
                marker="x",
                s=40,
                c="black",
            )

        ax.set_xlabel("µm")
        ax.set_ylabel("µm")
        ax.axis("equal")

        if with_labels:
            for q, coords in zip(ids, pos):
                ax.annotate(
                    str(q),
                    (coords[ix], coords[iy]),
                    fontsize=10,
                    ha="left",
                    va="bottom",
                )

        if draw_half_radius and blockade_radius is not None:
            for coords in pos:
                ax.add_patch(
                    Circle(
                        (coords[ix], coords[iy]),
                        blockade_radius / 2,
                        alpha=0.1,
                        color="darkgreen",
                    )
                )
        if draw_graph and blockade_radius is not None:
            epsilon = 1e-9  # Accounts for rounding errors
            edges = [
                (i, j)
                for i, j in combinations(range(len(pos)), 2)
                if np.linalg.norm(pos[i] - pos[j])
                <= blockade_radius * (1 + epsilon)
            ]
            for i, j in edges:
                ax.plot(
                    [pos[i][ix], pos[j][ix]],
                    [pos[i][iy], pos[j][iy]],
                    linewidth=1.0,
                    color="grey",
                )
        del plt  # only imported to ensure backend is initialized

    def _draw_3D(
        self,
        pos: np.ndarray,
        ids: Sequence,
        projection: bool = False,
        with_labels: bool = True,
        blockade_radius: Optional[float] = None,
        draw_graph: bool = True,
        draw_half_radius: bool = False,
        qubit_colors: Mapping = dict(),
        are_traps: bool = False,
    ) -> None:
        """Draws a 3D register, either in perspective or as projections."""
        import matplotlib.pyplot as plt

        pos = np.asarray(pos)
        if projection:
            labels = "xyz"
            fig, axes = plt.subplots(
                ncols=3, figsize=(12, 4), constrained_layout=True
            )
            for ax, (ix, iy) in zip(axes, combinations(range(3), 2)):
                self._draw_2D(
                    ax,
                    pos,
                    ids,
                    plane=(ix, iy),
                    with_labels=with_labels,
                    blockade_radius=blockade_radius,
                    draw_graph=draw_graph,
                    draw_half_radius=draw_half_radius,
                    qubit_colors=qubit_colors,
                    are_traps=are_traps,
                )
                ax.set_xlabel(labels[ix] + " (µm)")
                ax.set_ylabel(labels[iy] + " (µm)")
        else:
            fig = plt.figure(figsize=(8, 8))
            ax = fig.add_subplot(projection="3d")
            params = (
                dict(s=50, edgecolors="black", facecolors="none")
                if are_traps
                else dict(s=30, c="darkgreen")
            )
            ax.scatter(pos[:, 0], pos[:, 1], pos[:, 2], alpha=0.7, **params)
            if with_labels:
                for q, coords in zip(ids, pos):
                    ax.text(*coords, str(q), fontsize=10)
            if draw_graph and blockade_radius is not None:
                epsilon = 1e-9
                for i, j in combinations(range(len(pos)), 2):
                    if (
                        np.linalg.norm(pos[i] - pos[j])
                        <= blockade_radius * (1 + epsilon)
                    ):
                        ax.plot(
                            [pos[i][0], pos[j][0]],
                            [pos[i][1], pos[j][1]],
                            [pos[i][2], pos[j][2]],
                            linewidth=1.0,
                            color="grey",
                        )
            ax.set_xlabel("x (µm)")
            ax.set_ylabel("y (µm)")
            ax.set_zlabel("z (µm)")
