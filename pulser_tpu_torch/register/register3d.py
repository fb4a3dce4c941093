"""The configuration of an array of neutral atoms in 3D.

Behavioral parity with reference
``pulser-core/pulser/register/register3d.py:35``.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Optional, Union

import numpy as np
from numpy.typing import ArrayLike

import pulser_tpu_torch.math as pm
from pulser_tpu_torch.json.utils import stringify_qubit_ids
from pulser_tpu_torch.register._patterns import square_rect
from pulser_tpu_torch.register._reg_drawer import RegDrawer
from pulser_tpu_torch.register.base_register import BaseRegister, QubitId
from pulser_tpu_torch.register.register import (
    Register,
    _count_at_least_one,
    _positive_spacing,
)


class Register3D(BaseRegister, RegDrawer):
    """A set of named qubits at fixed positions in space.

    Args:
        qubits: Maps each qubit's name to its (x, y, z) position, in μm.
    """

    def __init__(
        self,
        qubits: Mapping[Any, Union[ArrayLike, pm.TensorLike]],
        **kwargs: Any,
    ):
        """Initializes a custom Register."""
        super().__init__(qubits, **kwargs)
        coords_3d = self.dimensionality == 3 and all(
            c.shape == (3,) for c in self._coords_arr
        )
        if not coords_3d:
            raise ValueError(
                "All coordinates must be specified as vectors of size 3."
            )

    @classmethod
    def cubic(
        cls,
        side: int,
        spacing: Union[float, pm.TensorLike] = 4.0,
        prefix: Optional[str] = None,
    ) -> Register3D:
        """A side x side x side cubic array of qubits.

        Args:
            side: How many qubits long the cube's edge is.
            spacing: Nearest-neighbour distance, in μm.
            prefix: Qubit ids become ``f"{prefix}{i}"`` when given.
        """
        _count_at_least_one(side, "side", "atoms per side")
        return cls.cuboid(side, side, side, spacing=spacing, prefix=prefix)

    @classmethod
    def cuboid(
        cls,
        rows: int,
        columns: int,
        layers: int,
        spacing: Union[float, pm.TensorLike] = 4.0,
        prefix: Optional[str] = None,
    ) -> Register3D:
        """A rows x columns x layers cuboid array of qubits.

        Args:
            rows: How many rows.
            columns: How many columns.
            layers: How many planes stacked along z.
            spacing: Nearest-neighbour distance, in μm.
            prefix: Qubit ids become ``f"{prefix}{i}"`` when given.
        """
        _count_at_least_one(rows, "rows", "rows")
        _count_at_least_one(columns, "columns", "columns")
        _count_at_least_one(layers, "layers", "layers")
        pitch = _positive_spacing(spacing)

        # Stack `layers` uncentered square-lattice planes along z.
        plane = square_rect(rows, columns)
        plane -= plane.min(axis=0)  # undo the pattern's centering
        n_plane = len(plane)
        points = np.column_stack(
            (
                np.tile(plane, (layers, 1)),
                np.repeat(np.arange(layers, dtype=float), n_plane),
            )
        )
        return cls.from_coordinates(
            pm.AbstractArray(points) * pitch, center=True, prefix=prefix
        )

    def to_2D(self, tol_width: float = 0.0) -> Register:
        """Projects coplanar atoms down to a 2D register.

        Args:
            tol_width: How much out-of-plane spread (µm) to tolerate.

        Returns:
            The atoms re-expressed in their best-fit plane, as a 2D
            register.

        Raises:
            ValueError: If the atoms are not coplanar.
        """
        coords = self._coords_arr.as_array(detach=True)
        centered = coords - coords.mean(axis=0)
        # The plane's frame: SVD right-singular vectors, normal last.
        _, _, basis = np.linalg.svd(centered)
        width = np.ptp(coords @ basis[2])
        if width > tol_width:
            raise ValueError(
                f"Atoms are not coplanar (`width` = {width:#.2f} µm)"
            )
        in_plane = pm.vstack(
            [
                pm.hstack([pm.dot(basis[0], r), pm.dot(basis[1], r)])
                for r in self._coords_arr
            ]
        )
        return Register.from_coordinates(in_plane, labels=self._ids)

    def draw(
        self,
        with_labels: bool = False,
        blockade_radius: Optional[float] = None,
        draw_graph: bool = True,
        draw_half_radius: bool = False,
        qubit_colors: Mapping[QubitId, str] = dict(),
        projection: bool = False,
        fig_name: str | None = None,
        kwargs_savefig: dict = {},
    ) -> None:
        """Draws the entire register.

        Args:
            with_labels: If True, writes the qubit IDs next to each qubit.
            blockade_radius: The distance (in μm) between atoms below which
                the Rydberg blockade effect occurs.
            draw_half_radius: Whether to draw half the blockade radius
                around each atom.
            draw_graph: Whether to draw atom interactions as graph edges.
            qubit_colors: Optional colors for specific atoms.
            projection: Whether to draw a 2D projection instead of a
                perspective view.
            fig_name: The name on which to save the figure, if any.
            kwargs_savefig: Keyword arguments for savefig.
        """
        import matplotlib.pyplot as plt

        super()._draw_checks(
            len(self._ids),
            blockade_radius=blockade_radius,
            draw_graph=draw_graph,
            draw_half_radius=draw_half_radius,
        )
        self._draw_3D(
            self._coords_arr.as_array(detach=True),
            self._ids,
            projection=projection,
            with_labels=with_labels,
            blockade_radius=blockade_radius,
            draw_graph=draw_graph,
            draw_half_radius=draw_half_radius,
            qubit_colors=qubit_colors,
        )
        if fig_name is not None:
            plt.savefig(fig_name, **kwargs_savefig)
        plt.show()

    def _to_dict(self) -> dict[str, Any]:
        return super()._to_dict()

    def _to_abstract_repr(self) -> list[dict[str, Union[QubitId, float]]]:
        names = stringify_qubit_ids(self._ids)
        return [
            {"name": name, "x": x, "y": y, "z": z}
            for name, (x, y, z) in zip(names, self._coords_arr.tolist())
        ]

    @staticmethod
    def from_abstract_repr(obj_str: str) -> Register3D:
        """Deserialize a 3D register from an abstract JSON object.

        Args:
            obj_str: the JSON string representing the register encoded in
                the abstract JSON format.
        """
        if not isinstance(obj_str, str):
            raise TypeError(
                "The serialized register must be given as a string. "
                f"Instead, got object of type {type(obj_str)}."
            )
        from pulser_tpu_torch.json.abstract_repr.deserializer import (
            deserialize_abstract_register,
        )

        return deserialize_abstract_register(obj_str, expected_dim=3)
