"""The configuration of an array of neutral atoms in 2D.

Behavioral parity with reference
``pulser-core/pulser/register/register.py:43-581``. The lattice
constructors all funnel through one pattern-scaling helper; their
argument validation is table-driven.
"""

from __future__ import annotations

import warnings
from collections.abc import Mapping
from typing import TYPE_CHECKING, Any, Optional, Union, cast

import numpy as np
from numpy.typing import ArrayLike

import pulser_tpu_torch
import pulser_tpu_torch.math as pm
import pulser_tpu_torch.register._patterns as patterns
from pulser_tpu_torch.json.utils import stringify_qubit_ids
from pulser_tpu_torch.register._layout_gen import generate_trap_coordinates
from pulser_tpu_torch.register._reg_drawer import RegDrawer
from pulser_tpu_torch.register.base_register import BaseRegister, QubitId

if TYPE_CHECKING:
    from matplotlib.axes import Axes

    from pulser_tpu_torch.devices._device_datacls import BaseDevice, Device


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


class Register(BaseRegister, RegDrawer):
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
    def _scaled_pattern(
        cls,
        points: np.ndarray,
        scale: pm.AbstractArray,
        prefix: Optional[str],
        center: bool,
    ) -> Register:
        """Builds a register from unit-lattice points and a scale."""
        return cls.from_coordinates(
            pm.AbstractArray(points) * scale, center=center, prefix=prefix
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

    @classmethod
    def triangular_lattice(
        cls,
        rows: int,
        atoms_per_row: int,
        spacing: Union[float, pm.TensorLike] = 4.0,
        prefix: Optional[str] = None,
    ) -> Register:
        """Qubits on a triangular lattice, cut to a rectangle.

        Rows run horizontally; alternating rows are offset by half a
        site so triangles point up and down.

        Args:
            rows: How many rows.
            atoms_per_row: How many qubits in each row.
            spacing: Nearest-neighbour distance, in μm.
            prefix: Qubit ids become ``f"{prefix}{i}"`` when given.
        """
        _count_at_least_one(rows, "rows", "rows")
        _count_at_least_one(
            atoms_per_row, "atoms_per_row", "atoms per row"
        )
        return cls._scaled_pattern(
            patterns.triangular_rect(rows, atoms_per_row),
            _positive_spacing(spacing),
            prefix,
            center=True,
        )

    @classmethod
    def hexagon(
        cls,
        layers: int,
        spacing: Union[float, pm.TensorLike] = 4.0,
        prefix: Optional[str] = None,
    ) -> Register:
        """Qubits on a triangular lattice filling a hexagon.

        Args:
            layers: Complete rings placed around the central qubit.
            spacing: Nearest-neighbour distance, in μm.
            prefix: Qubit ids become ``f"{prefix}{i}"`` when given.
        """
        _count_at_least_one(layers, "layers", "layers")
        n_atoms = 1 + 3 * layers * (layers + 1)
        return cls._scaled_pattern(
            patterns.triangular_hex(n_atoms),
            _positive_spacing(spacing),
            prefix,
            center=False,
        )

    @classmethod
    def max_connectivity(
        cls,
        n_qubits: int,
        device: BaseDevice,
        spacing: Union[float, pm.TensorLike, None] = None,
        prefix: Optional[str] = None,
    ) -> Register:
        """The densest packing a device allows for a qubit count.

        Hexagonal rings of a triangular lattice grow around one central
        qubit, keeping C3 (then C6) rotational symmetry whenever the
        count allows it.

        Args:
            n_qubits: How many qubits to place.
            device: Its constraints bound the geometry.
            spacing: Nearest-neighbour distance, in μm; defaults to the
                device's minimal atom distance.
            prefix: Qubit ids become ``f"{prefix}{i}"`` when given.
        """
        if not isinstance(
            device, pulser_tpu_torch.devices._device_datacls.BaseDevice
        ):
            raise TypeError("'device' must be of type 'BaseDevice'.")
        _count_at_least_one(n_qubits, "n_qubits", "qubits")
        if (
            device.max_atom_num is not None
            and n_qubits > device.max_atom_num
        ):
            raise ValueError(
                f"The number of qubits (`n_qubits` = {n_qubits})"
                " must be less than or equal to the maximum"
                " number of atoms supported by this device"
                f" ({device.max_atom_num})."
            )

        if spacing is None:
            pitch = pm.AbstractArray(device.min_atom_distance)
        else:
            pitch = pm.AbstractArray(spacing)
            if pitch < device.min_atom_distance:
                raise ValueError(
                    f"Spacing between atoms (`spacing = `{spacing})"
                    " must be greater than or equal to the minimal"
                    " distance supported by this device"
                    f" ({device.min_atom_distance})."
                )
        if pitch <= 0.0:
            raise NotImplementedError(
                "Maximum connectivity layouts are not well defined for a "
                "device with 'min_atom_distance=0.0'."
            )
        return cls._scaled_pattern(
            patterns.triangular_hex(n_qubits), pitch, prefix, center=False
        )

    def with_automatic_layout(
        self,
        device: Device,
        layout_slug: str | None = None,
    ) -> Register:
        """Replicates the register with an automatically generated layout.

        Args:
            device: The device constraints for the layout generation.
            layout_slug: An optional slug for the generated layout.

        Raises:
            RuntimeError: If the automatic layout generation fails to meet
                the device constraints.
            NotImplementedError: When the register has differentiable
                coordinates.

        Returns:
            A new register instance with identical qubit IDs and
            coordinates and the newly generated RegisterLayout.
        """
        if not isinstance(device, pulser_tpu_torch.devices.Device):
            raise TypeError(
                f"'device' must be of type Device, not {type(device)}."
            )
        if self._coords_arr.requires_grad:
            raise NotImplementedError(
                "'Register.with_automatic_layout()' does not support "
                "registers with differentiable coordinates."
            )

        # A minimum filling fraction caps how many traps the layout may
        # have, but never below the device's minimum trap count.
        max_traps = device.max_layout_traps
        if device.min_layout_filling > 0.0:
            filling_cap = int(
                len(self.qubit_ids) / device.min_layout_filling
            )
            if filling_cap > device.min_layout_traps:
                max_traps = min(max_traps or filling_cap, filling_cap)

        trap_coords = generate_trap_coordinates(
            self.sorted_coords,
            min_trap_dist=device.min_atom_distance,
            max_radial_dist=device.max_radial_distance,
            max_layout_filling=device.max_layout_filling,
            optimal_layout_filling=device.optimal_layout_filling,
            min_traps=device.min_layout_traps,
            max_traps=max_traps,
        )
        layout = pulser_tpu_torch.register.RegisterLayout(
            trap_coords, slug=layout_slug
        )
        trap_ids = layout.get_traps_from_coordinates(
            *self._coords_arr.as_array()
        )
        return cast(
            Register,
            layout.define_register(*trap_ids, qubit_ids=self.qubit_ids),
        )

    def rotated(self, degrees: float) -> Register:
        """A copy of this register, turned about the origin.

        Args:
            degrees: Counter-clockwise rotation angle, in degrees.
        """
        if self.layout is not None:
            warnings.warn(
                "The rotated register won't have an associated "
                "'RegisterLayout'.",
                stacklevel=2,
            )
        theta = np.deg2rad(degrees)
        cos_t, sin_t = np.cos(theta), np.sin(theta)
        rot = pm.vstack([[cos_t, -sin_t], [sin_t, cos_t]])
        turned = (rot @ v for v in self._coords_arr)
        return Register(dict(zip(self.qubit_ids, turned)))

    def _get_empty_traps_reg(self) -> BaseRegister:
        """A Register containing the layout's empty traps."""
        if self.layout is None:
            raise ValueError(
                "The register must have an associated RegisterLayout "
                "to draw the empty sites."
            )
        occupied = set(
            self.layout.get_traps_from_coordinates(
                *tuple(self.qubits.values())
            )
        )
        vacant = [
            trap_id
            for trap_id in self.layout.traps_dict
            if trap_id not in occupied
        ]
        return self.layout.define_register(
            *vacant, qubit_ids=[str(trap_id) for trap_id in vacant]
        )

    def draw(
        self,
        with_labels: bool = True,
        blockade_radius: Optional[float] = None,
        draw_graph: bool = True,
        draw_half_radius: bool = False,
        qubit_colors: Mapping[QubitId, str] = dict(),
        fig_name: str | None = None,
        kwargs_savefig: dict = {},
        custom_ax: Optional[Axes] = None,
        show: bool = True,
        draw_empty_sites: bool = False,
    ) -> None:
        """Draws the entire register.

        Args:
            with_labels: If True, writes the qubit IDs next to each qubit.
            blockade_radius: The distance (in μm) between atoms below which
                the Rydberg blockade effect occurs.
            draw_half_radius: Whether to draw half the blockade radius
                around each atom (requires `blockade_radius`).
            draw_graph: Whether to draw the interaction between atoms as
                graph edges (requires `blockade_radius`).
            qubit_colors: Optional colors for specific atoms.
            fig_name: The name on which to save the figure, if any.
            kwargs_savefig: Keyword arguments for savefig.
            custom_ax: Optional pre-existing Axes to draw on.
            show: Whether to call `plt.show()` before returning.
            draw_empty_sites: If True, also draws the empty layout sites.
        """
        import matplotlib.pyplot as plt

        super()._draw_checks(
            len(self._ids),
            blockade_radius=blockade_radius,
            draw_graph=draw_graph,
            draw_half_radius=draw_half_radius,
        )

        pos = self._coords_arr.as_array(detach=True)
        vacant_reg = (
            self._get_empty_traps_reg() if draw_empty_sites else None
        )
        if custom_ax is None:
            # Frame the full layout when empty sites are drawn too.
            frame = (
                self.layout.sorted_coords
                if vacant_reg is not None and self.layout is not None
                else pos
            )
            custom_ax = cast(
                "Axes",
                self._initialize_fig_axes(
                    frame,
                    blockade_radius=blockade_radius,
                    draw_half_radius=draw_half_radius,
                )[1],
            )

        if vacant_reg is not None:
            super()._draw_2D(
                ids=vacant_reg.qubit_ids,
                pos=vacant_reg._coords_arr.as_array(detach=True),
                with_labels=False,
                label_name="empty",
                are_traps=True,
                ax=custom_ax,
            )

        super()._draw_2D(
            ids=self._ids,
            pos=pos,
            qubit_colors=qubit_colors,
            with_labels=with_labels,
            ax=custom_ax,
            blockade_radius=blockade_radius,
            draw_graph=draw_graph,
            draw_half_radius=draw_half_radius,
        )

        if fig_name is not None:
            plt.savefig(fig_name, **kwargs_savefig)
        if show:
            plt.show()

    def _to_dict(self) -> dict[str, Any]:
        return super()._to_dict()

    def _to_abstract_repr(self) -> list[dict[str, Union[QubitId, float]]]:
        names = stringify_qubit_ids(self._ids)
        return [
            {"name": name, "x": x, "y": y}
            for name, (x, y) in zip(names, self._coords_arr.tolist())
        ]

    @staticmethod
    def from_abstract_repr(obj_str: str) -> Register:
        """Deserialize a register from an abstract JSON object.

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

        return deserialize_abstract_register(obj_str, expected_dim=2)
