"""Maps of per-trap weights (e.g. detuning maps for DMM channels).

Behavioral parity with reference
``pulser-core/pulser/register/weight_maps.py:46-232``: qubits pick up
weight from spots either exactly (within coordinate precision) or via a
Gaussian crosstalk kernel exp(-d^2 / 2 w^2) when a spot waist is given.
"""

from __future__ import annotations

import typing
import warnings
from collections.abc import Iterator
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Mapping, Optional, TypeVar, cast

import numpy as np
from numpy.typing import ArrayLike
from scipy.spatial.distance import cdist

import pulser_tpu_torch.math as pm
from pulser_tpu_torch.json.utils import obj_to_dict
from pulser_tpu_torch.register._reg_drawer import RegDrawer
from pulser_tpu_torch.register.traps import COORD_PRECISION, Traps

if TYPE_CHECKING:
    from matplotlib.axes import Axes

    from pulser_tpu_torch.register.base_register import QubitId

WEIGHT_PRECISION = 6

WeightMapType = TypeVar("WeightMapType", bound="WeightMap")


def _checked_weights(
    weights: typing.Sequence[float], n_traps: int
) -> tuple[float, ...]:
    """Validates a weight list against its trap count."""
    if n_traps != len(weights):
        raise ValueError("Number of traps and weights don't match.")
    arr = np.array(weights)
    if arr.min(initial=0) < 0 or arr.max(initial=0) > 1:
        raise ValueError("All weights must be between 0 and 1.")
    if not arr.any():
        warnings.warn(
            "A WeightMap should have at least one non-zero weight.",
            stacklevel=4,
        )
    return tuple(weights)


@dataclass(init=False, repr=False, eq=False, frozen=True)
class WeightMap(Traps, RegDrawer):
    """Defines a generic map of weights on traps.

    Args:
        trap_coordinates: An array containing the coordinates of the traps.
        weights: A list of weights (between 0 and 1) to associate to the
            traps.
    """

    weights: tuple[float, ...]

    def __init__(
        self,
        trap_coordinates: ArrayLike,
        weights: typing.Sequence[float],
        slug: str | None = None,
    ) -> None:
        """Initializes a new weight map."""
        super().__init__(trap_coordinates, slug)
        object.__setattr__(
            self,
            "weights",
            _checked_weights(weights, len(cast(list, trap_coordinates))),
        )

    @property
    def trap_coordinates(self) -> np.ndarray:
        """The array of trap coordinates, in the order they were given."""
        return self._coords_arr.as_array(detach=True)

    @property
    def sorted_weights(self) -> np.ndarray:
        """The weights, reordered to follow the sorted trap coordinates."""
        rounded = np.round(self.weights, decimals=WEIGHT_PRECISION)
        return cast(np.ndarray, rounded[self._canonical_order])

    def get_qubit_weight_map(
        self,
        qubits: Mapping[QubitId, ArrayLike],
        spot_waist: float | None = None,
    ) -> dict[QubitId, float]:
        """Creates a map between qubit IDs and the weight on their sites.

        Each qubit's weight is the sum of spot weights seen through the
        spot response: a Gaussian of waist ``spot_waist`` when given,
        otherwise an exact-position indicator (coordinate precision).
        """
        positions = (
            pm.vstack(list(qubits.values()))
            .astype(float)
            .as_array(detach=True)
        )
        dists = cdist(positions, self.sorted_coords)
        if spot_waist:
            response = np.exp(-(dists**2) / (2 * spot_waist**2))
        else:
            # Exact match: within COORD_PRECISION in both x and y.
            response = dists < np.sqrt(2) * (10**-COORD_PRECISION)
        picked_up = response @ self.sorted_weights
        return dict(zip(qubits.keys(), picked_up))

    def with_pos_offset(
        self: WeightMapType, x_offset: float, y_offset: float
    ) -> WeightMapType:
        """Returns a new weight map with an offset on all coordinates.

        Args:
            x_offset: The shift along x, in µm.
            y_offset: The shift along y, in µm.
        """
        shifted = np.array(self.trap_coordinates)
        shifted[:, :2] += (x_offset, y_offset)
        return type(self)(
            trap_coordinates=shifted, weights=self.weights, slug=self.slug
        )

    def draw(
        self,
        labels: typing.Sequence[QubitId] | None = None,
        fig_name: str | None = None,
        kwargs_savefig: dict = {},
        custom_ax: Optional[Axes] = None,
        show: bool = True,
    ) -> None:
        """Draws the detuning map.

        Args:
            labels: If defined, writes the labels next to each site.
            fig_name: The name on which to save the figure, if any.
            kwargs_savefig: Keyword arguments for savefig.
            custom_ax: Optional pre-existing Axes to draw on.
            show: Whether to call ``plt.show()`` before returning.
        """
        import matplotlib.pyplot as plt

        pos = self.trap_coordinates
        if custom_ax is None:
            custom_ax = cast("Axes", self._initialize_fig_axes(pos)[1])

        shown_labels = (
            [str(i) for i in range(len(pos))] if labels is None else labels
        )
        super()._draw_2D(
            custom_ax,
            pos,
            shown_labels,
            with_labels=labels is not None,
            are_traps=True,
            dmm_qubits=dict(zip(shown_labels, self.weights)),
        )
        if fig_name is not None:
            plt.savefig(fig_name, **kwargs_savefig)
        if show:
            plt.show()

    def _hash_components(self) -> Iterator[bytes]:
        yield from super()._hash_components()
        # The weights and the concrete type are part of the identity.
        yield self.sorted_weights.tobytes()
        yield type(self).__name__.encode()

    def __repr__(self) -> str:
        return f"{type(self).__name__}_{self._safe_hash().hex()}"

    def _to_dict(self) -> dict[str, Any]:
        return obj_to_dict(
            self,
            trap_coordinates=self.trap_coordinates,
            weights=self.weights,
            slug=self.slug,
        )

    def _to_abstract_repr(self) -> dict[str, Any]:
        spots = [
            {"weight": w, "x": x, "y": y}
            for w, (x, y) in zip(self.sorted_weights, self.sorted_coords)
        ]
        out: dict[str, Any] = dict(traps=spots)
        if self.slug is not None:
            out["slug"] = self.slug
        return out


@dataclass(init=False, repr=False, eq=False, frozen=True)
class DetuningMap(WeightMap):
    """Defines a DetuningMap.

    A ``DetuningMap`` is associated to a ``DMM`` in a ``Sequence``. It
    links a set of weights to a set of trap coordinates. It is intended to
    be defined by the user from a ``RegisterLayout``, a ``Register`` or a
    ``MappableRegister`` using ``define_detuning_map``.

    Args:
        trap_coordinates: An array containing the coordinates of the traps.
        weights: A list of detuning weights (between 0 and 1) to associate
            to the traps.
    """
