"""Errors raised because a sequence is invalid.

API parity with reference
``pulser-core/pulser/exceptions/sequence.py:18-302`` (same class
hierarchy and message texts). Unlike the reference's per-class
``__str__`` methods, each class declares a message *template* and a
single shared formatter renders it against the dataclass fields.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, ClassVar, Optional, Sequence

from pulser_tpu_torch.exceptions.base import PulserValueError

if TYPE_CHECKING:
    from pulser_tpu_torch.devices._device_datacls import BaseDevice
    from pulser_tpu_torch.register.base_register import QubitId
    from pulser_tpu_torch.register.register_layout import RegisterLayout


@dataclass
class InvalidSequenceError(PulserValueError):
    """Attempting to define an invalid sequence."""

    device: BaseDevice

    #: Message template, rendered against ``self`` (so fields and
    #: properties are reachable as ``{self.x}`` / ``{self.device.x}``)
    _template: ClassVar[Optional[str]] = None

    def __str__(self) -> str:
        if self._template is None:
            return super().__str__()
        return self._template.format(self=self)


@dataclass
class DimensionError(InvalidSequenceError):
    """An error with the number of dimensions."""

    invalid: int


@dataclass
class DimensionChoiceError(DimensionError):
    """The number of dimensions is not among the allowed choices."""

    expected: Sequence[int]

    _template = (
        "'dimensions' must be one of {self.expected}, "
        "not {self.invalid}."
    )


@dataclass
class DimensionTooHighError(DimensionError):
    """The layout's dimensionality exceeds the device's."""

    _template = (
        "The device supports register layouts of at most "
        "{self.device.dimensions} dimensions."
    )


@dataclass
class DimensionPositionsTooHighError(DimensionError):
    """A qubit position's dimensionality exceeds the device's."""

    _template = (
        "All qubit positions must be at most "
        "{self.device.dimensions}D vectors"
    )


@dataclass
class TrapsNumberError(InvalidSequenceError):
    """An error in the number of traps."""

    invalid: int
    layout: RegisterLayout


@dataclass
class TrapsNumberTooLowError(TrapsNumberError):
    """Not enough traps."""

    _template = (
        "The device requires register layouts to have "
        "at least {self.device.min_layout_traps} traps; "
        "{self.layout!s} has only {self.invalid}."
    )


@dataclass
class TrapsNumberTooHighError(TrapsNumberError):
    """Too many traps."""

    _template = (
        "The device requires register layouts to have "
        "at most {self.device.max_layout_traps} traps; "
        "{self.layout!s} has {self.invalid}."
    )


@dataclass
class QubitsNumberError(InvalidSequenceError):
    """An error in the number of qubits."""


@dataclass
class MinQubitNumberError(QubitsNumberError):
    """Too few qubits for the layout."""

    invalid: int
    min: int
    min_traps: int = 0

    _template = (
        "Given the number of traps in the layout and the "
        "device's minimum layout filling fraction, the given"
        " register has too few qubits ({self.invalid}). "
        "On this device, this layout must hold at least "
        "{self.min} qubits. Note that arbitrarily small "
        "registers can still be created if the layout has "
        "exactly the minimum number of traps allowed"
        "{self._traps_note}."
    )

    @property
    def _traps_note(self) -> str:
        return f" ({self.min_traps})" if self.min_traps else ""


@dataclass
class MaxQubitNumberError(QubitsNumberError):
    """Too many qubits for the layout."""

    invalid: int
    max: int

    _template = (
        "Given the number of traps in the layout and the "
        "device's maximum layout filling fraction, the given"
        " register has too many qubits ({self.invalid}). "
        "On this device, this layout can hold at most "
        "{self.max} qubits."
    )


@dataclass
class AtomsNumberError(InvalidSequenceError):
    """An error in the number of atoms."""

    invalid: int

    _template = (
        "The number of atoms ({self.invalid})"
        " must be less than or equal to the maximum"
        " number of atoms supported by this device"
        " ({self.device.max_atom_num})."
    )


@dataclass
class DistanceError(InvalidSequenceError):
    """An error in the distance between two atoms, traps, etc."""

    kind: str
    precision_exp: int
    invalid: list[tuple[QubitId, QubitId]]

    _template = (
        "The minimal distance between {self.kind} in this device "
        "({self.device.min_atom_distance} µm) is not respected "
        "(up to a precision of 1e{self._neg_exp} µm) "
        "for the pairs: {self.invalid}"
    )

    @property
    def _neg_exp(self) -> int:
        return -self.precision_exp


@dataclass
class RadiusError(InvalidSequenceError):
    """Something is too far from the center of the device."""

    kind: str
    invalid: list[QubitId]

    _template = (
        "All {self.kind} must be at most "
        "{self.device.max_radial_distance} μm away from the center"
        " of the array, which is not the case "
        "for: {self.invalid}"
    )


@dataclass
class RydbergLevelError(InvalidSequenceError):
    """Invalid Rydberg Level."""

    invalid: int
    min: int
    max: int

    _template = (
        "Rydberg level should be between {self.min} and {self.max}."
    )


@dataclass
class OptimalLayoutFillingError(InvalidSequenceError):
    """Invalid optimal layout filling."""

    invalid: float

    _template = (
        "When defined, the optimal layout filling fraction "
        "must be greater than or equal to `min_layout_filling` "
        "({self.device.min_layout_filling}) and less than or equal to "
        "`max_layout_filling` ({self.device.max_layout_filling}), "
        "not {self.invalid}."
    )


@dataclass
class MinimumLayoutFillingError(InvalidSequenceError):
    """Invalid minimum layout filling."""

    invalid: float

    _template = (
        "The minimum layout filling fraction must be greater than "
        "or equal to 0. and less than `max_layout_filling` "
        "({self.device.max_layout_filling}), not {self.invalid}."
    )


@dataclass
class MaxNumberOfTrapsError(InvalidSequenceError):
    """Invalid min/max number of traps."""

    _template = (
        "The maximum number of layout traps "
        "({self.device.max_layout_traps}) must be greater than "
        "or equal to the minimum number of layout traps "
        "({self.device.min_layout_traps})."
    )


class SwitchDeviceError(PulserValueError):
    """Error trying to switch the device of a Sequence."""
