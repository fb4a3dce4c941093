"""Device dataclasses: the hardware specification layer.

Behavioral parity with reference
``pulser-core/pulser/devices/_device_datacls.py:86-1195``: same frozen
dataclasses, validation rules, C6/C3 lookup, blockade-radius math, and
spec pretty-printers.
"""

from __future__ import annotations

import functools
import json
import pprint
import warnings
from abc import ABC, abstractmethod
from collections import Counter
from collections.abc import Mapping
from dataclasses import dataclass, field, fields
from typing import Any, Callable, Literal, cast, get_args

import numpy as np
from scipy.spatial.distance import squareform

import pulser_tpu_torch
import pulser_tpu_torch.math as pm
from pulser_tpu_torch.channels.base_channel import (
    Channel,
    States,
    get_states_from_bases,
)
from pulser_tpu_torch.channels.dmm import DMM
from pulser_tpu_torch.devices.interaction_coefficients import c3_dict, c6_dict
from pulser_tpu_torch.exceptions import sequence as _seq_exc
from pulser_tpu_torch.exceptions.base import PulserValueError
from pulser_tpu_torch.json.abstract_repr.serializer import AbstractReprEncoder
from pulser_tpu_torch.json.abstract_repr.validation import validate_abstract_repr
from pulser_tpu_torch.json.utils import get_dataclass_defaults, obj_to_dict
from pulser_tpu_torch.noise_model import NoiseModel
from pulser_tpu_torch.register.base_register import BaseRegister, QubitId
from pulser_tpu_torch.register.mappable_reg import MappableRegister
from pulser_tpu_torch.register.register_layout import RegisterLayout
from pulser_tpu_torch.register.traps import COORD_PRECISION

DIMENSIONS = Literal[2, 3]

ALWAYS_OPTIONAL_PARAMS = (
    "max_sequence_duration",
    "max_runs",
    "optimal_layout_filling",
    "max_layout_traps",
)
OPTIONAL_IN_ABSTR_REPR = tuple(
    list(ALWAYS_OPTIONAL_PARAMS)
    + [
        "dmm_objects",
        "noise_model",
        "requires_layout",
        "accepts_new_layouts",
        "min_layout_traps",
        "min_layout_filling",
    ]
)
PARAMS_WITH_ABSTR_REPR = ("channel_objects", "channel_ids", "dmm_objects")

# Numeric device parameters checked for positivity in __post_init__.
# 'min_atom_distance' alone admits zero.
_BOUNDED_PARAMS = (
    "min_atom_distance",
    "max_atom_num",
    "max_radial_distance",
    "max_sequence_duration",
    "max_runs",
    "min_layout_traps",
    "max_layout_traps",
)


def _require_type(param: str, type_: type, value: Any) -> None:
    """Raises a uniform TypeError when ``value`` is not a ``type_``."""
    if not isinstance(value, type_):
        raise TypeError(
            f"{param} must be of type '{type_.__name__}', "
            f"not '{type(value).__name__}'."
        )


def _deep_tuple(obj: tuple | list) -> tuple:
    """Recursively converts lists to tuples."""
    if isinstance(obj, (tuple, list)):
        return tuple(_deep_tuple(el) for el in obj)
    return obj


@dataclass(frozen=True, repr=False)
class BaseDevice(ABC):
    r"""Base class of a neutral-atom device.

    Args:
        name: Device name.
        dimensions: 2 for planar arrays, 3 for volumetric ones.
        max_atom_num: Cap on the atom count of a register.
        max_radial_distance: How far from the array center an atom may
            sit (in μm).
        min_atom_distance: Smallest allowed spacing between two atoms
            (in μm).
        requires_layout: If set, sequences must use registers built from
            a register layout (a QPU-execution constraint).
        min_layout_traps: Lower bound on a layout's trap count.
        max_layout_traps: Optional upper bound on a layout's trap count.
        min_layout_filling: Lower bound on the filled fraction of a
            layout.
        max_layout_filling: Upper bound on the filled fraction of a
            layout.
        optimal_layout_filling: Optional recommended filled fraction for
            a layout.
        rydberg_level: Principal quantum number :math:`n` of the Rydberg
            level in use.
        channel_objects: The Channel instances available on the device.
        channel_ids: Optional custom IDs, one per channel object.
        dmm_objects: The device's DMM instances, addressed as
            "dmm_[index in dmm_objects]".
        supports_slm_mask: Whether an SLM mask is available.
        max_sequence_duration: Cap on a sequence's duration (in ns).
        max_runs: Cap on the number of runs per job.
        noise_model: Optional noise model describing the device's
            default noise.
    """

    name: str
    dimensions: DIMENSIONS
    rydberg_level: int
    min_atom_distance: float
    max_atom_num: int | None
    max_radial_distance: int | None
    supports_slm_mask: bool = False
    min_layout_filling: float = 0.0
    max_layout_filling: float = 0.5
    optimal_layout_filling: float | None = None
    min_layout_traps: int = 1
    max_layout_traps: int | None = None
    max_sequence_duration: int | None = None
    max_runs: int | None = None
    requires_layout: bool = False
    reusable_channels: bool = field(default=False, init=False)
    channel_ids: tuple[str, ...] | None = None
    channel_objects: tuple[Channel, ...] = field(default_factory=tuple)
    dmm_objects: tuple[DMM, ...] = field(default_factory=tuple)
    noise_model: NoiseModel | None = None
    short_description: str = field(default="", repr=False, compare=False)
    _custom_interaction_coeff_xy: None | float = field(
        default=None, repr=False, init=False
    )

    # -- Validation (construction time) ---------------------------------

    def _check_numeric_bound(self, param: str) -> None:
        value = getattr(self, param)
        may_be_none = (
            param in self._optional_parameters
            or param in ALWAYS_OPTIONAL_PARAMS
        )
        if value is None:
            if not may_be_none:
                raise TypeError(
                    f"'{param}' can't be None in a"
                    f" '{type(self).__name__}' instance."
                )
            return
        prelude = "When defined, " if may_be_none else ""
        if param == "min_atom_distance":
            if value >= 0:
                return
            comp = "greater than or equal to zero"
        else:
            _require_type(param, int, value)
            if value > 0:
                return
            comp = "greater than zero"
        raise ValueError(prelude + f"'{param}' must be {comp}, not {value}.")

    def _check_layout_params(self) -> None:
        if not (0.0 < self.max_layout_filling <= 1.0):
            raise ValueError(
                "The maximum layout filling fraction must be "
                "greater than 0. and less than or equal to 1., "
                f"not {self.max_layout_filling}."
            )

        if self.min_layout_filling is not None and not (
            0.0 <= self.min_layout_filling < self.max_layout_filling
        ):
            raise _seq_exc.MinimumLayoutFillingError(
                device=self,
                invalid=self.min_layout_filling,
            )

        if self.optimal_layout_filling is not None and not (
            self.min_layout_filling
            <= self.optimal_layout_filling
            <= self.max_layout_filling
        ):
            raise _seq_exc.OptimalLayoutFillingError(
                device=self,
                invalid=self.optimal_layout_filling,
            )

        if self.max_layout_traps is None:
            return
        if self.max_layout_traps < self.min_layout_traps:
            raise _seq_exc.MaxNumberOfTrapsError(device=self)
        if self.max_atom_num is not None:
            max_atoms_ = int(
                self.max_layout_filling * self.max_layout_traps
            )
            if max_atoms_ < self.max_atom_num:
                raise PulserValueError(
                    "With the given maximum layout filling and maximum"
                    f" number of traps, a layout supports at most"
                    f" {max_atoms_} atoms, which is less than the maximum"
                    f" number of atoms allowed ({self.max_atom_num})."
                )

    def _check_channels(self) -> None:
        for ch_obj in self.channel_objects:
            _require_type("All channels", Channel, ch_obj)
        for dmm_obj in self.dmm_objects:
            _require_type("All DMM channels", DMM, dmm_obj)
        if self.supports_slm_mask and not self.dmm_objects:
            raise PulserValueError(
                "One DMM object should be defined to support SLM mask."
            )

    def _resolve_channel_ids(self) -> None:
        if self.channel_ids is not None:
            if not (
                isinstance(self.channel_ids, (tuple, list))
                and all(isinstance(el, str) for el in self.channel_ids)
            ):
                raise TypeError(
                    "When defined, 'channel_ids' must be a tuple or a list"
                    " of strings."
                )
            if len(self.channel_ids) != len(set(self.channel_ids)):
                raise PulserValueError(
                    "When defined, 'channel_ids' can't have "
                    "repeated elements."
                )
            if len(self.channel_ids) != len(self.channel_objects):
                raise PulserValueError(
                    "When defined, the number of channel IDs must"
                    " match the number of channel objects."
                )
            if set(self.channel_ids) & set(self.dmm_channels.keys()):
                raise PulserValueError(
                    "When defined, the names of channel IDs must be"
                    " different than the names of DMM channels"
                    " 'dmm_0', 'dmm_1', ... ."
                )
            return
        # Derive IDs from each channel's default, suffixing duplicates
        ids_counter: Counter = Counter()
        ids = []
        for ch_obj in self.channel_objects:
            id = ch_obj.default_id()
            ids_counter.update([id])
            if ids_counter[id] > 1:
                id += f"_{ids_counter[id]}"
            ids.append(id)
        object.__setattr__(self, "channel_ids", tuple(ids))

    def __post_init__(self) -> None:
        _require_type("name", str, self.name)
        expected_dimensions = cast("list[DIMENSIONS]", get_args(DIMENSIONS))
        if self.dimensions not in expected_dimensions:
            raise _seq_exc.DimensionChoiceError(
                self, invalid=self.dimensions, expected=expected_dimensions
            )
        self._validate_rydberg_level(self.rydberg_level)

        for param in _BOUNDED_PARAMS:
            self._check_numeric_bound(param)

        _require_type(
            "supports_slm_mask", bool, self.supports_slm_mask
        )
        _require_type("reusable_channels", bool, self.reusable_channels)

        self._check_layout_params()
        self._check_channels()
        self._resolve_channel_ids()

        if self.noise_model is not None:
            _require_type("noise_model", NoiseModel, self.noise_model)
        _require_type("short_description", str, self.short_description)

        # Freeze any mutable channel collections into tuples
        for param in self._params():
            if "channel" in param or param == "dmm_objects":
                object.__setattr__(
                    self, param, _deep_tuple(getattr(self, param))
                )

        # Each instance documents itself with its own spec sheet
        object.__setattr__(self, "__doc__", self._specs(for_docs=True))

    @property
    @abstractmethod
    def _optional_parameters(self) -> tuple[str, ...]:
        pass

    def _validate_rydberg_level(self, ryd_lvl: int) -> None:
        if not isinstance(ryd_lvl, int):
            raise TypeError("Rydberg level has to be an int.")
        if not 49 < ryd_lvl < 101:
            raise _seq_exc.RydbergLevelError(
                device=self, min=50, max=100, invalid=ryd_lvl
            )

    # -- Channel / basis views -------------------------------------------

    @property
    def channels(self) -> dict[str, Channel]:
        """Dictionary of available channels on this device."""
        return dict(
            zip(cast(tuple, self.channel_ids), self.channel_objects)
        )

    @property
    def dmm_channels(self) -> dict[str, DMM]:
        """Dictionary of available DMM channels on this device."""
        return {
            f"dmm_{i}": dmm_obj
            for (i, dmm_obj) in enumerate(self.dmm_objects)
        }

    @property
    def supported_bases(self) -> set[str]:
        """Available electronic transitions for control and measurement."""
        return {ch.basis for ch in self.channel_objects}

    @property
    def supported_states(self) -> list[States]:
        """Available states ranked by their energy levels (highest 1st)."""
        return get_states_from_bases(self.supported_bases)

    @property
    def default_noise_model(self) -> NoiseModel | None:
        """Deprecated: use :attr:`noise_model` instead."""
        warnings.warn(
            "'default_noise_model' is deprecated, use 'noise_model'"
            " instead.",
            category=DeprecationWarning,
            stacklevel=2,
        )
        return self.noise_model

    # -- Interaction physics ----------------------------------------------

    @property
    def interaction_coeff(self) -> float:
        r"""The Ising interaction coefficient for the chosen Rydberg level.

        Corresponds to :math:`C_6/\hbar` (in rad·µs⁻¹·µm⁶) for the
        interaction term of the Ising hamiltonian.
        """
        return float(c6_dict[self.rydberg_level])

    @property
    def interaction_coeff_xy(self) -> float:
        r"""The XY interaction coefficient for the chosen Rydberg level.

        Corresponds to :math:`C_3/\hbar` (in rad·µs⁻¹·µm³) for the
        interaction term of the XY hamiltonian.
        """
        if self._custom_interaction_coeff_xy is not None:
            return self._custom_interaction_coeff_xy
        return float(c3_dict[self.rydberg_level])

    def rydberg_blockade_radius(self, rabi_frequency: float) -> float:
        """Blockade radius (μm) at a given Rabi frequency (rad/µs)."""
        return cast(
            float, (self.interaction_coeff / rabi_frequency) ** (1 / 6)
        )

    def rabi_from_blockade(self, blockade_radius: float) -> float:
        """Largest Rabi frequency (rad/µs) for a blockade radius (µm)."""
        return self.interaction_coeff / blockade_radius**6

    # -- Register / layout validation --------------------------------------

    def validate_register(self, register: BaseRegister) -> None:
        """Raises if 'register' is incompatible with this device."""
        if not isinstance(register, BaseRegister):
            raise TypeError(
                "'register' must be a pulser.Register or "
                "a pulser.Register3D instance."
            )

        if register.dimensionality > self.dimensions:
            raise _seq_exc.DimensionPositionsTooHighError(
                device=self,
                invalid=register.dimensionality,
            )
        self._validate_coords(register.qubits, kind="atoms")

        if register.layout is not None:
            try:
                self.validate_layout(register.layout)
            except (ValueError, TypeError) as e:
                raise PulserValueError(
                    "The 'register' is associated with an incompatible "
                    + "register layout."
                ) from e
            self.validate_layout_filling(register)

    def validate_layout(self, layout: RegisterLayout) -> None:
        """Raises if a register layout is incompatible with the device."""
        if not isinstance(layout, RegisterLayout):
            raise TypeError("'layout' must be a RegisterLayout instance.")

        n_traps = layout.number_of_traps
        trap_bounds = (
            (
                layout.dimensionality > self.dimensions,
                _seq_exc.DimensionTooHighError,
                dict(invalid=layout.dimensionality),
            ),
            (
                n_traps < self.min_layout_traps,
                _seq_exc.TrapsNumberTooLowError,
                dict(invalid=n_traps, layout=layout),
            ),
            (
                self.max_layout_traps is not None
                and n_traps > self.max_layout_traps,
                _seq_exc.TrapsNumberTooHighError,
                dict(invalid=n_traps, layout=layout),
            ),
        )
        for failed, exc, exc_kwargs in trap_bounds:
            if failed:
                raise exc(self, **exc_kwargs)

        self._validate_coords(layout.traps_dict, kind="traps")

    def validate_layout_filling(
        self, register: BaseRegister | MappableRegister
    ) -> None:
        """Raises if a layout-based register under- or over-fills it."""
        if register.layout is None:
            raise TypeError(
                "'validate_layout_filling' can only be called for"
                " registers with a register layout."
            )
        n_qubits = len(register.qubit_ids)
        n_traps = register.layout.number_of_traps
        min_qubits = int(np.ceil(n_traps * self.min_layout_filling))
        max_qubits = int(n_traps * self.max_layout_filling)
        if n_traps > self.min_layout_traps and n_qubits < min_qubits:
            raise _seq_exc.MinQubitNumberError(
                device=self,
                invalid=n_qubits,
                min=min_qubits,
                min_traps=self.min_layout_traps,
            )
        if n_qubits > max_qubits:
            raise _seq_exc.MaxQubitNumberError(
                device=self, invalid=n_qubits, max=max_qubits
            )

    def _validate_coords(
        self,
        coords_dict: (
            Mapping[QubitId, pm.AbstractArray] | Mapping[int, np.ndarray]
        ),
        kind: Literal["atoms", "traps"] = "atoms",
    ) -> None:
        ids = [str(id) for id in list(coords_dict.keys())]
        coords = list(map(pm.AbstractArray, coords_dict.values()))
        skip_count = (
            "max_atom_num" in self._optional_parameters
            and self.max_atom_num is None
        )
        if kind == "atoms" and not skip_count:
            self._validate_atom_number(coords)
        self._validate_atom_distance(ids, coords, kind)
        skip_radius = (
            "max_radial_distance" in self._optional_parameters
            and self.max_radial_distance is None
        )
        if not skip_radius:
            self._validate_radial_distance(ids, coords, kind)

    def _validate_atom_number(
        self, coords: list[pm.AbstractArray]
    ) -> None:
        max_atom_num = cast(int, self.max_atom_num)
        if len(coords) > max_atom_num:
            raise _seq_exc.AtomsNumberError(device=self, invalid=len(coords))

    def _validate_atom_distance(
        self,
        ids: list[QubitId],
        coords: list[pm.AbstractArray],
        kind: str,
    ) -> None:
        if len(coords) <= 1:
            return

        eps = 10 ** (-COORD_PRECISION)

        def invalid_dists(dists: np.ndarray) -> np.ndarray:
            too_close = dists - self.min_atom_distance < -eps
            # Coinciding traps are rejected even at min_atom_distance = 0
            coincide = dists < eps
            return cast(np.ndarray, np.logical_or(too_close, coincide))

        distances = pm.pdist(pm.vstack(coords)).as_array(detach=True)
        if not np.any(invalid_dists(distances)):
            return
        sq_dists = squareform(distances)
        mask = np.triu(np.ones(len(coords), dtype=bool), k=1)
        bad_pairs = np.argwhere(
            np.logical_and(invalid_dists(sq_dists), mask)
        )
        raise _seq_exc.DistanceError(
            device=self,
            kind=kind,
            precision_exp=COORD_PRECISION,
            invalid=[(ids[i], ids[j]) for i, j in bad_pairs],
        )

    def _validate_radial_distance(
        self,
        ids: list[QubitId],
        coords: list[pm.AbstractArray],
        kind: str,
    ) -> None:
        radii = np.linalg.norm(
            pm.vstack(coords).as_array(detach=True), axis=1
        )
        too_far = radii > self.max_radial_distance
        if np.any(too_far):
            assert self.max_radial_distance is not None
            raise _seq_exc.RadiusError(
                device=self,
                kind=kind,
                invalid=[ids[int(i)] for i in np.where(too_far)[0]],
            )

    # -- Serialization -----------------------------------------------------

    def _params(self, init_only: bool = False) -> dict[str, Any]:
        params = {
            f.name: getattr(self, f.name)
            for f in fields(self)
            if (not init_only or f.init) and f.name != "short_description"
        }
        if self._custom_interaction_coeff_xy is not None:
            params["interaction_coeff_xy"] = self.interaction_coeff_xy
        return params

    @abstractmethod
    def _to_dict(self) -> dict[str, Any]:
        pass

    @abstractmethod
    def _to_abstract_repr(self) -> dict[str, Any]:
        defaults = get_dataclass_defaults(fields(self))
        params = self._params(init_only=False)
        for p in OPTIONAL_IN_ABSTR_REPR:
            if p in params and params[p] == defaults[p]:
                params.pop(p, None)
        for p in PARAMS_WITH_ABSTR_REPR:
            params.pop(p, None)
        params.update(
            {
                "version": "1",
                "pulser_version": pulser_tpu_torch.__version__,
                "channels": [
                    ch_obj._to_abstract_repr(ch_name)
                    for ch_name, ch_obj in self.channels.items()
                ],
            }
        )
        dmm_list = [
            dmm_obj._to_abstract_repr(dmm_name)
            for dmm_name, dmm_obj in self.dmm_channels.items()
        ]
        if dmm_list:
            params["dmm_objects"] = dmm_list
        if "noise_model" in params:
            params["default_noise_model"] = params.pop("noise_model")
        params.pop("_custom_interaction_coeff_xy", None)
        params["interaction_coeff_xy"] = self.interaction_coeff_xy
        return params

    def to_abstract_repr(self) -> str:
        """Serializes the device into an abstract JSON object."""
        abstr_dev_str = json.dumps(self, cls=AbstractReprEncoder)
        validate_abstract_repr(abstr_dev_str, "device")
        return abstr_dev_str

    # -- Spec sheets ---------------------------------------------------------

    def __repr__(self) -> str:
        return self.name

    def print_specs(self) -> None:
        """Prints the device specifications."""
        title = f"{self.name} Specifications"
        rule = "-" * len(title)
        print("\n".join([rule, title, rule]))
        print(self._specs())

    @property
    def specs(self) -> str:
        """Text summarizing the specifications of the device."""
        return self._specs(for_docs=False)

    # Spec-sheet line tables. Row kinds: "opt" rows vanish when the
    # value is None; "yes_no" rows render booleans; "plain" rows
    # always render str(value). Values are produced by a callable on
    # the device so subclass properties resolve late.
    _REGISTER_SPEC_ROWS = (
        ("plain", " - Dimensions: {}D", lambda d: d.dimensions),
        (
            "opt",
            " - Maximum number of atoms: {}",
            lambda d: d.max_atom_num,
        ),
        (
            "opt",
            " - Maximum distance from origin: {} µm",
            lambda d: d.max_radial_distance,
        ),
        (
            "plain",
            " - Minimum distance between neighbouring atoms: {} μm",
            lambda d: d.min_atom_distance,
        ),
    )
    _LAYOUT_SPEC_ROWS = (
        ("yes_no", " - Requires layout: {}", lambda d: d.requires_layout),
        (
            "plain",
            " - Minimal number of traps: {}",
            lambda d: d.min_layout_traps,
        ),
        (
            "opt",
            " - Maximal number of traps: {}",
            lambda d: d.max_layout_traps,
        ),
        (
            "plain",
            " - Minimum layout filling fraction: {}",
            lambda d: d.min_layout_filling,
        ),
        (
            "plain",
            " - Maximum layout filling fraction: {}",
            lambda d: d.max_layout_filling,
        ),
    )
    _DEVICE_SPEC_ROWS = (
        ("plain", " - Rydberg level: {}", lambda d: d.rydberg_level),
        (
            "opt",
            " - Ising interaction coefficient: {}",
            lambda d: d.interaction_coeff,
        ),
        (
            "opt",
            " - XY interaction coefficient: {}",
            lambda d: d.interaction_coeff_xy,
        ),
        (
            "yes_no",
            " - Channels can be reused: {}",
            lambda d: d.reusable_channels,
        ),
        (
            "plain",
            " - Supported bases: {}",
            lambda d: ", ".join(d.supported_bases),
        ),
        (
            "plain",
            " - Supported states: {}",
            lambda d: ", ".join(d.supported_states),
        ),
        ("yes_no", " - SLM Mask: {}", lambda d: d.supports_slm_mask),
        (
            "opt",
            " - Maximum sequence duration: {} ns",
            lambda d: d.max_sequence_duration,
        ),
        ("opt", " - Maximum number of runs: {}", lambda d: d.max_runs),
        ("opt", " - Default noise model: {}", lambda d: d.noise_model),
    )

    def _render_spec_rows(self, title: str, rows: tuple) -> list[str]:
        out = [title]
        for kind, template, getter in rows:
            value = getter(self)
            if kind == "opt" and value is None:
                continue
            if kind == "yes_no":
                value = "Yes" if value is True else "No"
            out.append(template.format(value))
        return out

    def _register_lines(self) -> list[str]:
        return self._render_spec_rows(
            "\nRegister parameters:", self._REGISTER_SPEC_ROWS
        )

    def _layout_lines(self) -> list[str]:
        return self._render_spec_rows(
            "\nLayout parameters:", self._LAYOUT_SPEC_ROWS
        )

    def _device_lines(self) -> list[str]:
        return self._render_spec_rows(
            "\nDevice parameters:", self._DEVICE_SPEC_ROWS
        )

    @staticmethod
    def _rad_us(value: Any) -> str:
        """``"{value:.4g} rad/µs"``, or ``"None"`` when undefined."""
        return "None" if value is None else f"{float(value):.4g} rad/µs"

    def _one_channel_doc_lines(self, name: str, ch: Channel) -> list[str]:
        # Quirk kept from the reference: the Ω line also keys off
        # max_abs_detuning being defined.
        omega = (
            "None"
            if ch.max_abs_detuning is None
            else self._rad_us(cast(float, ch.max_amp))
        )
        if isinstance(ch, DMM):
            det_line = (
                "\t"
                + r"- Bottom :math:`|\delta|`: "
                + self._rad_us(ch.bottom_detuning)
            )
        else:
            det_line = (
                "\t"
                + r"- Maximum :math:`|\delta|`: "
                + self._rad_us(ch.max_abs_detuning)
            )
        local_rows = (
            (
                "\t- Minimum time between retargets:"
                f" {ch.min_retarget_interval} ns",
                f"\t- Fixed retarget time: {ch.fixed_retarget_t} ns",
                f"\t- Maximum simultaneous targets: {ch.max_targets}",
            )
            if ch.addressing == "Local"
            else ()
        )
        return [
            f" - ID: '{name}'",
            f"\t- Type: {ch.name} (*{ch.basis}* basis)",
            f"\t- Addressing: {ch.addressing}",
            "\t" + r"- Maximum :math:`\Omega`: " + omega,
            det_line,
            f"\t- Minimum average amplitude: {ch.min_avg_amp} rad/µs",
            *local_rows,
            f"\t- Clock period: {ch.clock_period} ns",
            f"\t- Minimum instruction duration: {ch.min_duration} ns",
        ]

    def _channel_lines(self, for_docs: bool = False) -> list[str]:
        ch_lines = ["\nChannels:"]
        for name, ch in {**self.channels, **self.dmm_channels}.items():
            if for_docs:
                ch_lines += self._one_channel_doc_lines(name, ch)
            else:
                ch_lines.append(f" - '{name}': {pprint.pformat(ch)}")
        return [line for line in ch_lines if line != ""]

    def _specs(self, for_docs: bool = False) -> str:
        intro = [self.short_description] if self.short_description else []
        return "\n".join(
            intro
            + self._register_lines()
            + self._layout_lines()
            + self._device_lines()
            + self._channel_lines(for_docs=for_docs)
        )


def _wrap_init_for_deprecated_args(
    original_init: Callable[..., Any],
) -> Callable[..., Any]:
    """Wrap __init__ to accept deprecated arguments.

    Supported deprecated parameters: default_noise_model and
    interaction_coeff_xy.
    """

    @functools.wraps(original_init)
    def wrapped_init(
        self: Any,
        *args: Any,
        default_noise_model: Any = None,
        interaction_coeff_xy: float | None = None,
        **kwargs: Any,
    ) -> None:
        if default_noise_model is not None:
            if kwargs.get("noise_model") is not None:
                raise ValueError(
                    "Cannot specify both 'noise_model' and "
                    "'default_noise_model'"
                )
            warnings.warn(
                "'default_noise_model' is deprecated, "
                "use 'noise_model' instead.",
                category=DeprecationWarning,
                stacklevel=2,
            )
            kwargs["noise_model"] = default_noise_model
        kwargs.pop("default_noise_model", None)
        original_init(self, *args, **kwargs)
        if interaction_coeff_xy is None:
            return
        warnings.warn(
            "The ability to set a custom 'interaction_coeff_xy' is "
            "deprecated and will be removed in the future.",
            category=DeprecationWarning,
            stacklevel=2,
        )
        try:
            interaction_coeff_xy = float(interaction_coeff_xy)
        except (TypeError, ValueError):
            raise TypeError(
                "When explicitly defined, "
                "'interaction_coeff_xy' must be castable to a 'float',"
                f" not '{type(interaction_coeff_xy)}'."
            )
        object.__setattr__(
            self, "_custom_interaction_coeff_xy", interaction_coeff_xy
        )

    return wrapped_init


BaseDevice.__init__ = _wrap_init_for_deprecated_args(  # type: ignore
    BaseDevice.__init__
)


@dataclass(frozen=True, repr=False)
class Device(BaseDevice):
    r"""Specifications of a physical neutral-atom device.

    Immutable, and every parameter must be defined. Convert to a
    VirtualDevice via `Device.to_virtual()` when a less constrained
    emulation target is needed.
    """

    max_atom_num: int
    max_radial_distance: int
    requires_layout: bool = True
    pre_calibrated_layouts: tuple[RegisterLayout, ...] = field(
        default_factory=tuple
    )
    accepts_new_layouts: bool = True

    def __post_init__(self) -> None:
        super().__post_init__()
        for ch_id, ch_obj in {
            **self.channels,
            **self.dmm_channels,
        }.items():
            if ch_obj.is_virtual():
                _sep = "', '"
                raise ValueError(
                    "A 'Device' instance cannot contain virtual channels."
                    f" For channel '{ch_id}', please define: "
                    f"'{_sep.join(ch_obj._undefined_fields())}'"
                )
        for layout in self.pre_calibrated_layouts:
            self.validate_layout(layout)

    @property
    def _optional_parameters(self) -> tuple[str, ...]:
        return ()

    @property
    def calibrated_register_layouts(self) -> dict[str, RegisterLayout]:
        """Register layouts already calibrated on this device."""
        return {
            str(layout): layout for layout in self.pre_calibrated_layouts
        }

    def is_calibrated_layout(self, register_layout: RegisterLayout) -> bool:
        """Checks whether a layout is within the calibrated layouts."""
        return any(
            register_layout == layout
            for layout in self.calibrated_register_layouts.values()
        )

    def register_is_from_calibrated_layout(
        self, register: BaseRegister | MappableRegister
    ) -> bool:
        """Checks if a register comes from a calibrated layout."""
        if not isinstance(register, (BaseRegister, MappableRegister)):
            raise TypeError(
                "The register to check must be of type "
                "BaseRegister or MappableRegister."
            )
        if isinstance(register, BaseRegister) and register.layout is None:
            return False
        return self.is_calibrated_layout(
            cast(RegisterLayout, register.layout)
        )

    def to_virtual(self) -> VirtualDevice:
        """Converts the Device into a VirtualDevice."""
        params = self._params()
        target_params_names = {
            f.name for f in fields(VirtualDevice) if f.init
        }
        # interaction_coeff_xy is no longer a field but might be custom
        target_params_names.add("interaction_coeff_xy")
        for param in set(params) - target_params_names:
            del params[param]
        return VirtualDevice(**params)

    def _to_dict(self) -> dict[str, Any]:
        return obj_to_dict(
            self,
            _build=False,
            _module="pulser_tpu_torch.devices",
            _name=self.name,
        )

    def _to_abstract_repr(self) -> dict[str, Any]:
        d = super()._to_abstract_repr()
        d["is_virtual"] = False
        return d

    @staticmethod
    def from_abstract_repr(obj_str: str) -> Device:
        """Deserialize a Device from an abstract JSON object.

        Raises an error if the JSON string represents a VirtualDevice
        (use VirtualDevice.from_abstract_repr for that).
        """
        if not isinstance(obj_str, str):
            raise TypeError(
                "The serialized Device must be given as a string. "
                f"Instead, got object of type {type(obj_str)}."
            )

        from pulser_tpu_torch.json.abstract_repr.deserializer import (
            deserialize_device,
        )

        device = deserialize_device(obj_str)
        if not isinstance(device, Device):
            raise TypeError(
                "The given schema is not related to a Device, but to a"
                f" {type(device).__name__}."
            )
        return device

    # Same rows as the base class, with "Accepts new layout" slotted
    # in right after "Requires layout".
    _LAYOUT_SPEC_ROWS = (
        BaseDevice._LAYOUT_SPEC_ROWS[:1]
        + (
            (
                "yes_no",
                " - Accepts new layout: {}",
                lambda d: d.accepts_new_layouts,
            ),
        )
        + BaseDevice._LAYOUT_SPEC_ROWS[1:]
    )


@dataclass(frozen=True)
class VirtualDevice(BaseDevice):
    r"""Specifications of a virtual neutral-atom device.

    Emulation-only device where some parameters may stay undefined.
    Channels may be declared repeatedly in one Sequence when
    `reusable_channels=True`, and the Rydberg level is mutable.
    """

    min_atom_distance: float = 0
    max_atom_num: int | None = None
    max_radial_distance: int | None = None
    supports_slm_mask: bool = True
    # A default DMM keeps SLM-mask support available out of the box
    dmm_objects: tuple[DMM, ...] = (DMM(),)
    reusable_channels: bool = True

    def __post_init__(self) -> None:
        super().__post_init__()

    @property
    def _optional_parameters(self) -> tuple[str, ...]:
        return ("max_atom_num", "max_radial_distance")

    def change_rydberg_level(self, ryd_lvl: int) -> None:
        r"""Switches the device's Rydberg level (must be in 50..100)."""
        self._validate_rydberg_level(ryd_lvl)
        object.__setattr__(self, "rydberg_level", ryd_lvl)

    def _to_dict(self) -> dict[str, Any]:
        return obj_to_dict(
            self,
            _module="pulser_tpu_torch.devices",
            **self._params(init_only=True),
        )

    def _to_abstract_repr(self) -> dict[str, Any]:
        d = super()._to_abstract_repr()
        d["is_virtual"] = True
        return d

    @staticmethod
    def from_abstract_repr(obj_str: str) -> VirtualDevice:
        """Deserialize a VirtualDevice from an abstract JSON object.

        If the JSON string represents a Device, it is converted into a
        VirtualDevice using `Device.to_virtual`.
        """
        if not isinstance(obj_str, str):
            raise TypeError(
                "The serialized VirtualDevice must be given as a string. "
                f"Instead, got object of type {type(obj_str)}."
            )

        from pulser_tpu_torch.json.abstract_repr.deserializer import (
            deserialize_device,
        )

        device = deserialize_device(obj_str)
        if isinstance(device, Device):
            return device.to_virtual()
        return device


# Patch __init__ to accept deprecated default_noise_model
Device.__init__ = _wrap_init_for_deprecated_args(  # type: ignore
    Device.__init__
)
VirtualDevice.__init__ = _wrap_init_for_deprecated_args(  # type: ignore
    VirtualDevice.__init__
)
