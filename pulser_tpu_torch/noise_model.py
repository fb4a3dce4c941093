"""A noise model class for emulator backends.

Behavioral parity with reference
``pulser-core/pulser/noise_model.py:37-960``: 12 noise types, parameter
registry, automatic noise-type derivation from non-default parameters,
validation, serialization round trip and human-readable summaries.
"""

from __future__ import annotations

import json
import math
import warnings
from collections.abc import Collection, Sequence
from dataclasses import dataclass, field, fields
from typing import Any, Literal, Union, cast, get_args

import numpy as np
from numpy.typing import ArrayLike
import torch

import pulser_tpu_torch.math as pm
from pulser_tpu_torch.constants import KB, KEFF, MASS, TRAP_WAVELENGTH
from pulser_tpu_torch.json.abstract_repr.serializer import AbstractReprEncoder
from pulser_tpu_torch.json.abstract_repr.validation import validate_abstract_repr
from pulser_tpu_torch.json.utils import get_dataclass_defaults

__all__ = ["NoiseModel"]

#: Variadic float tuples (PSD series, Lindblad rates).
_FloatTuple = tuple[float, ...]

NoiseTypes = Literal[
    "leakage",
    "doppler",
    "amplitude",
    "detuning",
    "register",
    "SPAM",
    "dephasing",
    "relaxation",
    "depolarizing",
    "eff_noise",
    "dmm_sigma",
    "dmm_crosstalk",
]


class _ParamSpec:
    """One row of the parameter registry.

    Unlike the reference, which keeps six parallel structures
    (``_NOISE_TYPE_PARAMS``, the validation-kind sets, the legacy
    defaults, the optional-in-wire-format tuple), every fact about a
    parameter lives in its single registry row here; the reference's
    structures are derived below for the shared validation code.
    """

    __slots__ = ("noise", "kind", "legacy", "optional_wire")

    def __init__(
        self,
        noise: NoiseTypes | None,
        kind: str,
        legacy: float | int | None = None,
        optional_wire: bool = False,
    ) -> None:
        self.noise = noise
        self.kind = kind  # pos | strict_pos | prob | bool | raw
        self.legacy = legacy
        self.optional_wire = optional_wire


# Parameter name -> (owning noise type, validation kind, legacy
# default, optional in the abstract repr). Rows are grouped by owner;
# within a group the order fixes the reference's per-noise tuples.
_PARAMS: dict[str, _ParamSpec] = {
    "with_leakage": _ParamSpec("leakage", "bool"),
    "temperature": _ParamSpec("doppler", "pos", 50.0),
    "trap_waist": _ParamSpec("register", "pos", optional_wire=True),
    "trap_depth": _ParamSpec(
        "register", "strict_pos", optional_wire=True
    ),
    "laser_waist": _ParamSpec("amplitude", "strict_pos", 175.0),
    "amp_sigma": _ParamSpec("amplitude", "prob", 5e-2),
    "detuning_sigma": _ParamSpec(
        "detuning", "pos", optional_wire=True
    ),
    "detuning_hf_psd": _ParamSpec(
        "detuning", "raw", optional_wire=True
    ),
    "detuning_hf_omegas": _ParamSpec(
        "detuning", "raw", optional_wire=True
    ),
    "p_false_pos": _ParamSpec("SPAM", "prob", 0.01),
    "p_false_neg": _ParamSpec("SPAM", "prob", 0.05),
    "state_prep_error": _ParamSpec("SPAM", "prob", 0.005),
    "dephasing_rate": _ParamSpec("dephasing", "pos", 0.05),
    "hyperfine_dephasing_rate": _ParamSpec(
        "dephasing", "pos", 1e-3
    ),
    "relaxation_rate": _ParamSpec("relaxation", "pos", 0.01),
    "depolarizing_rate": _ParamSpec("depolarizing", "pos", 0.05),
    "eff_noise_rates": _ParamSpec("eff_noise", "raw"),
    "eff_noise_opers": _ParamSpec("eff_noise", "raw"),
    "dmm_sigma": _ParamSpec(
        "dmm_sigma", "prob", optional_wire=True
    ),
    "detuning_map_spot_waist": _ParamSpec(
        "dmm_crosstalk", "strict_pos", optional_wire=True
    ),
    # Owned by no noise type:
    "runs": _ParamSpec(None, "strict_pos", 15),
    "samples_per_run": _ParamSpec(None, "strict_pos", 5),
    "disable_doppler": _ParamSpec(None, "bool"),
}

# The noise-type order of the reference's registry (which differs
# from the NoiseTypes literal order) is preserved for stable
# iteration in reports.
_NOISE_TYPE_PARAMS: dict[NoiseTypes, tuple[str, ...]] = {
    nt: tuple(
        name for name, spec in _PARAMS.items() if spec.noise == nt
    )
    for nt in (
        "leakage",
        "doppler",
        "register",
        "amplitude",
        "detuning",
        "SPAM",
        "dephasing",
        "relaxation",
        "depolarizing",
        "eff_noise",
        "dmm_sigma",
        "dmm_crosstalk",
    )
}

_PARAM_TO_NOISE_TYPE: dict[str, NoiseTypes] = {
    name: spec.noise
    for name, spec in _PARAMS.items()
    if spec.noise is not None
}


def _params_of_kind(kind: str) -> set[str]:
    return {
        name for name, spec in _PARAMS.items() if spec.kind == kind
    }


_POSITIVE = _params_of_kind("pos")
_STRICT_POSITIVE = _params_of_kind("strict_pos")
_PROBABILITY_LIKE = _params_of_kind("prob")
_BOOLEAN = _params_of_kind("bool")

_LEGACY_DEFAULTS: dict[str, float | int] = {
    name: spec.legacy
    for name, spec in _PARAMS.items()
    if spec.legacy is not None
}

OPTIONAL_IN_ABSTR_REPR = tuple(
    name for name, spec in _PARAMS.items() if spec.optional_wire
)

# Noise types whose activation makes trajectory counts meaningful
_TRAJ_SENSITIVE: set[NoiseTypes] = {
    "doppler",
    "detuning",
    "register",
    "dmm_sigma",
}


def _doppler_sigma(temperature: float) -> float:
    """Standard deviation of Doppler shifting due to thermal motion.

    Args:
        temperature: The temperature in K.
    """
    return KEFF * math.sqrt(KB * temperature / MASS)


def _register_sigma_xy_z(
    temperature: float, trap_waist: float, trap_depth: float
) -> tuple[float, float]:
    """Standard deviations of atom position fluctuations in the trap.

    - Plane fluctuation: σxy = √(T w²/(4 Utrap)).
    - Off-plane fluctuation: σz = (π/λ)·√2·w·σxy (λ the trap wavelength).

    A k_B factor is absorbed in the trap depth, so the units of
    temperature and trap depth are the same.
    """
    register_sigma_xy = math.sqrt(
        temperature * trap_waist**2 / (4 * trap_depth)
    )
    register_sigma_z = (
        math.pi
        / TRAP_WAVELENGTH
        * math.sqrt(2)
        * trap_waist
        * register_sigma_xy
    )
    return register_sigma_xy, register_sigma_z


def _as_plain_tuple(obj: Any) -> Any:
    """Recursively converts array-likes to nested plain tuples."""
    if isinstance(obj, pm.AbstractArray):
        obj = obj.as_array(detach=True)
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    if isinstance(obj, (tuple, list, np.ndarray)):
        return tuple(_as_plain_tuple(el) for el in obj)
    return obj


def _register_noise_rows(nm: NoiseModel) -> list[tuple[str, Any, str]]:
    sigma_xy, sigma_z = _register_sigma_xy_z(
        nm.temperature * 1e-6,
        nm.trap_waist,
        cast(float, nm.trap_depth),
    )
    return [
        ("register_sigma_xy", sigma_xy, "µm"),
        ("register_sigma_z", sigma_z, "µm"),
    ]


# Declarative spec for get_noise_table(): (gate kind, gate argument,
# row producer). Gate kinds — "type": the named noise type is active;
# "pos": the named attribute is a positive number (None counts as
# absent); "len": the named attribute is non-empty; "truthy": plain
# bool(). Producers return (key, value, unit) rows.
_NOISE_TABLE_SPEC: tuple = (
    ("type", "register", _register_noise_rows),
    ("pos", "state_prep_error", lambda nm: [
        ("state_prep_error", nm.state_prep_error, ""),
    ]),
    ("pos", "laser_waist", lambda nm: [
        ("laser_waist", nm.laser_waist, "µm"),
    ]),
    ("pos", "amp_sigma", lambda nm: [
        ("amp_sigma", nm.amp_sigma * 100, "%"),
    ]),
    ("pos", "detuning_sigma", lambda nm: [
        ("detuning_sigma", nm.detuning_sigma, "rad/µs"),
    ]),
    ("type", "doppler", lambda nm: [
        ("doppler_sigma", _doppler_sigma(nm.temperature * 1e-6), "rad/µs"),
    ]),
    ("len", "detuning_hf_psd", lambda nm: [
        (
            "detuning_psd",
            list(zip(nm.detuning_hf_omegas, nm.detuning_hf_psd)),
            "(rad/µs, rad/µs)",
        ),
    ]),
    ("type", "relaxation", lambda nm: [
        ("T1", 1 / nm.relaxation_rate, "µs"),
    ]),
    ("pos", "dephasing_rate", lambda nm: [
        ("T2* (r-g)", 1 / nm.dephasing_rate, "µs"),
    ]),
    ("pos", "hyperfine_dephasing_rate", lambda nm: [
        ("T2* (g-h)", 1 / nm.hyperfine_dephasing_rate, "µs"),
    ]),
    ("type", "depolarizing", lambda nm: [
        ("depolarizing_rate", nm.depolarizing_rate, "1/µs"),
    ]),
    ("type", "eff_noise", lambda nm: [
        (
            "eff_noise",
            list(zip(nm.eff_noise_rates, nm.eff_noise_opers)),
            "(1/µs, '')",
        ),
        ("with_leakage", nm.with_leakage, ""),
    ]),
    ("pos", "p_false_pos", lambda nm: [
        ("p_false_pos", nm.p_false_pos, ""),
    ]),
    ("pos", "p_false_neg", lambda nm: [
        ("p_false_neg", nm.p_false_neg, ""),
    ]),
    ("pos", "dmm_sigma", lambda nm: [
        ("dmm_sigma", nm.dmm_sigma, ""),
    ]),
    ("truthy", "detuning_map_spot_waist", lambda nm: [
        ("detuning_map_spot_waist", nm.detuning_map_spot_waist, "µm"),
    ]),
)


# Declarative layout of the summary() text. Each section renders when
# any of its table keys is present; "kv" rows print a template filled
# with the formatted table entry, "lit" rows print verbatim, "hdr"
# rows print only when one of the listed keys is present.
_SUMMARY_LAYOUT: tuple = (
    {
        "tag": "register",
        "rows": (
            ("lit", "- Register Position Fluctuations**:", None),
            (
                "kv",
                "  - XY-Plane Position Fluctuations: {}",
                "register_sigma_xy",
            ),
            (
                "kv",
                "  - Z-Axis Position Fluctuations: {}",
                "register_sigma_z",
            ),
        ),
    },
    {
        "tag": "initial state",
        "rows": (
            (
                "kv",
                "- State Preparation Error Probability**: {}",
                "state_prep_error",
            ),
        ),
    },
    {
        "tag": "amplitude",
        "rows": (
            ("lit", "- Amplitude inhomogeneities:", None),
            (
                "kv",
                "  - Finite-waist Gaussian damping \u03c3={}",
                "laser_waist",
            ),
            (
                "kv",
                "  - Shot-to-shot Amplitude Fluctuations**: {}",
                "amp_sigma",
            ),
        ),
    },
    {
        "tag": "detuning",
        "rows": (
            ("lit", "- Detuning fluctuations**:", None),
            (
                "hdr",
                "  - Shot-to-Shot Detuning fluctuations:",
                ("detuning_sigma", "doppler_sigma"),
            ),
            (
                "kv",
                "       - Laser's Detuning fluctuations: {}",
                "detuning_sigma",
            ),
            (
                "kv",
                "       - Doppler fluctuations: {}",
                "doppler_sigma",
            ),
            (
                "hdr",
                "  - High-Frequency Detuning fluctuations. See PSD in "
                "get_noise_table()['detuning_psd'].",
                ("detuning_psd",),
            ),
        ),
    },
    {
        "tag": "dmm_sigma",
        "rows": (
            ("lit", "- DMM detuning fluctuations**:", None),
            (
                "kv",
                " - Shot-to-shot DMM detuning fluctuations: {}",
                "dmm_sigma",
            ),
        ),
    },
    {
        "tag": None,
        "rows": (
            ("lit", "- DMM crosstalk**:", None),
            (
                "kv",
                " - Detuning Map spots' waist: {}",
                "detuning_map_spot_waist",
            ),
        ),
    },
    {
        "tag": None,
        "traj": False,
        "rows": (
            ("lit", "- Dissipation parameters:", None),
            ("kv", "   - T1: {}", "T1"),
            ("kv", "   - T2* (r-g): {}", "T2* (r-g)"),
            ("kv", "   - T2* (g-h): {}", "T2* (g-h)"),
        ),
    },
    {
        "tag": None,
        "traj": False,
        "rows": (
            ("lit", "- Other Decoherence Processes:", None),
            (
                "kv",
                "   - Depolarization at rate {}",
                "depolarizing_rate",
            ),
            ("eff", None, "eff_noise"),
        ),
    },
    {
        "tag": None,
        "traj": False,
        "rows": (
            ("lit", "- Measurement noises:", None),
            (
                "kv",
                "   - False Positive Meas. Probability: {}",
                "p_false_pos",
            ),
            (
                "kv",
                "   - False Negative Meas. Probability: {}",
                "p_false_neg",
            ),
        ),
    },
)


@dataclass(init=True, repr=False, frozen=True)
class NoiseModel:
    r"""Specifies the noise model parameters for emulation.

    Supported noise types: leakage, relaxation, dephasing, depolarizing,
    eff_noise, doppler, register, amplitude, detuning, SPAM, dmm_sigma and
    dmm_crosstalk.  Active noise types are derived automatically from the
    non-default parameters.

    Args:
        runs: How many times the Hamiltonian is rebuilt from fresh random
            noise (deprecated; use 'EmulationConfig.n_trajectories').
        samples_per_run: Samples taken per noisy Hamiltonian (deprecated).
        state_prep_error: Probability of faulty state preparation.
        p_false_pos: False-positive measurement probability.
        p_false_neg: False-negative measurement probability.
        temperature: Atom temperature in the array, in µK.
        laser_waist: Gaussian-laser waist for global pulses, in µm.
        amp_sigma: Run-to-run amplitude fluctuation of a channel, as the
            std dev of a normal distribution centered at 1.
        detuning_sigma: Shot-to-shot detuning fluctuation of a channel
            (std dev in rad/µs, additive, centered at 0).
        trap_waist: Optical trap waist at the focal point (in µm).
        trap_depth: Depth of the potential well holding the atoms
            (in µK).
        detuning_hf_psd: 1-sided PSD of high-frequency detuning noise
            (rad/µs), paired with `detuning_hf_omegas`.
        detuning_hf_omegas: Angular-frequency support of the PSD
            (rad/µs).
        relaxation_rate: Rydberg→ground relaxation rate (1/µs), i.e.
            1/T1.
        dephasing_rate: Dephasing rate of a Rydberg-state superposition
            (1/µs), i.e. 1/T2*.
        hyperfine_dephasing_rate: Dephasing rate between hyperfine ground
            states (1/µs).
        depolarizing_rate: Depolarizing-error rate (1/µs).
        eff_noise_rates: One rate per effective noise operator (1/µs).
        eff_noise_opers: The effective-noise operators themselves.
        with_leakage: Add an error state to the computation.
        disable_doppler: Suppress doppler noise even with a defined
            temperature (lets 'register' noise run on its own).
        dmm_sigma: Shot-to-shot DMM detuning fluctuation (std dev,
            multiplicative, centered at 1).
        detuning_map_spot_waist: Waist of each DetuningMap spot (µm);
            needed when combining 'register' noise with a DMM.
    """

    noise_types: tuple[NoiseTypes, ...] = field(init=False)
    runs: int | None = None
    samples_per_run: int = 1
    state_prep_error: float = 0.0
    p_false_pos: float = 0.0
    p_false_neg: float = 0.0
    temperature: float = 0.0
    laser_waist: float | None = None
    amp_sigma: float = 0.0
    detuning_sigma: float = 0.0
    detuning_hf_psd: _FloatTuple = ()
    detuning_hf_omegas: _FloatTuple = ()
    relaxation_rate: float = 0.0
    dephasing_rate: float = 0.0
    trap_waist: float = 0.0
    trap_depth: float | None = None
    hyperfine_dephasing_rate: float = 0.0
    depolarizing_rate: float = 0.0
    eff_noise_rates: _FloatTuple = ()
    eff_noise_opers: tuple[pm.AbstractArrayLike, ...] = ()
    with_leakage: bool = False
    disable_doppler: bool = False
    dmm_sigma: float = 0.0
    detuning_map_spot_waist: float | None = None

    def _collect_params(self) -> dict[str, Any]:
        """Gathers init params, canonicalized to plain python values."""
        param_vals = {
            f.name: getattr(self, f.name) for f in fields(self) if f.init
        }
        for tup_param in (
            "eff_noise_rates",
            "eff_noise_opers",
            "detuning_hf_psd",
            "detuning_hf_omegas",
        ):
            param_vals[tup_param] = _as_plain_tuple(param_vals[tup_param])

        # Everything bounded must be a float
        for p_, val in param_vals.items():
            if p_ in _PROBABILITY_LIKE | _POSITIVE:
                try:
                    param_vals[p_] = float(val)
                except (TypeError, ValueError):
                    raise TypeError(
                        f"{p_} should be castable to float, not of type"
                        f" {type(val)}."
                    )
        return param_vals

    def __post_init__(self) -> None:
        """Initializes a noise model."""
        param_vals = self._collect_params()

        active_noise_types: set[NoiseTypes] = {
            _PARAM_TO_NOISE_TYPE[p_]
            for p_ in param_vals
            if param_vals[p_] and p_ in _PARAM_TO_NOISE_TYPE
        }

        self._check_leakage_noise(active_noise_types)
        self._check_detuning_hf_noise(
            param_vals["detuning_hf_psd"],
            param_vals["detuning_hf_omegas"],
        )
        self._check_eff_noise(
            cast(tuple, param_vals["eff_noise_rates"]),
            cast(tuple, param_vals["eff_noise_opers"]),
            "eff_noise" in active_noise_types,
            with_leakage=cast(bool, param_vals["with_leakage"]),
        )

        relevant_params = self._find_relevant_params(
            active_noise_types,
            cast(float, param_vals["state_prep_error"]),
            cast(float, param_vals["amp_sigma"]),
            cast(Union[float, None], param_vals["laser_waist"]),
        )

        relevant_param_vals = {
            p: param_vals[p]
            for p in param_vals
            if param_vals[p] is not None or p in relevant_params
        }

        if param_vals.get("runs") is not None:
            warnings.warn(
                "Defining the number of emulation trajectories via "
                "'NoiseModel.runs' is deprecated. "
                "Please favour using 'EmulationConfig.n_trajectories' "
                "instead.",
                category=DeprecationWarning,
                stacklevel=2,
            )
        else:
            relevant_param_vals.pop("runs", None)

        self._validate_parameters(relevant_param_vals)

        self._check_register_noise_params(
            active_noise_types,
            cast(float, param_vals["trap_waist"]),
            cast(Union[float, None], param_vals["trap_depth"]),
            cast(float, param_vals["temperature"]),
        )
        if self.disable_doppler:
            active_noise_types.discard("doppler")

        object.__setattr__(
            self, "noise_types", tuple(sorted(active_noise_types))
        )
        self._store_and_warn_unused(param_vals, relevant_params)

    def _store_and_warn_unused(
        self, param_vals: dict[str, Any], relevant_params: set[str]
    ) -> None:
        """Writes back canonical values, warning about inert parameters."""
        non_zero_relevant_params = [
            p for p in relevant_params if param_vals[p]
        ]
        for param_, val_ in param_vals.items():
            object.__setattr__(self, param_, val_)
            is_set = val_ if param_ != "samples_per_run" else val_ != 1
            if (
                param_ != "disable_doppler"
                and param_ not in relevant_params
                and is_set
            ):
                warnings.warn(
                    f"{param_!r} is not used by any active noise type "
                    f"in {self.noise_types} when the only defined"
                    f" parameters are {non_zero_relevant_params}.",
                    stacklevel=2,
                )

    # -- Static validation helpers -----------------------------------------

    @staticmethod
    def _check_register_noise_params(
        active_noise_types: Collection[NoiseTypes],
        trap_waist: float,
        trap_depth: float | None,
        temperature: float,
    ) -> None:
        if "register" not in active_noise_types:
            return
        if trap_waist == 0.0 or trap_depth is None or temperature == 0.0:
            raise ValueError(
                "trap_waist, trap_depth, and temperature must be defined in"
                " order to simulate register noise."
            )

    @staticmethod
    def _find_relevant_params(
        noise_types: Collection[NoiseTypes],
        state_prep_error: float,
        amp_sigma: float,
        laser_waist: float | None,
    ) -> set[str]:
        relevant_params: set[str] = set()
        for nt_ in noise_types:
            relevant_params.update(_NOISE_TYPE_PARAMS[nt_])
            if nt_ == "register":
                relevant_params.add("temperature")
            needs_trajectories = (
                nt_ in _TRAJ_SENSITIVE
                or (nt_ == "amplitude" and amp_sigma != 0.0)
                or (nt_ == "SPAM" and state_prep_error != 0.0)
            )
            if needs_trajectories:
                relevant_params.update(("runs", "samples_per_run"))
        # An undefined laser_waist never counts as relevant
        if laser_waist is None:
            relevant_params.discard("laser_waist")
        return relevant_params

    @staticmethod
    def _check_noise_types(noise_types: Sequence[NoiseTypes]) -> None:
        bad = [n for n in noise_types if n not in get_args(NoiseTypes)]
        if bad:
            raise ValueError(
                f"'{bad[0]}' is not a valid noise type. "
                + "Valid noise types: "
                + ", ".join(get_args(NoiseTypes))
            )

    @staticmethod
    def _check_leakage_noise(
        noise_types: Collection[NoiseTypes],
    ) -> None:
        if "leakage" not in noise_types:
            return
        if "eff_noise" not in noise_types:
            raise ValueError(
                "At least one effective noise operator must be defined to"
                " simulate leakage."
            )

    @staticmethod
    def _check_detuning_hf_noise(
        psd: tuple[float, ...],
        freqs: tuple[float, ...],
    ) -> None:
        if (psd == ()) ^ (freqs == ()):
            raise ValueError(
                "`detuning_hf_psd` and `detuning_hf_omegas` must either"
                " both be empty tuples or both be provided."
            )
        if psd == ():
            return

        psd_a, freqs_a = np.asarray(psd), np.asarray(freqs)
        # Requirement -> complaint, checked in order
        rules = (
            (
                psd_a.ndim == 1 and freqs_a.ndim == 1,
                "`detuning_hf_psd` and `detuning_hf_omegas`"
                " are expected to be 1D tuples.",
            ),
            (
                psd_a.size == freqs_a.size,
                "`detuning_hf_psd` and `detuning_hf_omegas`"
                " are expected to have the same length.",
            ),
            (
                psd_a.size > 1,
                "`detuning_hf_psd` and `detuning_hf_omegas`"
                " are expected to have length > 1.",
            ),
            (
                bool(np.all(psd_a > 0) and np.all(freqs_a > 0)),
                "`detuning_hf_psd` and `detuning_hf_omegas`"
                " are expected to have positive values.",
            ),
            (
                not np.any(np.diff(freqs_a) < 0),
                "`detuning_hf_omegas` are expected to be monotonously"
                " growing.",
            ),
        )
        for ok, complaint in rules:
            if not ok:
                raise ValueError(complaint)

    @staticmethod
    def _check_eff_noise(
        eff_noise_rates: Sequence[float],
        eff_noise_opers: Sequence[ArrayLike],
        check_contents: bool,
        with_leakage: bool,
    ) -> None:
        if len(eff_noise_opers) != len(eff_noise_rates):
            raise ValueError(
                f"The operators list length({len(eff_noise_opers)}) "
                "and rates list length"
                f"({len(eff_noise_rates)}) must be equal."
            )
        for rate in eff_noise_rates:
            if not isinstance(rate, (float, int)):
                raise TypeError(
                    "eff_noise_rates is a list of floats,"
                    f" it must not contain a {type(rate)}."
                )

        if not check_contents:
            return

        if not eff_noise_opers or not eff_noise_rates:
            raise ValueError(
                "The effective noise parameters have not been filled."
            )

        if np.any(np.array(eff_noise_rates) < 0):
            raise ValueError("The provided rates must be greater than 0.")

        # Operators must be square 2-D complex arrays of the right size
        min_shape = 2 if not with_leakage else 3
        possible_shapes = [
            (min_shape, min_shape),
            (min_shape + 1, min_shape + 1),
        ]
        for op in eff_noise_opers:
            try:
                operator = np.array(op, dtype=complex)
            except TypeError as e1:
                raise TypeError(
                    f"Operator {op!r} is not castable to a Numpy array."
                ) from e1
            if operator.ndim != 2:
                raise ValueError(f"Operator '{op!r}' is not a 2D array.")

            if operator.shape not in possible_shapes:
                raise ValueError(
                    f"With{'' if with_leakage else 'out'} leakage,"
                    f" operator's shape must be {possible_shapes[0]}, "
                    f"not {operator.shape}."
                )

    # Per validation kind: (value check, requirement description)
    _KIND_CHECKS = {
        "pos": (
            lambda v: v >= 0,
            "greater than or equal to zero",
        ),
        "strict_pos": (
            lambda v: v is not None and v > 0,
            "greater than zero",
        ),
        "prob": (
            lambda v: 0 <= v <= 1,
            "greater than or equal to zero and smaller than "
            "or equal to one",
        ),
        "bool": (
            lambda v: isinstance(v, bool),
            "a boolean",
        ),
    }

    @staticmethod
    def _validate_parameters(param_vals: dict[str, Any]) -> None:
        """Checks each value against its registry row's kind."""
        for param, value in param_vals.items():
            spec = _PARAMS.get(param)
            check = spec and NoiseModel._KIND_CHECKS.get(spec.kind)
            if check is not None and not check[0](value):
                raise ValueError(
                    f"'{param}' must be {check[1]}, not {value}."
                )
            if param == "samples_per_run" and value != 1:
                warnings.warn(
                    "Setting samples_per_run different to 1 is "
                    "deprecated.",
                    DeprecationWarning,
                    stacklevel=2,
                )

    # -- Serialization ------------------------------------------------------

    def _to_abstract_repr(self) -> dict[str, Any]:
        all_fields = {}
        for f in fields(self):
            value = getattr(self, f.name)
            if (
                f.name in OPTIONAL_IN_ABSTR_REPR
                and get_dataclass_defaults((f,))[f.name] == value
            ):
                continue
            all_fields[f.name] = value
        # These are deducible from noise_types, so they're dropped
        all_fields.pop("disable_doppler")
        all_fields.pop("with_leakage")
        # The wire format pairs rates with operators
        eff_noise_rates = all_fields.pop("eff_noise_rates")
        eff_noise_opers = all_fields.pop("eff_noise_opers")
        all_fields["eff_noise"] = list(
            zip(eff_noise_rates, eff_noise_opers)
        )

        if "detuning_hf_psd" in all_fields:
            det_hf_psd = all_fields.pop("detuning_hf_psd")
            det_hf_freqs = all_fields.pop("detuning_hf_omegas")
            all_fields["detuning_hf"] = list(zip(det_hf_psd, det_hf_freqs))

        return all_fields

    def __repr__(self) -> str:
        relevant_params = self._find_relevant_params(
            self.noise_types,
            self.state_prep_error,
            self.amp_sigma,
            self.laser_waist,
        )
        relevant_params.add("noise_types")
        relevant_params -= {"runs", "samples_per_run"}
        params_list = [
            f"{f.name}={getattr(self, f.name)!r}"
            for f in fields(self)
            if f.name in relevant_params
        ]
        return f"{self.__class__.__name__}({', '.join(params_list)})"

    def to_abstract_repr(self) -> str:
        """Serializes the noise model into an abstract JSON object."""
        abstr_str = json.dumps(self, cls=AbstractReprEncoder)
        validate_abstract_repr(abstr_str, "noise")
        return abstr_str

    @staticmethod
    def from_abstract_repr(obj_str: str) -> NoiseModel:
        """Deserialize a noise model from an abstract JSON object.

        Args:
            obj_str: the JSON string representing the noise model encoded
                in the abstract JSON format.
        """
        if not isinstance(obj_str, str):
            raise TypeError(
                "The serialized noise model must be given as a string. "
                f"Instead, got object of type {type(obj_str)}."
            )

        from pulser_tpu_torch.json.abstract_repr.deserializer import (
            deserialize_abstract_noise_model,
        )

        return deserialize_abstract_noise_model(obj_str)

    # -- Human-readable summaries -------------------------------------------

    def _noise_table_gate(self, kind: str, arg: str) -> bool:
        if kind == "type":
            return arg in self.noise_types
        value = getattr(self, arg)
        if kind == "pos":
            return value is not None and value > 0
        if kind == "len":
            return len(value) > 0
        return bool(value)  # "truthy"

    def get_noise_table(self) -> dict[str, tuple[Any, str]]:
        """Maps non-zero noise quantities with their value and units.

        Driven by the declarative ``_NOISE_TABLE_SPEC`` registry; keys
        and units match the reference's table
        (``pulser-core/pulser/noise_model.py``, ``get_noise_table``).
        """
        return {
            key: (value, unit)
            for kind, arg, produce in _NOISE_TABLE_SPEC
            if self._noise_table_gate(kind, arg)
            for key, value, unit in produce(self)
        }

    @staticmethod
    def _fmt(value: Any, unit: str) -> str:
        return f"{value:g}" if unit == "" else f"{value:g} {unit}"

    def _render_eff_noise_rows(
        self, noise_table: dict[str, tuple[Any, str]]
    ) -> list[str]:
        rows = [
            "   - Custom Lindblad operators (in 1/\u00b5s)"
            + (
                " including a leakage state:"
                if noise_table["with_leakage"][0]
                else ":"
            )
        ]
        for rate, oper in noise_table["eff_noise"][0]:
            oper_str = tuple(
                tuple(float(f"{val:g}") for val in row) for row in oper
            )
            rows.append(f"       - {rate:g} * {oper_str}")
        return rows

    def _render_summary_section(
        self, section: dict, noise_table: dict[str, tuple[Any, str]]
    ) -> list[str]:
        keyed = [
            row[2]
            for row in section["rows"]
            if row[0] in ("kv", "eff") and row[2] in noise_table
        ]
        if not keyed:
            return []
        lines = []
        for kind, template, key in section["rows"]:
            if kind == "lit":
                lines.append(template)
            elif kind == "hdr":
                if any(k in noise_table for k in key):
                    lines.append(template)
            elif kind == "eff":
                if key in noise_table:
                    lines += self._render_eff_noise_rows(noise_table)
            elif key in noise_table:
                lines.append(
                    template.format(self._fmt(*noise_table[key]))
                )
        return lines

    def summary(self) -> str:
        """A readable summary of the noise's impact on the simulation."""
        noise_table = self.get_noise_table()
        summary_list = ["Noise summary:"]
        traj_tags = []
        for section in _SUMMARY_LAYOUT:
            lines = self._render_summary_section(section, noise_table)
            if not lines:
                continue
            summary_list += lines
            if section["tag"] is not None:
                traj_tags.append(section["tag"])
        if traj_tags:
            summary_list += [
                "**: Emulation will generate"
                " EmulationConfig.n_trajectories trajectories with"
                " different " + ", ".join(traj_tags)
            ]
        return "\n".join(summary_list)
