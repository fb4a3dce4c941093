"""The (legacy) SimConfig class.

Behavioral parity with reference
``pulser-simulation/pulser_simulation/simconfig.py:42-273``. SimConfig
predates NoiseModel; it keeps the old parameter spellings (eta/epsilon/
epsilon_prime, temperature in µK at the API surface but Kelvin inside)
and converts to/from NoiseModel through an alias table. Unlike the
reference, the frozen dataclass is assembled at import time from a
single field-spec table so the legacy defaults live in exactly one
place.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import MISSING, fields, make_dataclass
from dataclasses import field as _dc_field
from typing import Any, Tuple, Type, TypeVar, cast

import numpy as np

from pulser_tpu_torch.emulator.qobj import Qobj
from pulser_tpu_torch.hamiltonian_data.hamiltonian_data import (
    SUPPORTED_NOISES,
)
from pulser_tpu_torch.noise_model import (
    _LEGACY_DEFAULTS,
    NoiseModel,
    NoiseTypes,
    _doppler_sigma,
)

T = TypeVar("T", bound="SimConfig")


class _Legacy(str):
    """Marks a field whose default comes from ``_LEGACY_DEFAULTS``.

    The string value is the NoiseModel spelling of the parameter; it
    doubles as the alias used when translating to/from NoiseModel.
    """


# One row per SimConfig field: (name, type, default). A ``_Legacy``
# default is resolved against _LEGACY_DEFAULTS under its NoiseModel
# spelling — rows where that spelling differs from the field name
# define the legacy-alias table as a side effect.
_FIELD_SPEC: tuple[tuple[str, Any, Any], ...] = (
    ("noise", "NoiseArg", ()),
    ("runs", int, _Legacy("runs")),
    ("samples_per_run", int, _Legacy("samples_per_run")),
    ("temperature", float, _Legacy("temperature")),
    ("laser_waist", float, _Legacy("laser_waist")),
    ("amp_sigma", float, _Legacy("amp_sigma")),
    ("detuning_sigma", float, 0.0),
    ("eta", float, _Legacy("state_prep_error")),
    ("epsilon", float, _Legacy("p_false_pos")),
    ("epsilon_prime", float, _Legacy("p_false_neg")),
    ("relaxation_rate", float, _Legacy("relaxation_rate")),
    ("dephasing_rate", float, _Legacy("dephasing_rate")),
    (
        "hyperfine_dephasing_rate",
        float,
        _Legacy("hyperfine_dephasing_rate"),
    ),
    ("depolarizing_rate", float, _Legacy("depolarizing_rate")),
    ("eff_noise_rates", list, MISSING),
    ("eff_noise_opers", list, MISSING),
    ("solver_options", "dict | None", None),
)

# NoiseModel spelling -> SimConfig spelling (derived from the spec),
# plus the tuple-of-types field itself.
_LEGACY_NAME_OF: dict[str, str] = {"noise_types": "noise"}
_LEGACY_NAME_OF.update(
    {
        str(default): name
        for name, _, default in _FIELD_SPEC
        if isinstance(default, _Legacy) and str(default) != name
    }
)


def _map_params(
    source: Any, relevant: set, to_legacy: bool
) -> dict[str, Any]:
    """Copies the relevant params across the alias table.

    ``source`` is a NoiseModel (to_legacy=True, read under NoiseModel
    spellings, write under SimConfig spellings) or a SimConfig
    (to_legacy=False, the reverse).
    """
    out: dict[str, Any] = {}
    for param in relevant:
        legacy = _LEGACY_NAME_OF.get(param, param)
        src_name, dst_name = (
            (param, legacy) if to_legacy else (legacy, param)
        )
        out[dst_name] = getattr(source, src_name)
    if "eff_noise_opers" in out:
        out["eff_noise_opers"] = [
            np.asarray(op) for op in out["eff_noise_opers"]
        ]
    return out


class _SimConfigLogic:
    """Everything SimConfig does, minus the generated field storage."""

    # --- NoiseModel translation (both directions share one mapper) ---

    @classmethod
    def from_noise_model(cls: Type[T], noise_model: NoiseModel) -> T:
        """Translates a NoiseModel into the legacy spelling."""
        relevant = NoiseModel._find_relevant_params(
            noise_model.noise_types,
            noise_model.state_prep_error,
            noise_model.amp_sigma,
            noise_model.laser_waist,
        )
        relevant.discard("with_leakage")
        kwargs = _map_params(noise_model, relevant, to_legacy=True)
        kwargs["noise"] = noise_model.noise_types
        # SimConfig spells "no waist" as inf, NoiseModel as None.
        if "amplitude" in noise_model.noise_types:
            kwargs.setdefault("laser_waist", float("inf"))
        if kwargs.get("runs", 0) is None:
            del kwargs["runs"]
        return cast(Type[T], cls)(**kwargs)

    def to_noise_model(self) -> NoiseModel:
        """Translates this legacy config into a NoiseModel."""
        waist = (
            None if math.isinf(self.laser_waist) else self.laser_waist
        )
        relevant = NoiseModel._find_relevant_params(
            cast(Tuple[NoiseTypes, ...], self.noise),
            self.eta,
            self.amp_sigma,
            waist,
        )
        kwargs = _map_params(self, relevant, to_legacy=False)
        if "temperature" in kwargs:
            kwargs["temperature"] *= 1e6  # Converts back to µK
        return NoiseModel(**kwargs)

    # --- construction-time validation ---

    def __post_init__(self) -> None:
        warnings.warn(
            "'SimConfig' has been deprecated, please use `NoiseModel` "
            "instead.",
            DeprecationWarning,
            stacklevel=2,
        )
        # A single noise given as argument: convert it to a tuple
        if isinstance(self.noise, str):
            object.__setattr__(self, "noise", (self.noise,))
        if not isinstance(self.temperature, (int, float)):
            raise TypeError(
                "'temperature' must be a float, not"
                f" {type(self.temperature)}."
            )
        # Stored in Kelvin; the constructor argument is in µK.
        object.__setattr__(
            self, "temperature", self.temperature / 1e6
        )
        NoiseModel._check_noise_types(
            cast(Tuple[NoiseTypes], self.noise)
        )
        for param, value in self.spam_dict.items():
            if not 0 <= value <= 1:
                raise ValueError(
                    f"SPAM parameter {param} = {value} must be"
                    + " greater than 0 and less than 1."
                )
        self._check_eff_noise()
        NoiseModel._validate_parameters(
            {f.name: getattr(self, f.name) for f in fields(self)}
        )

    def _check_eff_noise(self) -> None:
        # The legacy interface takes Qobj operators specifically
        # (reference simconfig.py:253-268); plain arrays belong to the
        # modern NoiseModel API
        for operator in self.eff_noise_opers:
            if not isinstance(operator, Qobj):
                raise TypeError(f"{operator} is not a Qobj.")
            if not operator.isoper or operator.isket or operator.isbra:
                raise TypeError(
                    "Operators are supposed to be of Qutip type"
                    " 'oper'."
                )
        NoiseModel._check_eff_noise(
            self.eff_noise_rates,
            [np.asarray(op) for op in self.eff_noise_opers],
            "eff_noise" in self.noise,
            self.with_leakage,
        )

    def _change_attribute(
        self, attr_name: str, new_value: Any
    ) -> None:
        object.__setattr__(self, attr_name, new_value)

    # --- derived views ---

    @property
    def with_leakage(self) -> bool:
        """True when leakage is among the active noise types."""
        return "leakage" in self.noise

    @property
    def spam_dict(self) -> dict[str, float]:
        """The three SPAM error parameters, bundled."""
        return {
            "eta": self.eta,
            "epsilon": self.epsilon,
            "epsilon_prime": self.epsilon_prime,
        }

    @property
    def doppler_sigma(self) -> float:
        """The thermal-motion Doppler-shift spread."""
        return _doppler_sigma(self.temperature)

    @property
    def supported_noises(self) -> dict:
        """Which noise types each interaction mode accepts."""
        return SUPPORTED_NOISES

    # --- reporting ---

    def __str__(self, solver_options: bool = False) -> str:
        lines = [
            "Options:",
            "----------",
            f"Number of runs:        {self.runs}",
            f"Samples per run:       {self.samples_per_run}",
        ]
        report_of = {
            "SPAM": lambda: [
                f"SPAM dictionary:       {self.spam_dict}"
            ],
            "eff_noise": lambda: [
                f"Effective noise rates:       {self.eff_noise_rates}",
                "Effective noise operators:      "
                f" {self.eff_noise_opers}",
            ],
            "doppler": lambda: [
                f"Temperature:           {self.temperature * 1.e6}µK"
            ],
            "amplitude": lambda: [
                f"Laser waist:           {self.laser_waist}μm",
                f"Amplitude standard dev.:  {self.amp_sigma}",
            ],
            "relaxation": lambda: [
                f"Relaxation rate: {self.relaxation_rate}"
            ],
            "dephasing": lambda: [
                f"Dephasing rate: {self.dephasing_rate} (Rydberg), "
                f"{self.hyperfine_dephasing_rate} (Hyperfine)"
            ],
            "depolarizing": lambda: [
                f"Depolarizing rate: {self.depolarizing_rate}"
            ],
        }
        if self.noise:
            lines.append(
                "Noise types:           " + ", ".join(self.noise)
            )
        for kind, make_lines in report_of.items():
            if kind in self.noise:
                lines.extend(make_lines())
        if solver_options:
            lines.append(
                "Solver Options: \n"
                + f"{str(self.solver_options)[10:-1]}"
            )
        return "\n".join(lines).rstrip()


def _resolve_default(default: Any) -> Any:
    if isinstance(default, _Legacy):
        return _dc_field(default=_LEGACY_DEFAULTS[str(default)])
    if default is MISSING:
        return _dc_field(default_factory=list, repr=False)
    return _dc_field(default=default)


SimConfig = make_dataclass(
    "SimConfig",
    [
        (name, tp, _resolve_default(default))
        for name, tp, default in _FIELD_SPEC
    ],
    bases=(_SimConfigLogic,),
    frozen=True,
)
SimConfig.__module__ = __name__
SimConfig.__doc__ = """The deprecated, pre-NoiseModel simulation configuration.

    Warning:
        Deprecated; ``NoiseModel`` should be used instead.

    Args:
        noise: Active noise type(s) — one name or a tuple of names.
        eta: Chance that an atom comes out badly prepared.
        epsilon: False-positive readout probability.
        epsilon_prime: False-negative readout probability.
        runs: How many noisy realizations to draw.
        samples_per_run: Bitstring samples taken per realization.
        temperature: The array's temperature, given in µK.
        laser_waist: Gaussian waist of the global-pulse laser (µm).
        amp_sigma: Shot-to-shot amplitude spread (std around 1).
        detuning_sigma: Shot-to-shot detuning spread (std around 0).
        solver_options: Options for the solver.
    """
