"""Base classes for the backend interface.

API parity with reference ``pulser-core/pulser/backend/abc.py:30-143``.
"""

from __future__ import annotations

import warnings
from abc import ABC, abstractmethod
from collections.abc import Sequence
from typing import TYPE_CHECKING, ClassVar, Type, cast

from pulser_tpu_torch.backend._classproperty import classproperty
from pulser_tpu_torch.backend.config import EmulationConfig
from pulser_tpu_torch.backend.results import Results
from pulser_tpu_torch.channels.dmm import DMM
from pulser_tpu_torch.devices import Device

if TYPE_CHECKING:
    from pulser_tpu_torch.sequence import Sequence as PulserSequence


def _qpu_compatibility_checks(sequence: PulserSequence) -> None:
    """Rejects sequences a real QPU would refuse to ingest."""
    if sequence.is_empty():
        raise ValueError(
            "'sequence' should not be empty, please add an"
            " instruction to a declared channel."
        )
    device = sequence.device
    if not isinstance(device, Device):
        raise TypeError(
            "To be sent to a QPU, the device of the sequence "
            "must be a real device, instance of 'Device'."
        )
    layout = sequence.get_register(include_mappable=True).layout
    if device.requires_layout and layout is None:
        raise ValueError(
            f"'{device.name}' requires the sequence's register to be"
            " defined from a `RegisterLayout`."
        )
    if (
        not device.accepts_new_layouts
        and layout is not None
        and layout not in device.pre_calibrated_layouts
    ):
        raise ValueError(
            f"'{device.name}' does not accept new register layouts so"
            " the register's layout must be one of the layouts"
            " available in"
            f" '{device.name}.calibrated_register_layouts'."
        )


class Backend(ABC):
    """The backend abstract base class."""

    def __init__(
        self, sequence: PulserSequence, mimic_qpu: bool = False
    ) -> None:
        """Starts a new backend instance."""
        self.validate_sequence(sequence, mimic_qpu=mimic_qpu)
        self._sequence = sequence
        self._mimic_qpu = bool(mimic_qpu)

    @abstractmethod
    def run(self) -> Results | Sequence[Results]:
        """Executes the sequence on the backend."""

    @staticmethod
    def validate_sequence(
        sequence: PulserSequence, mimic_qpu: bool = False
    ) -> None:
        """Validates a sequence prior to submission."""
        from pulser_tpu_torch.sequence import Sequence as _Sequence

        if not isinstance(sequence, _Sequence):
            raise TypeError(
                "'sequence' should be a `Sequence` instance"
                f", not {type(sequence)}."
            )
        if mimic_qpu:
            _qpu_compatibility_checks(sequence)


class EmulatorBackend(Backend):
    """The emulator backend parent class."""

    default_config: ClassVar[EmulationConfig]

    def _check_register_noise_with_dmm(self) -> None:
        """Register noise + DMM needs a crosstalk waist to be physical."""
        noise_model = self._config.noise_model
        if noise_model is None:
            return
        uses_dmm = any(
            isinstance(ch, DMM)
            for ch in self._sequence.declared_channels.values()
        )
        if (
            uses_dmm
            and "register" in noise_model.noise_types
            and noise_model.detuning_map_spot_waist is None
        ):
            raise ValueError(
                "Combining register noise with a DMM requires"
                "`detuning_map_spot_waist` to be defined. If not"
                " defined, atom thermal motion can lead to"
                " non-physical effects."
            )

    def _warn_overridden_runs(self, sequence: PulserSequence) -> None:
        """Warns when the config trajectory count wins over the device's."""
        device_noise = self._sequence.device.noise_model
        config = self._config
        if (
            config.prefer_device_noise_model
            and device_noise is not None
            and device_noise.runs is not None
            and device_noise.runs != config.n_trajectories
        ):
            warnings.warn(
                f"'{sequence.device.noise_model.runs=}' is being "
                f"ignored; '{config.n_trajectories=}' will be used"
                " instead.",
                stacklevel=3,
            )

    def __init__(
        self,
        sequence: PulserSequence,
        *,
        config: EmulationConfig | None = None,
        mimic_qpu: bool = False,
    ) -> None:
        """Initializes the backend."""
        super().__init__(sequence, mimic_qpu=mimic_qpu)
        self._config = self.validate_config(
            config or self.default_config
        )
        self._check_register_noise_with_dmm()
        self._warn_overridden_runs(sequence)

    @classproperty
    def config_type(cls) -> Type[EmulationConfig]:
        """The config class to use with this backend."""
        return type(cls.default_config)

    @classmethod
    def validate_config(
        cls, config: EmulationConfig
    ) -> EmulationConfig:
        """Validates a given configuration for this backend.

        Args:
            config: The configuration to validate.

        Returns:
            The full configuration that will be used by the backend if
            the given configuration passes validation.
        """
        if not isinstance(config, EmulationConfig):
            raise TypeError(
                "'config' must be an instance of 'EmulationConfig', "
                f"not {type(config)}."
            )
        # Every option set on `config` wins; the backend's defaults
        # fill whatever it left unset.
        merged = {
            **cls.default_config._backend_options,
            **config._backend_options,
        }
        return cast(EmulationConfig, cls.config_type(**merged))
