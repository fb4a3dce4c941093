"""The Sequence class, where a pulse sequence is defined.

Behavioral parity with reference
``pulser-core/pulser/sequence/sequence.py:81-2586``: channel declaration
rules, instruction set (add/target/delay/align/phase_shift/measure/
truncate), EOM mode with phase-drift correction, SLM mask & detuning
maps, parametrization (declare_variable + call replay) and device/
register switching.
"""

from __future__ import annotations

import copy
import json
import os
import warnings
from collections.abc import Collection, Mapping
from typing import (
    Any,
    Generic,
    Literal,
    Optional,
    Tuple,
    TypeVar,
    Union,
    cast,
    get_args,
    overload,
)

import numpy as np
from numpy.typing import ArrayLike

import pulser_tpu_torch
import pulser_tpu_torch.math as pm
from pulser_tpu_torch import profiling
import pulser_tpu_torch.sequence._decorators as seq_decorators
import pulser_tpu_torch.sequence._eom_mode as _eom_mode
from pulser_tpu_torch.channels.base_channel import (
    Channel,
    States,
    get_states_from_bases,
)
from pulser_tpu_torch.channels.dmm import DMM, _dmm_id_from_name, _get_dmm_name
from pulser_tpu_torch.devices._device_datacls import BaseDevice
from pulser_tpu_torch.exceptions.serialization import AbstractReprError
from pulser_tpu_torch.json.utils import obj_to_dict
from pulser_tpu_torch.parametrized import Parametrized, Variable
from pulser_tpu_torch.parametrized.variable import VariableItem
from pulser_tpu_torch.pulse import Pulse
from pulser_tpu_torch.register.base_register import BaseRegister, QubitId
from pulser_tpu_torch.register.mappable_reg import MappableRegister
from pulser_tpu_torch.register.weight_maps import DetuningMap
from pulser_tpu_torch.sequence._basis_ref import _QubitRef
from pulser_tpu_torch.sequence._call import _Call
from pulser_tpu_torch.sequence._schedule import (
    _ChannelSchedule,
    _DMMSchedule,
    _PhaseDriftParams,
    _Schedule,
    _TimeSlot,
)
from pulser_tpu_torch.sequence.helpers._seq_str import seq_to_str
from pulser_tpu_torch.sequence.metadata import _get_metadata
from pulser_tpu_torch.waveforms import Waveform

DeviceType = TypeVar("DeviceType", bound=BaseDevice)

PROTOCOLS = Literal["min-delay", "no-delay", "wait-for-all"]


def _holds_parametrized(value: Any) -> bool:
    """Whether a value is, or contains, a Parametrized object."""
    try:
        return any(
            isinstance(entry, Parametrized)
            for entry in cast(Collection, value)
        )
    except TypeError:
        return isinstance(value, Parametrized)


def _coerce_target_set(qubits: Any) -> set:
    """One-or-many target spec -> a set of targets."""
    if isinstance(qubits, pm.AbstractArray):
        qubits = qubits.tolist()
    if isinstance(qubits, str):
        return {qubits}
    try:
        return set(cast(Collection, qubits))
    except TypeError:
        return {qubits}


def _require_numeric_phases(*values: Any) -> None:
    """Rejects non-numeric concrete phase values."""
    for value in values:
        if isinstance(value, Parametrized):
            continue
        try:
            if isinstance(value, str):
                raise TypeError
            float(pm.AbstractArray(value, dtype=float))
        except TypeError:
            raise TypeError("Phase values must be a numeric value.")


class Sequence(Generic[DeviceType]):
    """A sequence of operations on a device.

    Four ingredients make up a sequence: the device whose constraints it
    obeys, the register of target qubits, the declared device channels,
    and each channel's schedule of instructions.

    Variables created via ``Sequence.declare_variable()`` may be used in
    place of concrete values; the first such use turns the ``Sequence``
    **parametrized** — instructions are then recorded instead of applied,
    to be replayed by ``Sequence.build()`` once values are known.

    Args:
        register: The atom register the pulses act on. When it is a
            MappableRegister, the qubit-to-trap assignment is supplied at
            build time instead.
        device: A valid device on which to execute the Sequence.

    Note:
        Neither the register nor the device may be variable; every build
        of a parametrized Sequence shares them.
    """

    def __init__(
        self,
        register: Union[BaseRegister, MappableRegister],
        device: DeviceType,
    ):
        """Creates an empty sequence on the given register/device."""
        if not isinstance(device, BaseDevice):
            raise TypeError(
                f"'device' must be of type 'BaseDevice', not {type(device)}."
            )

        # The register must fit on the device before anything else
        if isinstance(register, MappableRegister):
            device.validate_layout(register.layout)
            device.validate_layout_filling(register)
        else:
            device.validate_register(register)

        # The hardware side
        self._register: Union[BaseRegister, MappableRegister] = register
        self._device = device
        self._qids: set[QubitId] = set(self._register.qubit_ids)

        # Operating-mode state
        self._in_xy: bool = False
        self._in_ising_value: bool = False
        self._mag_field: Optional[tuple[float, float, float]] = None

        # The instruction record: the schedule holds applied
        # instructions, _calls replays eagerly-executed ones
        self._schedule: _Schedule = _Schedule(
            max_duration=device.max_sequence_duration
        )
        self._calls: list[_Call] = [
            _Call("__init__", (), {"register": register, "device": device})
        ]
        self._basis_ref: dict[str, dict[QubitId, _QubitRef]] = {}
        # Marks the sequence as empty until the first pulse is added
        self._empty_sequence: bool = True

        # SLM mask bookkeeping
        self._slm_mask_targets: set[QubitId] = set()
        self._slm_mask_dmm: str | None = None

        # Parametrization state (also declares _variables,
        # _to_build_calls and _building)
        self._variables: dict[str, Variable] = {}
        self._to_build_calls: list[_Call] = []
        self._building: bool = True
        self._reset_parametrized()

    @property
    def _slm_dmm_schedule(self) -> _DMMSchedule | None:
        """The schedule of the DMM reserved for the SLM mask, if any.

        None when no DMM is reserved or (XY mode) none was scheduled.
        """
        if (
            self._slm_mask_dmm is None
            or self._slm_mask_dmm not in self._schedule
        ):
            return None
        return cast(_DMMSchedule, self._schedule[self._slm_mask_dmm])

    @property
    def _slm_mask_time(self) -> list[int]:
        """When the SLM mask switches on and off, if it does."""
        slm_sched = self._slm_dmm_schedule
        if (
            self._in_ising
            and slm_sched is not None
            and not slm_sched._waiting_for_first_pulse
        ):
            slm_slot = slm_sched.slots[1]
            return [slm_slot.ti, slm_slot.tf]
        if not self._slm_mask_targets:
            return []
        return self._schedule.find_slm_mask_times()

    @property
    def _in_ising(self) -> bool:
        return self._in_ising_value

    @_in_ising.setter
    def _in_ising(self, value: bool) -> None:
        if not isinstance(value, bool):
            raise TypeError("_in_ising must be a bool.")
        if self._in_ising == value:
            return
        if self._in_ising:  # i.e. value = False
            raise ValueError("Cannot quit ising.")
        # At this point, value = True
        if self._in_xy:
            raise ValueError("Cannot be in ising if in xy.")
        self._in_ising_value = True
        if self._slm_mask_dmm:
            self._set_slm_mask_dmm(
                self._slm_mask_dmm, self._slm_mask_targets
            )

    @property
    def qubit_info(self) -> dict[QubitId, pm.AbstractArray]:
        """Dictionary with the qubits' IDs and positions."""
        if self.is_register_mappable():
            raise RuntimeError(
                "Can't access the qubit information when the register is "
                "mappable."
            )
        return cast(BaseRegister, self._register).qubits

    @property
    def device(self) -> DeviceType:
        """The device whose constraints this sequence obeys."""
        return self._device

    @property
    def register(self) -> BaseRegister:
        """Register with the qubits' IDs and positions."""
        if self.is_register_mappable():
            raise RuntimeError(
                "Can't access the sequence's register because the register"
                " is mappable."
            )
        return cast(BaseRegister, self._register)

    @overload
    def get_register(
        self, include_mappable: Literal[False]
    ) -> BaseRegister: ...

    @overload
    def get_register(
        self, include_mappable: Literal[True]
    ) -> BaseRegister | MappableRegister: ...

    def get_register(
        self, include_mappable: bool = True
    ) -> BaseRegister | MappableRegister:
        """The register, mappable or concrete, the pulses act on."""
        return self._register if include_mappable else self.register

    def _get_dmm_id_detuning_map(
        self, call: _Call
    ) -> tuple[str, DetuningMap]:
        """Reads (dmm_id, detuning_map) out of a stored config call.

        Handles both ``config_detuning_map`` and ``config_slm_mask``
        argument layouts (positional or keyword).
        """
        dmm_id: str = call.kwargs.get(
            "dmm_id",
            call.args[1] if len(call.args) > 1 else "dmm_0",
        )
        if "detuning_map" in call.kwargs:
            det_map: DetuningMap = call.kwargs["detuning_map"]
        elif isinstance(call.args[0], DetuningMap):
            det_map = call.args[0]
        else:
            # config_slm_mask: derive the map from the masked qubits
            det_map = self._slm_detuning_map(set(call.args[0]))
        return (dmm_id, det_map)

    @property
    def declared_channels(self) -> dict[str, Channel]:
        """Every channel declared so far, by name."""
        declared = {
            name: sched.channel_obj
            for name, sched in self._schedule.items()
        }
        # DMM/SLM configurations stored for build time also count
        for call in self._to_build_calls:
            if call.name not in (
                "config_slm_mask",
                "config_detuning_map",
            ):
                continue
            dmm_id, _ = self._get_dmm_id_detuning_map(call)
            dmm_name = _get_dmm_name(dmm_id, list(declared.keys()))
            declared[dmm_name] = self.device.dmm_channels[dmm_id]
        return declared

    @property
    def declared_variables(self) -> dict[str, Variable]:
        """Every variable declared so far, by name."""
        return dict(self._variables)

    @property
    def available_channels(self) -> dict[str, Channel]:
        """Device channels not yet used up by a declaration."""
        all_channels = {
            **self.device.channels,
            **self.device.dmm_channels,
        }
        if not self._in_xy and not self._in_ising:
            # Before the mode is fixed, everything is available — except,
            # on physical devices, a DMM already reserved for the SLM mask
            if (
                self._slm_mask_dmm is not None
                and not self.device.reusable_channels
            ):
                all_channels.pop(self._slm_mask_dmm, None)
            return all_channels

        occupied_ch_ids = [
            (
                self._schedule[ch_name].channel_id
                if ch_name in self._schedule
                else _dmm_id_from_name(ch_name)
            )
            for ch_name in self.declared_channels.keys()
        ]

        def _is_available(id: str, ch: Channel) -> bool:
            # Reusable (virtual-device) channels never get used up
            if id in occupied_ch_ids and not self.device.reusable_channels:
                return False
            if self._in_xy:
                # DMMs stay offered in XY mode while no SLM mask exists
                return ch.basis == "XY" or (
                    isinstance(ch, DMM) and self._slm_mask_dmm is None
                )
            return ch.basis != "XY"

        return {
            id: ch
            for id, ch in all_channels.items()
            if _is_available(id, ch)
        }

    def is_empty(self) -> bool:
        """True while no pulse or delay has been scheduled."""
        if not self._empty_sequence:
            return False
        # The sequence is also not empty if there is a delay call
        for call in self._calls + self._to_build_calls:
            if call.name == "delay":
                return False
        return True

    @property
    def magnetic_field(self) -> np.ndarray:
        """The magnetic field acting on the array of atoms.

        Expressed in the atoms' reference frame (z-axis normal to the
        register plane). Exists only in "XY Mode"; defaults to
        (0, 0, 30) G.
        """
        if not self._in_xy:
            raise AttributeError(
                "The magnetic field is only defined when the "
                "sequence is in 'XY Mode'."
            )
        return np.array(self._mag_field)

    def is_parametrized(self) -> bool:
        """States whether the sequence is parametrized."""
        return not self._building

    def is_in_eom_mode(self, channel: str) -> bool:
        """States whether a channel is currently in EOM mode.

        Args:
            channel: The declared channel to inspect.

        Returns:
            Whether the channel is in EOM mode.
        """
        self._validate_channel(channel)
        if not self.is_parametrized():
            return self._schedule[channel].in_eom_mode()

        # Look for the latest stored EOM mode enable/disable
        for call in reversed(self._calls + self._to_build_calls):
            if call.name not in ("enable_eom_mode", "disable_eom_mode"):
                continue
            # Channel is the first positional arg in both methods
            ch_arg = call.args[0] if call.args else call.kwargs["channel"]
            if ch_arg == channel:
                return cast(bool, call.name == "enable_eom_mode")
        return False

    def is_register_mappable(self) -> bool:
        """States whether the sequence's register is mappable."""
        return isinstance(self._register, MappableRegister)

    def is_measured(self) -> bool:
        """True once a measurement has been programmed."""
        return (
            bool(self._param_measurement)
            if self.is_parametrized()
            else hasattr(self, "_measurement")
        )

    def get_measurement_basis(self) -> str:
        """Gets the sequence's measurement basis.

        Raises:
            RuntimeError: If no measurement was programmed.
        """
        if not self.is_measured():
            raise RuntimeError("The sequence has not been measured.")
        return (
            self._param_measurement
            if self.is_parametrized()
            else self._measurement
        )

    @seq_decorators.screen
    def get_duration(
        self,
        channel: Optional[str] = None,
        include_fall_time: bool = False,
    ) -> int:
        """The current duration of a channel or the whole sequence (ns).

        Args:
            channel: Restrict the measurement to one channel; None gives
                the duration of the entire sequence.
            include_fall_time: Also count the extra time the last pulse
                needs to ring down under output modulation.
        """
        if channel is not None:
            self._validate_channel(channel)

        return self._schedule.get_duration(channel, include_fall_time)

    def get_addressed_bases(self) -> tuple[str, ...]:
        """The bases the declared channels drive."""
        return tuple(self._basis_ref)

    def get_addressed_states(self) -> list[States]:
        """The eigenstates the declared channels drive."""
        return get_states_from_bases(self.get_addressed_bases())

    @seq_decorators.screen
    def current_phase_ref(
        self, qubit: QubitId, basis: str = "digital"
    ) -> float:
        """Current phase reference of a specific qubit for a given basis.

        Args:
            qubit: Which qubit's phase reference to return.
            basis: The electronic transition the reference belongs to;
                must match a declared channel's basis.
        """
        if qubit not in self._qids:
            raise ValueError(
                "'qubit' must be the id of a qubit declared in "
                "this sequence's register."
            )

        if basis not in self._basis_ref:
            raise ValueError(
                f"No declared channel targets the given 'basis'"
                f" ('{basis}')."
            )

        return float(self._basis_ref[basis][qubit].phase.last_phase)

    def set_magnetic_field(
        self, bx: float = 0.0, by: float = 0.0, bz: float = 30.0
    ) -> None:
        """Sets the magnetic field acting on the entire array.

        Must happen before any pulse is added. XY-mode only — calling it
        on a fresh sequence switches the sequence into "XY Mode".

        Args:
            bx: Field component along x (in Gauss).
            by: Field component along y (in Gauss).
            bz: Field component along z (in Gauss).
        """
        blocker: str | None = None
        if self._in_xy and not self._empty_sequence:
            blocker = "on an empty sequence"
        elif not self._in_xy and self._schedule:
            blocker = "in 'XY Mode'"
        if blocker:
            raise ValueError(
                f"The magnetic field can only be set {blocker}."
            )
        self._in_xy = True  # No channels declared yet, if not XY already

        mag_vector = (bx, by, bz)
        if np.linalg.norm(mag_vector) == 0.0:
            raise ValueError(
                "The magnetic field must have a magnitude greater than 0."
            )
        self._mag_field = mag_vector

        # No parametrization -> Always stored as a regular call
        self._calls.append(_Call("set_magnetic_field", mag_vector, {}))

    def _slm_detuning_map(self, targets: set[QubitId]) -> DetuningMap:
        return self.register.define_detuning_map(
            {
                qubit: (1.0 if qubit in targets else 0)
                for qubit in self.register.qubit_ids
            }
        )

    def _set_slm_mask_dmm(
        self, dmm_id: str, targets: set[QubitId]
    ) -> None:
        detuning_map = self._slm_detuning_map(targets)
        self._config_detuning_map(detuning_map, dmm_id)
        # Find the name of the dmm in the declared channels.
        for key in reversed(self.declared_channels.keys()):
            if dmm_id == _dmm_id_from_name(key):
                self._slm_mask_dmm = key
                break
        # Modulate the dmm if pulses were already added to Global channels
        slm_mask_times = self._schedule.find_slm_mask_times()
        if not slm_mask_times:
            # Block the modulation of this dmm
            cast(
                _DMMSchedule, self._schedule[key]
            )._waiting_for_first_pulse = True
            return
        global_peaks = [
            np.max(ch_schedule.get_samples().amp[: slm_mask_times[1]])
            for ch_schedule in self._schedule.values()
            if not isinstance(ch_schedule, _DMMSchedule)
            and ch_schedule.channel_obj.addressing == "Global"
        ]
        self._modulate_slm_mask_dmm(slm_mask_times[1], max(global_peaks))

    @seq_decorators.store
    def config_slm_mask(
        self, qubits: Collection[QubitId], dmm_id: str = "dmm_0"
    ) -> None:
        """Sets up an SLM mask by specifying the qubits it targets.

        XY mode: masked qubits are shielded from incoming pulses until the
        earliest-starting global pulse finishes.

        Ising mode: the mask is realized as a DetuningMap with weight 1.0
        on each masked qubit, driven by a strongly negative detuning.

        Args:
            qubits: Qubit IDs to mask during the sequence's first global
                pulse.
            dmm_id: Which of the device's DMM channels to use.
        """
        if not self.device.supports_slm_mask:
            raise ValueError(
                f"The '{self.device}' device does not have an SLM mask."
            )

        if self.is_register_mappable():
            raise RuntimeError(
                "The SLM mask can't be combined with a mappable register."
            )

        try:
            targets = set(qubits)
        except TypeError:
            raise TypeError("The SLM targets must be castable to set.")

        if not targets.issubset(self._qids):
            raise ValueError(
                "SLM mask targets must exist in the register."
            )

        # If the sequence is parametrized the SLM is configured at build
        if self.is_parametrized():
            return

        if self._slm_mask_targets:
            raise ValueError("SLM mask can be configured only once.")

        if self._in_xy or not self._in_ising:
            if dmm_id not in self.device.dmm_channels:
                raise ValueError(self._unknown_dmm_message(dmm_id))
            self._slm_mask_dmm = dmm_id
        if not self._in_xy and self._in_ising:
            self._set_slm_mask_dmm(dmm_id, targets)
        self._slm_mask_targets = targets

    def _unknown_dmm_message(self, dmm_id: str) -> str:
        return (
            f"No DMM called {dmm_id} is available in the device. "
            f"Your selected device {self.device.name} has the "
            "following DMM channels available: "
            f"{list(self.device.dmm_channels.keys())}."
        )

    @seq_decorators.store
    @seq_decorators.conditionally_block()
    def config_detuning_map(
        self,
        detuning_map: DetuningMap,
        dmm_id: str | None = None,
    ) -> None:
        """Declares a new DMM channel to the Sequence.

        Binds a DetuningMap to one of the Device's DMM channels.

        Note:
            A physical device's DMM can only be declared once;
            ``MockDevice`` DMMs may be re-declared freely.

        Args:
            detuning_map: The per-atom detuning weights to apply.
            dmm_id: The device-side ID of the DMM channel; the first
                available one when omitted.
        """
        if dmm_id is None:
            dmm_id = next(
                (
                    ch_id
                    for ch_id, ch_obj in self.available_channels.items()
                    if isinstance(ch_obj, DMM)
                ),
                None,
            )
            if dmm_id is None:
                raise ValueError(
                    "No DMM channel is still available in device "
                    f"{self.device.name!r}."
                )
        self._config_detuning_map(detuning_map, dmm_id)

    def _config_detuning_map(
        self,
        detuning_map: DetuningMap,
        dmm_id: str,
    ) -> None:
        if dmm_id not in self.device.dmm_channels:
            raise ValueError(self._unknown_dmm_message(dmm_id))

        dmm_ch = self.device.dmm_channels[dmm_id]
        if self._in_xy:
            raise ValueError(
                f"DMM '{dmm_ch}' cannot work simultaneously "
                "with the declared 'Microwave' channel."
            )
        if dmm_id not in self.available_channels:
            raise ValueError(f"DMM {dmm_id} is not available.")

        # Configures the DMM implementing an SLM mask if configured before
        self._in_ising = True

        if self.is_parametrized():
            return
        # Add a suffix to the DMM id on repetition in declared channels
        dmm_name = dmm_id
        if dmm_id in self.declared_channels:
            assert self.device.reusable_channels
            dmm_name = _get_dmm_name(
                dmm_id, list(self.declared_channels.keys())
            )

        self._schedule[dmm_name] = _DMMSchedule(
            dmm_id, dmm_ch, detuning_map=detuning_map
        )
        if "ground-rydberg" not in self._basis_ref:
            self._basis_ref["ground-rydberg"] = {
                q: _QubitRef() for q in self._qids
            }

        # DMM has Global addressing
        self._add_to_schedule(
            dmm_name, _TimeSlot("target", -1, 0, self._qids)
        )

    def with_new_register(
        self, new_register: BaseRegister | MappableRegister
    ) -> Sequence:
        """Replicate the sequence with a different register.

        Replays every instruction of this sequence on a fresh sequence
        carrying the provided register. Instructions that name qubit IDs
        require those IDs to exist in the new register too.

        Args:
            new_register: The register for the replicated sequence.

        Returns:
            The sequence with the new register.
        """
        new_seq = type(self)(register=new_register, device=self.device)
        # The replicated sequence shares this one's variables
        new_seq._variables = self.declared_variables
        replayed = self._calls[1:] + self._to_build_calls
        if any(c.name == "config_detuning_map" for c in replayed):
            warnings.warn(
                "Switching the register of a sequence that configures"
                " a detuning map. Please ensure that the new qubit"
                " positions are still aligned.",
                stacklevel=2,
            )
        for call in replayed:
            getattr(new_seq, call.name)(*call.args, **call.kwargs)
        return new_seq

    def switch_register(
        self, new_register: BaseRegister | MappableRegister
    ) -> Sequence:
        """Deprecated alias of with_new_register()."""
        warnings.warn(
            "'Sequence.switch_register()' has been deprecated and replaced"
            " by 'Sequence.with_new_register()'.",
            DeprecationWarning,
            stacklevel=2,
        )
        return self.with_new_register(new_register)

    def with_new_device(
        self, new_device: DeviceType, strict: bool = False
    ) -> Sequence:
        """Replicate the sequence with a different device.

        Ports the sequence while disturbing its contents as little as
        possible; under `strict`, the switch errors out whenever content
        preservation cannot be guaranteed.

        Args:
            new_device: The device to port to.
            strict: Demand an exact device/channel match so the pulse
                sequence is provably unchanged.

        Returns:
            The sequence on the new device.
        """
        from pulser_tpu_torch.sequence.helpers._switch_device import (
            switch_device,
        )

        return switch_device(self, new_device, strict)

    def switch_device(
        self, new_device: DeviceType, strict: bool = False
    ) -> Sequence:
        """Deprecated alias of with_new_device()."""
        warnings.warn(
            "'Sequence.switch_device()' has been deprecated and replaced"
            " by 'Sequence.with_new_device()'.",
            DeprecationWarning,
            stacklevel=2,
        )
        return self.with_new_device(new_device, strict)

    @seq_decorators.conditionally_block()
    def declare_channel(
        self,
        name: str,
        channel_id: str,
        initial_target: Optional[
            Union[QubitId, Collection[QubitId]]
        ] = None,
    ) -> None:
        """Declares a new channel in the Sequence.

        The first channel declared fixes the sequence's operating mode
        (its Hamiltonian): declaring a ``Microwave`` channel first puts
        the sequence in "XY Mode" where only 'XY'-basis channels are
        allowed, and any other channel type forbids 'XY' ones.

        Note:
            On physical devices each channel is declared at most once;
            ``VirtualDevice`` channels with ``reusable_channels=True``
            can be re-declared.

        Args:
            name: A name for the channel, unique within the sequence.
            channel_id: The device-side channel ID (see
                ``Sequence.available_channels``).
            initial_target: Only for 'Local' channels: the target to
                start with. When None, a target instruction must be the
                channel's first addition.
        """
        ch = self._checked_channel_declaration(name, channel_id)
        if initial_target is not None and _holds_parametrized(
            initial_target
        ):
            raise TypeError("The initial_target cannot be parametrized")

        # The first declaration pins the operating mode
        if ch.basis == "XY":
            if not self._in_xy:
                self.set_magnetic_field()
                self._in_xy = True
        else:
            self._in_ising = True

        self._schedule[name] = _ChannelSchedule(channel_id, ch)
        self._basis_ref.setdefault(
            ch.basis, {q: _QubitRef() for q in self._qids}
        )

        if ch.addressing == "Global":
            self._add_to_schedule(
                name, _TimeSlot("target", -1, 0, self._qids)
            )
        elif initial_target is not None:
            if self.is_parametrized():
                # Don't store "initial_target" in a _call when
                # parametrized; it is stored as a _to_build_call when
                # target is called
                self.target(initial_target, name)
                initial_target = None
            else:
                # "_target" call is not saved
                self._target(
                    cast(Union[Collection, QubitId], initial_target), name
                )

        # Manually store the channel declaration as a regular call
        self._calls.append(
            _Call(
                "declare_channel",
                (name, channel_id),
                {"initial_target": initial_target},
            )
        )

    def _checked_channel_declaration(
        self, name: str, channel_id: str
    ) -> Channel:
        """Validates a declaration and resolves the channel object."""
        if name.startswith("dmm_"):
            raise ValueError(
                "Name starting by 'dmm_' are reserved for DMM channels."
            )
        if name in self._schedule:
            raise ValueError("The given name is already in use.")
        if channel_id not in self.device.channels:
            raise ValueError(f"No channel {channel_id} in the device.")
        ch = self.device.channels[channel_id]
        if channel_id in self.available_channels:
            return ch
        # Diagnose why the channel is not on offer
        if self._in_xy and ch.basis != "XY":
            raise ValueError(
                f"Channel '{ch}' cannot work simultaneously "
                "with the declared 'Microwave' channel."
            )
        if not self._in_xy and ch.basis == "XY":
            raise ValueError(
                "Channel of type 'Microwave' cannot work "
                "simultaneously with the declared channels."
            )
        raise ValueError(f"Channel {channel_id} is not available.")

    @overload
    def declare_variable(
        self,
        name: str,
        *,
        dtype: Union[type[int], type[float]] = float,
    ) -> VariableItem: ...

    @overload
    def declare_variable(
        self,
        name: str,
        *,
        size: int,
        dtype: Union[type[int], type[float]] = float,
    ) -> Variable: ...

    def declare_variable(
        self,
        name: str,
        size: Optional[int] = None,
        dtype: Union[type[int], type[float]] = float,
    ) -> Union[Variable, VariableItem]:
        """Declare a new variable within this Sequence.

        Variables parametrize ``Waveform`` and ``Pulse`` objects, which
        can then be added to the ``Sequence`` before their values are
        known.

        Args:
            name: The variable's name, unique within the Sequence.
            size: Number of entries the variable holds. A defined size
                yields an array variable; ``None`` yields a scalar one.
            dtype: ``float`` or ``int`` — the type of the values the
                variable will receive.

        Returns:
            The declared Variable instance.
        """
        if name in ("qubits", "seq_name", "json_dumps_options"):
            raise ValueError(
                f"'{name}' is a protected name. Please choose a different"
                " name for the variable."
            )

        if name in self._variables:
            raise ValueError("Name for variable is already being used.")

        if size is None:
            # A scalar is a size-1 array variable, unwrapped
            return self.declare_variable(name, size=1, dtype=dtype)[0]
        var = Variable(name, dtype, size=size)
        self._variables[name] = var
        return var

    @seq_decorators.verify_parametrization
    @seq_decorators.conditionally_block()
    def enable_eom_mode(
        self,
        channel: str,
        amp_on: Union[float, pm.TensorLike, Parametrized],
        detuning_on: Union[float, pm.TensorLike, Parametrized],
        optimal_detuning_off: Union[float, Parametrized] = 0.0,
        correct_phase_drift: bool = False,
    ) -> None:
        """Puts a channel in EOM mode operation.

        Under EOM mode the channel plays only square pulses, all at the
        amplitude (`amp_on`) and detuning (`detuning_on`) fixed here. In
        between pulses the detuning sits at `detuning_off`, picked from a
        discrete option set determined by `amp_on` and `detuning_on`.

        Note:
            Unless the channel is empty, turning EOM mode on inserts a
            buffer during which the detuning is at `detuning_off`.

        Args:
            channel: The channel to switch into EOM mode.
            amp_on: Amplitude of the EOM pulses (rad/µs).
            detuning_on: Detuning of the EOM pulses (rad/µs).
            optimal_detuning_off: Preferred idle detuning (rad/µs); the
                nearest available option is selected.
            correct_phase_drift: Apply a phase shift compensating the
                drift accumulated while enabling EOM mode.
        """
        if self.is_in_eom_mode(channel):
            raise RuntimeError(
                f"The '{channel}' channel is already in EOM mode."
            )

        channel_obj = self.declared_channels[channel]
        if not channel_obj.supports_eom():
            raise TypeError(
                f"Channel '{channel}' does not have an EOM."
            )

        _eom_mode.begin_block(
            self,
            "enable_eom_mode",
            channel,
            amp_on,
            detuning_on,
            optimal_detuning_off,
            correct_phase_drift,
        )

    @seq_decorators.store
    @seq_decorators.conditionally_block()
    def disable_eom_mode(
        self, channel: str, correct_phase_drift: bool = False
    ) -> None:
        """Takes a channel out of EOM mode operation.

        Note:
            A buffer time is automatically inserted on disable.

        Args:
            channel: The channel to switch out of EOM mode.
            correct_phase_drift: Apply a phase shift compensating the
                drift since the last pulse (or since EOM mode started,
                when no pulse was played).
        """
        if not self.is_in_eom_mode(channel):
            raise RuntimeError(
                f"The '{channel}' channel is not in EOM mode."
            )
        _eom_mode.end_block(self, channel, correct_phase_drift)

    @seq_decorators.verify_parametrization
    @seq_decorators.conditionally_block()
    def modify_eom_setpoint(
        self,
        channel: str,
        amp_on: Union[float, pm.TensorLike, Parametrized],
        detuning_on: Union[float, pm.TensorLike, Parametrized],
        optimal_detuning_off: Union[float, Parametrized] = 0.0,
        correct_phase_drift: bool = False,
    ) -> None:
        """Modifies the setpoint of an ongoing EOM mode operation.

        Note:
            Changing the setpoint inserts a buffer during which the
            detuning sits at the `detuning_off` value.

        Args:
            channel: The channel currently operating in EOM mode.
            amp_on: New EOM pulse amplitude (rad/µs).
            detuning_on: New EOM pulse detuning (rad/µs).
            optimal_detuning_off: New preferred idle detuning (rad/µs).
            correct_phase_drift: Apply a phase shift compensating the
                drift accumulated during the setpoint change.
        """
        if not self.is_in_eom_mode(channel):
            raise RuntimeError(
                f"The '{channel}' channel is not in EOM mode."
            )

        _eom_mode.begin_block(
            self,
            "modify_eom_setpoint",
            channel,
            amp_on,
            detuning_on,
            optimal_detuning_off,
            correct_phase_drift,
        )

    @seq_decorators.store
    @seq_decorators.mark_non_empty
    @seq_decorators.conditionally_block()
    def add_eom_pulse(
        self,
        channel: str,
        duration: Union[int, Parametrized],
        phase: Union[float, pm.TensorLike, Parametrized],
        post_phase_shift: Union[float, Parametrized] = 0.0,
        protocol: PROTOCOLS = "min-delay",
        correct_phase_drift: bool = False,
    ) -> None:
        """Adds a square pulse to a channel in EOM mode.

        Note:
            A phase change between consecutive pulses still incurs the
            phase-jump buffer time, except with ``protocol='no-delay'``.

        Args:
            channel: The channel receiving the pulse.
            duration: Pulse duration (ns).
            phase: Pulse phase (radians).
            post_phase_shift: Optional phase shift (rad) right after the
                pulse ends.
            protocol: Conflict handling versus other channels (see
                `Sequence.add()`).
            correct_phase_drift: Fold into the phase a correction for the
                drift since the previous pulse (or since EOM mode began,
                for the first one).
        """
        if not self.is_in_eom_mode(channel):
            raise RuntimeError(
                f"Channel '{channel}' must be in EOM mode."
            )

        if self.is_parametrized():
            # Eagerly check whatever is already concrete
            self._validate_add_protocol(protocol)
            if not isinstance(duration, Parametrized):
                self.declared_channels[channel].validate_duration(
                    duration
                )
            _require_numeric_phases(phase, post_phase_shift)
            return

        eom_pulse, drift_params = _eom_mode.make_block_pulse(
            self, channel, duration, phase, post_phase_shift
        )
        self._add(
            eom_pulse,
            channel,
            protocol,
            phase_drift_params=(
                drift_params if correct_phase_drift else None
            ),
        )

    @seq_decorators.store
    @seq_decorators.mark_non_empty
    @seq_decorators.conditionally_block()
    def add(
        self,
        pulse: Union[Pulse, Parametrized],
        channel: str,
        protocol: PROTOCOLS = "min-delay",
    ) -> None:
        """Adds a pulse to a channel.

        Args:
            pulse: The pulse to schedule.
            channel: The channel name chosen at declaration.
            protocol: How conflicts with other channels are resolved:

                - ``'min-delay'``: the smallest delay avoiding every
                  existing conflict.
                - ``'no-delay'``: schedule immediately, conflicts or not.
                - ``'wait-for-all'``: idle until every other channel's
                  latest pulse has ended.

        Note:
            A pulse whose phase differs from its predecessor's may get an
            automatic delay honouring the channel's `phase_jump_time`
            (suppressed by ``'no-delay'``).
        """
        self._validate_channel(
            channel,
            block_eom_mode=True,
            block_if_slm=channel.startswith("dmm_"),
        )
        if isinstance(self.declared_channels[channel], DMM):
            raise ValueError(
                "`Sequence.add()` can't be used on a DMM channel. "
                "Use `Sequence.add_dmm_detuning()` instead."
            )

        self._add(pulse, channel, protocol)

    @seq_decorators.store
    @seq_decorators.mark_non_empty
    @seq_decorators.conditionally_block()
    def add_dmm_detuning(
        self,
        waveform: Union[Waveform, Parametrized],
        dmm_name: str,
        protocol: PROTOCOLS = "no-delay",
    ) -> None:
        """Adds a waveform to the detuning of a DMM.

        Args:
            waveform: The detuning waveform to play on the DMM.
            dmm_name: The DMM channel to modulate.
            protocol: Conflict-resolution protocol (defaults "no-delay").
        """
        self._validate_channel(dmm_name, block_if_slm=True)
        if not isinstance(self.declared_channels[dmm_name], DMM):
            raise ValueError(
                f"'{dmm_name}' is not the name of a DMM channel."
            )
        self._add(
            Pulse.ConstantAmplitude(0, waveform, 0),
            dmm_name,
            protocol,
        )

    @seq_decorators.store
    def target(
        self,
        qubits: Union[QubitId, Collection[QubitId]],
        channel: str,
    ) -> None:
        """Changes the target qubit of a 'Local' channel.

        Args:
            qubits: The channel's new target — one qubit ID, or several
                when the channel supports multi-qubit addressing.
            channel: The (necessarily 'Local') channel's declared name.
        """
        self._target(qubits, channel)

    @seq_decorators.store
    def target_index(
        self,
        qubits: Union[int, Collection[int], Parametrized],
        channel: str,
    ) -> None:
        """Changes the target qubit of a 'Local' channel, by index.

        Args:
            qubits: The new target, as register index(es).
            channel: The (necessarily 'Local') channel's declared name.

        Note:
            Unavailable on non-parametrized sequences over a mappable
            register.
        """
        self._target(qubits, channel, _index=True)

    @seq_decorators.store
    def delay(
        self,
        duration: Union[int, Parametrized],
        channel: str,
        at_rest: bool = False,
    ) -> None:
        """Idles a given channel for a specific duration.

        Args:
            duration: Delay length (ns).
            channel: The channel's declared name.
            at_rest: Start the delay only once the channel's previous
                pulse (output modulation included) has finished.
        """
        self._delay(duration, channel, at_rest)

    def estimate_added_delay(
        self,
        pulse: Union[Pulse, Parametrized],
        channel: str,
        protocol: PROTOCOLS = "min-delay",
    ) -> int:
        """The delay that would be added before this pulse.

        Args:
            pulse: The pulse hypothetically being added.
            channel: The channel name chosen at declaration.
            protocol: Conflict-resolution protocol.

        Returns:
            The delay that would precede the pulse.
        """
        self._validate_channel(
            channel,
            block_if_slm=channel.startswith("dmm_"),
        )
        self._validate_add_protocol(protocol)
        if self.is_parametrized() or isinstance(pulse, Parametrized):
            raise ValueError(
                "Can't compute the delay to add before a pulse if sequence"
                " or pulse is parametrized."
            )
        if self.is_in_eom_mode(channel):
            # In EOM mode the setpoint overrides the pulse's waveforms
            eom_settings = self._schedule[channel].eom_blocks[-1]
            overridden = {
                "amplitude": (
                    pulse.amplitude.samples,
                    eom_settings.rabi_freq,
                ),
                "detuning": (
                    pulse.detuning.samples,
                    eom_settings.detuning_on,
                ),
            }
            for qty, (samples, setpoint) in overridden.items():
                if np.any(samples != setpoint):
                    warnings.warn(
                        f"Channel {channel} is in EOM mode, the {qty} of"
                        " the pulse will be constant and equal to "
                        f"{setpoint}.",
                        UserWarning,
                    )
        channel_obj = self._schedule[channel].channel_obj
        last = self._last(channel)
        basis = channel_obj.basis

        phase_ref = self._resolve_phase_ref(
            channel_obj, basis, last.targets
        )
        pulse = self._validate_and_adjust_pulse(pulse, channel, phase_ref)
        phase_barriers = self._phase_barriers(basis, last.targets)
        next_time_slot = self._schedule.make_next_pulse_slot(
            pulse,
            channel,
            phase_barriers,
            protocol,
        )
        return next_time_slot.ti - last.tf

    @seq_decorators.store
    @seq_decorators.conditionally_block()
    def truncate(self, duration: int | Parametrized) -> None:
        """Truncates the sequence's contents to (at most) a duration.

        Every involved channel must accept the given duration; the final
        sequence duration may still differ from it (clock-period
        rounding, dropped short slots, dropped target/EOM instructions).

        Warning:
            A pulse cut short is treated as incomplete, so its
            `post_phase_shift` is zeroed.

        Args:
            duration: Target duration (ns).
        """
        if not isinstance(duration, Parametrized):
            for ch_obj in self.declared_channels.values():
                # Just preemptive validation, no adjustment done here
                duration_ = ch_obj.validate_duration(
                    duration, round_up=False
                )

        if self.is_parametrized():
            return

        # Adjust the phase reference of all qubits
        for basis_ref in self._basis_ref.values():
            for qubit_ref in basis_ref.values():
                qubit_ref.truncate(duration_)
        self._schedule.truncate(duration_)

    @seq_decorators.store
    @seq_decorators.conditionally_block(if_parametrized_truncated=False)
    def measure(self, basis: str = "ground-rydberg") -> None:
        """Measures in a valid basis.

        Note:
            The operating mode constrains the measurement basis: in XY
            mode only 'XY' may be measured, and never outside it.

        Args:
            basis: The measurement basis (one of
                ``device.supported_bases``).
        """
        if self._in_xy:
            available = {"XY"}
        else:
            available = self.device.supported_bases - {"XY"}
        if basis not in available:
            raise ValueError(
                f"The basis '{basis}' is not supported by the "
                "selected device and operation mode. The "
                "available options are: " + ", ".join(list(available))
            )
        if basis not in self.get_addressed_bases():
            warnings.warn(
                f"The desired measurement basis '{basis}' is not being "
                "addressed by any channel in the sequence.",
                stacklevel=2,
            )

        if self.is_parametrized():
            self._param_measurement = basis
        else:
            self._measurement = basis

    @seq_decorators.store
    def phase_shift(
        self,
        phi: float | Parametrized,
        *specific_targets: QubitId,
        basis: str = "digital",
    ) -> None:
        r"""Shifts the phase of a qubit's reference by 'phi' on a basis.

        Equivalent to an :math:`R_z(\phi)` gate.

        Args:
            phi: The phase shift (rad).
            specific_targets: Qubit ids receiving the shift; all qubits
                when empty.
            basis: The electronic transition the shift is tied to.
        """
        self._phase_shift(phi, *specific_targets, basis=basis)

    @seq_decorators.store
    def phase_shift_index(
        self,
        phi: float | Parametrized,
        *specific_targets: int | Parametrized,
        basis: str = "digital",
    ) -> None:
        r"""Shifts the phase of a qubit's reference by 'phi', by index.

        Args:
            phi: The phase shift (rad).
            specific_targets: Register indices receiving the shift; all
                qubits when empty.
            basis: The basis the shift is tied to.

        Note:
            Unavailable on non-parametrized sequences over a mappable
            register.
        """
        self._phase_shift(phi, *specific_targets, basis=basis, _index=True)

    @seq_decorators.store
    @seq_decorators.conditionally_block()
    def align(self, *channels: str, at_rest: bool = True) -> None:
        """Aligns multiple channels in time.

        Pads every listed channel with a delay so all of them end when
        the latest-finishing one does.

        Args:
            channels: Names of the channels to align.
            at_rest: Count a channel's output-modulation tail when
                deciding when it finishes.
        """
        unique_names = set(channels)
        if not unique_names <= set(self._schedule):
            raise ValueError(
                "All channel names must correspond to declared channels."
            )
        if len(unique_names) != len(channels):
            raise ValueError(
                "The same channel was provided more than once."
            )
        if len(channels) < 2:
            raise ValueError(
                "Needs at least two channels for alignment."
            )
        if self.is_parametrized():
            return

        # Everyone pads up to the latest-finishing channel
        end = max(
            self.get_duration(name, include_fall_time=at_rest)
            for name in channels
        )
        for name in channels:
            shortfall = end - self.get_duration(name)
            if shortfall > 0:
                self._delay(
                    self._schedule[name].adjust_duration(shortfall),
                    name,
                )

    def build(
        self,
        *,
        qubits: Optional[Mapping[QubitId, int]] = None,
        **vars: Union[ArrayLike, pm.TensorLike, float, int],
    ) -> Sequence:
        """Builds a sequence from the programmed instructions.

        Args:
            qubits: Qubit-ID-to-trap-ID assignment fixing the register;
                required exactly when the sequence was created with a
                MappableRegister.
            vars: A value for every variable declared on this Sequence,
                keyed by name.

        Returns:
            The Sequence built with the given variable values.
        """
        with profiling.phase("sequence.build"):
            return self._build(qubits, vars)

    def _build(
        self,
        qubits: Optional[Mapping[QubitId, int]],
        vars: dict[str, Union[ArrayLike, pm.TensorLike, float, int]],
    ) -> Sequence:
        mappable = self.is_register_mappable()
        if mappable and qubits is None:
            raise ValueError(
                "'qubits' must be specified when the sequence is"
                " created with a MappableRegister."
            )
        if not mappable and qubits is not None:
            raise ValueError(
                "'qubits' must not be specified when the sequence already"
                " has a concrete register."
            )

        self._cross_check_vars(vars)

        # Shallow copy keeps any stored parametrized objects alive while
        # the parametrization state is wiped, avoiding recursion
        seq = copy.copy(self)
        seq._reset_parametrized()

        # Replay the eagerly-executed calls onto a fresh base sequence
        assert not seq._to_build_calls
        base_calls = seq._calls[1:]
        seq = type(seq)(register=seq._register, device=seq._device)
        for call in base_calls:
            getattr(seq, call.name)(*call.args, **call.kwargs)

        if not self.is_parametrized() and not mappable:
            warnings.warn(
                "Building a non-parametrized sequence simply returns"
                " a copy of itself.",
                stacklevel=3,
            )
            return seq

        for name, value in vars.items():
            self._variables[name]._assign(value)

        if qubits:
            self._set_register(
                seq,
                cast(
                    MappableRegister, self._register
                ).build_register(qubits),
            )

        def _resolve(x: Any) -> Any:
            return x.build() if isinstance(x, Parametrized) else x

        for call in self._to_build_calls:
            built_args = [_resolve(arg) for arg in call.args]
            built_kwargs = {
                k: _resolve(v) for k, v in call.kwargs.items()
            }
            getattr(seq, call.name)(*built_args, **built_kwargs)

        return seq

    def _serialize(self, **kwargs: Any) -> str:
        """Serializes the Sequence into a JSON formatted string."""
        from pulser_tpu_torch.json.coders import PulserEncoder

        return json.dumps(self, cls=PulserEncoder, **kwargs)

    def to_abstract_repr(
        self,
        seq_name: str = "pulser-exported",
        json_dumps_options: dict[str, Any] = {},
        skip_validation: bool = False,
        **defaults: Any,
    ) -> str:
        """Serializes the Sequence into an abstract JSON object.

        Keyword Args:
            seq_name: A label for the serialized sequence.
            json_dumps_options: Extra ``json.dumps()`` options as a
                mapping ("cls" excluded).
            skip_validation: Bypass the JSON-schema validation step.
            defaults: Per-variable default values, keyed by name. With a
                MappableRegister, also pass the qubit-to-trap mapping as
                the `qubits` keyword.

        Returns:
            The sequence encoded as an abstract JSON object.
        """
        from pulser_tpu_torch.json.abstract_repr.serializer import (
            serialize_abstract_sequence,
        )

        from pulser_tpu_torch.exceptions.serialization import (
            SchemaValidationError,
        )

        try:
            return serialize_abstract_sequence(
                self,
                seq_name=seq_name,
                json_dumps_options=json_dumps_options,
                skip_validation=skip_validation,
                metadata=_get_metadata(),
                **defaults,
            )
        except SchemaValidationError as e:
            # Only schema-validation failures hint at build-time-only
            # errors in a parametrized sequence; everything else (e.g.
            # invalid 'defaults') surfaces as-is.
            if self.is_parametrized():
                raise AbstractReprError(
                    "The serialization of the parametrized sequence"
                    " failed, potentially due to an error that only"
                    " appears at build time. Check that no errors appear"
                    " when building with `Sequence.build()` or when"
                    " providing the `defaults` to"
                    " `Sequence.to_abstract_repr()`."
                ) from e
            raise
            raise e

    @staticmethod
    def _deserialize(obj: str, **kwargs: Any) -> Sequence:
        """Deserializes a (legacy) JSON formatted string."""
        if not isinstance(obj, str):
            raise TypeError(
                "The serialized sequence must be given as a string. "
                f"Instead, got object of type {type(obj)}."
            )
        if "Sequence" not in obj:
            raise ValueError(
                "The given JSON formatted string does not encode a"
                " Sequence."
            )
        from pulser_tpu_torch.json.coders import PulserDecoder

        return cast(
            Sequence, json.loads(obj, cls=PulserDecoder, **kwargs)
        )

    @staticmethod
    def from_abstract_repr(obj_str: str) -> Sequence:
        """Deserializes a sequence from an abstract JSON object.

        Args:
            obj_str: The abstract-format JSON string encoding the
                sequence.
        """
        if not isinstance(obj_str, str):
            raise TypeError(
                "The serialized sequence must be given as a string. "
                f"Instead, got object of type {type(obj_str)}."
            )
        from pulser_tpu_torch.json.abstract_repr.deserializer import (
            deserialize_abstract_sequence,
        )

        return deserialize_abstract_sequence(obj_str)

    @seq_decorators.screen
    def draw(
        self,
        mode: str = "input+output",
        as_phase_modulated: bool = False,
        draw_phase_area: bool = False,
        draw_interp_pts: bool = True,
        draw_phase_shifts: bool = False,
        draw_register: bool = False,
        draw_phase_curve: bool = True,
        draw_detuning_maps: bool = False,
        draw_qubit_amp: bool = False,
        draw_qubit_det: bool = False,
        fig_name: str | None = None,
        kwargs_savefig: dict = {},
        show: bool = True,
    ) -> None:
        """Draws the sequence in its current state.

        Args:
            mode: 'input' plots the programmed curves, 'output' the
                post-modulation expectation, 'input+output' overlays
                both.
            as_phase_modulated: Plot the equivalent phase modulation
                rather than detuning and phase offsets.
            draw_phase_area: Annotate phase and area values on the plot.
            draw_interp_pts: Mark InterpolatedWaveform interpolation
                points.
            draw_phase_shifts: Annotate phase shifts and references.
            draw_register: Render the register ahead of the pulse plot
                (SLM-masked qubits highlighted).
            draw_phase_curve: Give phase changes their own curve.
            draw_detuning_maps: Render the detuning maps.
            draw_qubit_amp: Plot the per-qubit amplitude.
            draw_qubit_det: Plot the per-qubit detuning.
            fig_name: File name to save the figure(s) under, if any.
            kwargs_savefig: Extra keyword arguments for savefig.
            show: Call `plt.show()` before returning.
        """
        import matplotlib.pyplot as plt

        from pulser_tpu_torch.sequence._seq_drawer import draw_sequence

        valid_modes = ("input", "output", "input+output")
        if mode not in valid_modes:
            raise ValueError(
                f"'mode' must be one of {valid_modes}, not '{mode}'."
            )
        if mode == "output":
            # Input-only decorations are meaningless on output curves
            for opt_name, opt_on in (
                ("draw_phase_area", draw_phase_area),
                ("draw_interp_pts", draw_interp_pts),
            ):
                if opt_on:
                    warnings.warn(
                        f"'{opt_name}' doesn't work in 'output' mode, so"
                        " it will default to 'False'.",
                        stacklevel=2,
                    )
            draw_phase_area = False
            draw_interp_pts = False
        if draw_register and self.is_register_mappable():
            raise ValueError(
                "Can't draw the register for a sequence without a defined"
                " register."
            )
        # Flags forwarded under the same name, picked up from locals()
        passthrough = (
            "draw_phase_area",
            "draw_interp_pts",
            "draw_phase_shifts",
            "draw_register",
            "draw_phase_curve",
            "draw_detuning_maps",
            "draw_qubit_amp",
            "draw_qubit_det",
        )
        scope = locals()
        figs = draw_sequence(
            self,
            draw_input="input" in mode,
            draw_modulation="output" in mode,
            phase_modulated=as_phase_modulated,
            **{name: scope[name] for name in passthrough},
        )
        fig_reg, fig, fig_qubit, fig_legend = figs
        if fig_name is not None:
            name, ext = os.path.splitext(fig_name)
            only_pulses = fig is not None and all(
                f is None for f in (fig_reg, fig_qubit, fig_legend)
            )
            for figure, tag in (
                (fig, "_pulses" if only_pulses else ""),
                (fig_reg, "_register"),
                (fig_qubit, "_per_qubit"),
                (fig_legend, "_per_qubit_legend"),
            ):
                if figure is not None:
                    figure.savefig(name + tag + ext, **kwargs_savefig)

        if show:
            plt.show()

    def _modulate_slm_mask_dmm(
        self, duration: int, max_amp: float
    ) -> None:
        if self._slm_mask_dmm is None:
            return
        dmm_obj = cast(DMM, self.declared_channels[self._slm_mask_dmm])
        n_masked = len(set(self._slm_mask_targets))
        # Aim for -10x the max amplitude, clipped to the DMM's floors
        min_det = -10 * max_amp
        if dmm_obj.bottom_detuning and min_det < dmm_obj.bottom_detuning:
            min_det = dmm_obj.bottom_detuning
        if (
            dmm_obj.total_bottom_detuning
            and min_det * n_masked < dmm_obj.total_bottom_detuning
        ):
            min_det = dmm_obj.total_bottom_detuning / n_masked
        slm_sched = self._slm_dmm_schedule
        assert slm_sched is not None
        slm_sched._waiting_for_first_pulse = False
        self._add(
            Pulse.ConstantPulse(duration, 0, min_det, 0),
            self._slm_mask_dmm,
            "no-delay",
        )

    def _add(
        self,
        pulse: Union[Pulse, Parametrized],
        channel: str,
        protocol: PROTOCOLS,
        phase_drift_params: _PhaseDriftParams | None = None,
    ) -> None:
        self._validate_add_protocol(protocol)
        if self.is_parametrized():
            if not isinstance(pulse, Parametrized):
                self._validate_and_adjust_pulse(pulse, channel)
            return

        pulse = cast(Pulse, pulse)
        channel_obj = self._schedule[channel].channel_obj
        last = self._last(channel)
        basis = channel_obj.basis

        phase_ref = self._resolve_phase_ref(
            channel_obj, basis, last.targets
        )
        pulse = self._validate_and_adjust_pulse(pulse, channel, phase_ref)
        phase_barriers = self._phase_barriers(basis, last.targets)

        self._schedule.add_pulse(
            pulse,
            channel,
            phase_barriers,
            protocol,
            phase_drift_params=phase_drift_params,
        )

        new_pulse_slot = self._last(channel)
        for qubit in last.targets:
            self._basis_ref[basis][qubit].update_last_used(
                new_pulse_slot.tf
            )

        total_phase_shift = pulse.post_phase_shift
        if phase_drift_params:
            # The phase correction done to the EOM pulse's phase must also
            # be done to the phase shift, as the phase reference is
            # effectively changed by -drift
            total_phase_shift -= float(
                phase_drift_params.calc_phase_drift(new_pulse_slot.ti)
            )
        if total_phase_shift != 0.0:
            self._phase_shift(
                total_phase_shift, *last.targets, basis=basis
            )
        # The first real global (non-DMM) pulse triggers the pending
        # SLM-mask modulation
        slm_sched = self._slm_dmm_schedule
        if (
            self._in_ising
            and slm_sched is not None
            and slm_sched._waiting_for_first_pulse
            and channel_obj.addressing == "Global"
            and not _ChannelSchedule.is_detuned_delay(pulse)
            and not isinstance(channel_obj, DMM)
        ):
            self._modulate_slm_mask_dmm(
                self._schedule[channel].get_duration(),
                np.max(pulse.amplitude.samples),
            )

    @seq_decorators.conditionally_block()
    def _target(
        self,
        qubits: Union[
            Collection[QubitId | int], QubitId | int, Parametrized
        ],
        channel: str,
        _index: bool = False,
    ) -> None:
        self._validate_channel(channel, block_eom_mode=True)
        channel_obj = self._schedule[channel].channel_obj
        qubits_set = _coerce_target_set(qubits)

        if not qubits_set:
            raise ValueError(
                "Need at least one qubit to target but none were given."
            )
        if channel_obj.addressing != "Local":
            raise ValueError(
                "Can only choose target of 'Local' channels."
            )
        if (
            channel_obj.max_targets is not None
            and len(qubits_set) > channel_obj.max_targets
        ):
            raise ValueError(
                f"This channel can target at most"
                f" {channel_obj.max_targets} qubits at a time."
            )
        qubit_ids_set = self._check_qubits_give_ids(
            *qubits_set, _index=_index
        )

        if not self.is_parametrized():
            basis = channel_obj.basis
            phase_refs = {
                float(self._basis_ref[basis][q].phase.last_phase)
                for q in qubit_ids_set
            }
            if len(phase_refs) != 1:
                raise ValueError(
                    "Cannot target multiple qubits with different "
                    "phase references for the same basis."
                )
            self._schedule.add_target(qubit_ids_set, channel)

    def _check_qubits_give_ids(
        self,
        *qubits: Union[QubitId, int, Parametrized],
        _index: bool = False,
    ) -> set[QubitId]:
        if not _index:
            ids = set(cast(Tuple[QubitId, ...], qubits))
            if not ids <= self._qids:
                raise ValueError(
                    "All given ids have to be qubit ids declared"
                    " in this sequence's register."
                )
            return ids

        register_ids = self._register.qubit_ids
        if self.is_parametrized():
            # Only validate the concrete indices; resolution waits
            # until build time
            top = len(register_ids) - 1
            for i in qubits:
                if isinstance(i, Parametrized):
                    continue
                if i not in range(top + 1):
                    raise ValueError(
                        f"All non-variable targets must be indices"
                        f" valid for the register, between 0 and "
                        f"{top}. Wrong index: {i!r}."
                    )
            return set()
        try:
            return {
                register_ids[int(index)]  # type: ignore[arg-type]
                for index in qubits
            }
        except IndexError:
            raise IndexError("Indices must exist for the register.")

    @seq_decorators.conditionally_block()
    def _delay(
        self,
        duration: Union[int, Parametrized],
        channel: str,
        at_rest: bool = False,
    ) -> None:
        self._validate_channel(channel, block_if_slm=True)
        if self.is_parametrized():
            return
        if at_rest:
            # Start counting only once the previous output dies down
            self._schedule.wait_for_fall(channel)
        if duration:
            self._schedule.add_delay(cast(int, duration), channel)

    def _phase_shift(
        self,
        phi: float | Parametrized,
        *specific_targets: QubitId | int | Parametrized,
        basis: str,
        _index: bool = False,
    ) -> None:
        if basis not in self._basis_ref:
            raise ValueError(
                f"No declared channel targets the given 'basis'"
                f" ('{basis}')."
            )

        if not specific_targets:
            warnings.warn(
                "When called without specifying targets,"
                " `Sequence.phase_shift` and `Sequence.phase_shift_index`"
                " apply a phase shift to all qubits in the register.",
                stacklevel=3,
            )
            specific_targets = self._register.qubit_ids
            _index = False

        target_ids = self._check_qubits_give_ids(
            *specific_targets, _index=_index
        )

        if not self.is_parametrized():
            phi = float(cast(float, phi))
            for qubit in target_ids:
                self._basis_ref[basis][qubit].increment_phase(phi)

    def _shift_away_drift(
        self,
        drift: float,
        targets: Collection[QubitId],
        basis: str,
    ) -> None:
        """Compensates an accumulated EOM phase drift on some targets."""
        self._phase_shift(-drift, *targets, basis=basis)

    def _resolve_phase_ref(
        self,
        channel_obj: Channel,
        basis: str,
        targets: Collection[QubitId],
    ) -> float | None:
        """The common phase reference of the targets (None on a DMM)."""
        if isinstance(channel_obj, DMM):
            return None
        ph_refs = {
            self._basis_ref[basis][q].phase.last_phase for q in targets
        }
        if len(ph_refs) != 1:
            raise ValueError(
                "Cannot do a multiple-target pulse on qubits with"
                " different phase references for the same basis."
            )
        return cast(float, ph_refs.pop())

    def _phase_barriers(
        self, basis: str, targets: Collection[QubitId]
    ) -> list[int]:
        """When each target's phase reference last changed."""
        return [
            self._basis_ref[basis][q].phase.last_time for q in targets
        ]

    def _to_dict(
        self, _module: str = "pulser_tpu_torch.sequence"
    ) -> dict[str, Any]:
        d = obj_to_dict(
            self,
            *self._calls[0].args,
            _module=_module,
            **self._calls[0].kwargs,
        )
        d["__version__"] = pulser_tpu_torch.__version__
        d["calls"] = self._calls[1:]
        d["vars"] = self._variables
        d["to_build_calls"] = self._to_build_calls
        return d

    def __str__(self) -> str:
        return seq_to_str(self)

    def _add_to_schedule(
        self, channel: str, timeslot: _TimeSlot
    ) -> None:
        self._schedule[channel].slots.append(timeslot)

    def _last(self, channel: str) -> _TimeSlot:
        """Shortcut to the last element in the channel's schedule."""
        return self._schedule[channel][-1]

    def _validate_channel(
        self,
        channel: str,
        block_eom_mode: bool = False,
        block_if_slm: bool = False,
    ) -> None:
        if isinstance(channel, Parametrized):
            raise NotImplementedError(
                "Using parametrized objects or variables to refer to"
                " channels is not supported."
            )
        if channel not in self.declared_channels:
            raise ValueError("Use the name of a declared channel.")
        if block_eom_mode and self.is_in_eom_mode(channel):
            raise RuntimeError("The chosen channel is in EOM mode.")
        # When requested, refuse to touch the SLM-reserved DMM before
        # its triggering global pulse exists
        if block_if_slm and channel == self._slm_mask_dmm:
            slm_sched = self._slm_dmm_schedule
            assert slm_sched is not None
            if slm_sched._waiting_for_first_pulse:
                raise ValueError(
                    "You should add a Pulse to a Global Channel prior to"
                    " modulating the DMM used for the SLM Mask."
                )

    def _validate_and_adjust_pulse(
        self,
        pulse: Pulse,
        channel: str,
        phase_ref: float | None = None,
    ) -> Pulse:
        channel_obj, detuning_map = self._channel_obj_and_det_map(channel)
        if detuning_map is None:
            channel_obj.validate_pulse(pulse)
        else:
            # DMM pulses carry no phase reference
            assert phase_ref is None
            cast(DMM, channel_obj).validate_pulse(pulse, detuning_map)
        _duration = channel_obj.validate_duration(pulse.duration)
        new_phase = pulse.phase + (phase_ref if phase_ref else 0)
        new_amp = pulse.amplitude
        new_det = pulse.detuning
        if _duration != pulse.duration:
            try:
                new_amp = new_amp.with_new_duration(_duration)
                new_det = new_det.with_new_duration(_duration)
            except NotImplementedError:
                raise TypeError(
                    "Failed to automatically adjust one of the pulse's"
                    " waveforms to the channel duration constraints."
                    " Choose a duration that is a multiple of "
                    f"{channel_obj.clock_period} ns."
                )
        return Pulse(new_amp, new_det, new_phase, pulse.post_phase_shift)

    def _channel_obj_and_det_map(
        self, channel: str
    ) -> tuple[Channel, DetuningMap | None]:
        """The channel object plus, for DMMs, its detuning map."""
        if channel in self._schedule:
            channel_obj = self._schedule[channel].channel_obj
            if not isinstance(channel_obj, DMM):
                return channel_obj, None
            return (
                channel_obj,
                cast(_DMMSchedule, self._schedule[channel]).detuning_map,
            )
        # Parametrized sequence with 'channel' a dmm_name: the detuning
        # map is recovered by replaying the DMM-configuring calls
        dmm_id = _dmm_id_from_name(channel)
        channel_obj = self.device.dmm_channels[dmm_id]
        declared_dmms: list[str] = []
        detuning_map: DetuningMap | None = None
        for call in self._calls[1:] + self._to_build_calls:
            if call.name in ("config_detuning_map", "config_slm_mask"):
                call_id, call_det_map = self._get_dmm_id_detuning_map(
                    call
                )
                call_name = _get_dmm_name(call_id, declared_dmms)
                declared_dmms.append(call_name)
                if call_name == channel:
                    detuning_map = call_det_map
                    break
        assert detuning_map is not None
        return channel_obj, detuning_map

    def _validate_add_protocol(self, protocol: str) -> None:
        valid_protocols = get_args(PROTOCOLS)
        if protocol not in valid_protocols:
            raise ValueError(
                f"Invalid protocol '{protocol}', only accepts protocols: "
                + ", ".join(valid_protocols)
            )

    def _reset_parametrized(self) -> None:
        """Wipes the parametrization state back to a fresh sequence."""
        self._building = True
        self._param_measurement = ""
        self._variables = {}
        self._to_build_calls = []

    def _set_register(self, seq: Sequence, reg: BaseRegister) -> None:
        """Sets the register on a sequence that had a mappable register."""
        self.device.validate_register(reg)
        qids = set(reg.qubit_ids)
        explicitly_targeted: set[QubitId] = set()
        for ch, ch_schedule in self._schedule.items():
            if ch_schedule.channel_obj.addressing == "Global":
                # Global slots now target the full concrete register
                for i, slot in enumerate(self._schedule[ch]):
                    seq._schedule[ch].slots[i] = _TimeSlot(
                        **{**slot._asdict(), "targets": qids}
                    )
            else:
                # Every explicitly targeted qubit needs a trap
                for slot in self._schedule[ch]:
                    explicitly_targeted.update(slot.targets)

        trapless = explicitly_targeted - qids
        if trapless:
            raise ValueError(
                f"Qubits {trapless} are being targeted but"
                " have not been assigned a trap."
            )
        seq._register = reg
        seq._qids = qids
        seq._calls[0] = _Call(
            "__init__", (seq._register, seq._device), {}
        )

    def _cross_check_vars(self, vars: dict[str, Any]) -> None:
        """Requires a value for each declared variable, nothing more."""
        declared = self._variables.keys()
        if vars.keys() == declared:
            return
        undeclared = vars.keys() - declared
        if undeclared:
            warnings.warn(
                "No declared variables named: " + ", ".join(undeclared),
                stacklevel=3,
            )
            for name in undeclared:
                vars.pop(name, None)
        unassigned = declared - vars.keys()
        if unassigned:
            raise TypeError(
                "Did not receive values for variables: "
                + ", ".join(unassigned)
            )
