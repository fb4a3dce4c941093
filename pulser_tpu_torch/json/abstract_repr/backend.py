"""(De)serialization logic specific to the backend module.

Behavioral parity with reference
``pulser-core/pulser/json/abstract_repr/backend.py:33-145``. Every
observable kind deserializes through one registry row — constructor
plus an optional leading field to decode — instead of a hand-written
dispatch chain.
"""

from __future__ import annotations

import uuid
from typing import TYPE_CHECKING, Any, Optional, Type, TypeVar

from pulser_tpu_torch.backend.default_observables import (
    BitStrings,
    CorrelationMatrix,
    Energy,
    EnergySecondMoment,
    EnergyVariance,
    Expectation,
    Fidelity,
    Occupation,
)
from pulser_tpu_torch.backend.observable import AggregationMethod
from pulser_tpu_torch.exceptions.serialization import AbstractReprError
from pulser_tpu_torch.json.abstract_repr.deserializer import (
    _deserialize_noise_model,
    deserialize_complex,
)

if TYPE_CHECKING:
    from pulser_tpu_torch.backend import (
        EmulationConfig,
        Observable,
        Operator,
        State,
    )

EmulationConfigType = TypeVar(
    "EmulationConfigType", bound="EmulationConfig"
)
StateType = TypeVar("StateType", bound="State")
OperatorType = TypeVar("OperatorType", bound="Operator")


def _deserialize_state(
    ser_state: dict, state_type: Type[StateType]
) -> StateType:
    """Decodes a state from its abstract representation.

    Args:
        ser_state: The state in the abstract JSON format.
        state_type: The State class to instantiate.
    """
    return state_type.from_state_amplitudes(
        eigenstates=ser_state["eigenstates"],
        amplitudes=deserialize_complex(ser_state["amplitudes"]),
    )


def _deserialize_operator(
    ser_op: dict, op_type: Type[OperatorType]
) -> OperatorType:
    """Decodes an operator from its abstract representation.

    Args:
        ser_op: The operator in the abstract JSON format.
        op_type: The Operator class to instantiate.
    """
    # Re-shape the nested lists into the FullOp tuple structure:
    # [[coeff, [[op, qudits], ...]], ...] -> (coeff, [(op, qudits)..])
    operations = [
        (coeff, [tuple(qudit_op) for qudit_op in qudit_ops])
        for coeff, qudit_ops in ser_op["operations"]
    ]
    return op_type.from_operator_repr(
        eigenstates=ser_op["eigenstates"],
        n_qudits=ser_op["n_qudits"],
        operations=deserialize_complex(operations),
    )


#: Wire tag -> (constructor, leading-argument spec). The spec names
#: the serialized field that becomes the constructor's positional
#: argument and how to decode it ("state" or "operator"); None means
#: keyword arguments only.
_OBSERVABLE_ROWS: dict[str, tuple[Any, Optional[tuple[str, str]]]] = {
    "bitstrings": (BitStrings, None),
    "occupation": (Occupation, None),
    "correlation_matrix": (CorrelationMatrix, None),
    "energy": (Energy, None),
    "energy_second_moment": (EnergySecondMoment, None),
    "energy_variance": (EnergyVariance, None),
    "expectation": (Expectation, ("operator", "operator")),
    "fidelity": (Fidelity, ("state", "state")),
}


def _deserialize_observable(
    ser_obs: dict, state_type: Type[State], op_type: Type[Operator]
) -> Observable:
    obs_params = ser_obs.copy()
    obs_name = obs_params.pop("observable")
    obs_uuid = obs_params.pop("uuid", None)
    if "default_aggregation_method" in obs_params:
        obs_params["default_aggregation_method"] = AggregationMethod(
            obs_params["default_aggregation_method"]
        )
    if obs_name not in _OBSERVABLE_ROWS:
        raise AbstractReprError(
            f"Failed to deserialize the observable tagged"
            f" `{obs_name}` as unknown or not supported. This likely"
            " implies that the JSON abstract representation of the"
            " emulation configuration has not been validated or has"
            " been corrupted."
        )
    constructor, leading = _OBSERVABLE_ROWS[obs_name]
    args: tuple = ()
    if leading is not None:
        field, decode_as = leading
        raw = obs_params.pop(field)
        args = (
            _deserialize_state(raw, state_type)
            if decode_as == "state"
            else _deserialize_operator(raw, op_type),
        )
    obs: Observable = constructor(*args, **obs_params)
    if obs_uuid is not None:
        obs._uuid = uuid.UUID(obs_uuid)
    return obs


def _deserialize_emulation_config(
    ser_config: dict,
    config_type: Type[EmulationConfigType],
    state_type: Type[StateType],
    op_type: Type[Operator],
) -> EmulationConfigType:
    plain = {
        k: v
        for k, v in ser_config.items()
        if k not in ("observables", "noise_model", "initial_state")
    }
    raw_initial = ser_config.get("initial_state")
    return config_type(
        observables=[
            _deserialize_observable(obs, state_type, op_type)
            for obs in ser_config["observables"]
        ],
        noise_model=_deserialize_noise_model(
            ser_config["noise_model"]
        ),
        initial_state=(
            None
            if raw_initial is None
            else _deserialize_state(raw_initial, state_type)
        ),
        **plain,
    )
