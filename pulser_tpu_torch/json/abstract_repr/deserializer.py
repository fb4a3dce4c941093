"""Deserialization from the abstract JSON representation.

Wire-format parity with reference
``pulser-core/pulser/json/abstract_repr/deserializer.py:68-765``: the
same abstract-representation JSON objects (sequences, devices, layouts,
registers, noise models) are decoded into this framework's classes.
"""

from __future__ import annotations

import dataclasses
import json
from typing import TYPE_CHECKING, Any, Literal, Type, Union, cast

import pulser_tpu_torch
from pulser_tpu_torch.channels import DMM, Microwave, Raman, Rydberg
from pulser_tpu_torch.channels.base_channel import Channel
from pulser_tpu_torch.channels.eom import (
    OPTIONAL_ABSTR_EOM_FIELDS,
    RydbergBeam,
    RydbergEOM,
)
from pulser_tpu_torch.devices._device_datacls import (
    PARAMS_WITH_ABSTR_REPR,
    Device,
    VirtualDevice,
)
from pulser_tpu_torch.exceptions.serialization import (
    AbstractReprError,
    DeserializeDeviceError,
)
from pulser_tpu_torch.json.abstract_repr.signatures import (
    BINARY_OPERATORS,
    UNARY_OPERATORS,
)
from pulser_tpu_torch.json.abstract_repr.validation import (
    validate_abstract_repr,
)
from pulser_tpu_torch.json.utils import get_dataclass_defaults
from pulser_tpu_torch.parametrized import ParamObj, Variable
from pulser_tpu_torch.pulse import Pulse
from pulser_tpu_torch.register.mappable_reg import MappableRegister
from pulser_tpu_torch.register.register_layout import RegisterLayout
from pulser_tpu_torch.register.weight_maps import DetuningMap
from pulser_tpu_torch.waveforms import (
    BlackmanWaveform,
    CompositeWaveform,
    ConstantWaveform,
    CustomWaveform,
    InterpolatedWaveform,
    KaiserWaveform,
    RampWaveform,
    Waveform,
)

if TYPE_CHECKING:
    from pulser_tpu_torch.noise_model import NoiseModel
    from pulser_tpu_torch.register import Register, Register3D
    from pulser_tpu_torch.sequence import Sequence


VARIABLE_TYPE_MAP = {"int": int, "float": float}

ExpReturnType = Union[int, float, list, ParamObj]


def deserialize_complex(obj: Any) -> Any:
    """Searches for serialized complex numbers and converts them."""
    if isinstance(obj, list):
        return [deserialize_complex(e) for e in obj]
    if isinstance(obj, tuple):
        return tuple(deserialize_complex(e) for e in obj)
    if isinstance(obj, dict):
        if obj.keys() == {"real", "imag"}:
            return obj["real"] + 1j * obj["imag"]
        return {k: deserialize_complex(v) for k, v in obj.items()}
    return obj


def _deserialize_parameter(
    param: Union[int, float, list[int], dict[str, Any]],
    vars: dict[str, Variable],
) -> Union[ExpReturnType, Variable]:
    """Decodes a parameter: a literal, a variable ref or an expression.

    Args:
        param: The JSON-decoded parameter object.
        vars: The sequence's declared variables, by name.

    Returns:
        A literal, a :class:`Variable` or a :class:`ParamObj` expression
        tree referencing variables.
    """
    if not isinstance(param, dict):
        return param
    if "variable" in param:
        if param["variable"] not in vars:
            raise AbstractReprError(
                f"Variable '{param['variable']}' used in operations "
                "but not found in declared variables."
            )
        return vars[param["variable"]]
    if "expression" not in param:
        raise AbstractReprError(
            f"Parameter '{param}' is neither a literal nor "
            "a variable or an expression."
        )
    expression = (
        param["expression"]
        if param["expression"] != "div"
        else "truediv"
    )
    if expression in UNARY_OPERATORS:
        return cast(
            ExpReturnType,
            UNARY_OPERATORS[expression](
                _deserialize_parameter(param["lhs"], vars)
            ),
        )
    if expression in BINARY_OPERATORS:
        return cast(
            ExpReturnType,
            BINARY_OPERATORS[expression](
                _deserialize_parameter(param["lhs"], vars),
                _deserialize_parameter(param["rhs"], vars),
            ),
        )
    raise AbstractReprError(
        f"Expression '{param['expression']}' invalid."
    )


#: Waveform builders by wire-format "kind" tag; each maps the JSON
#: field names to the corresponding constructor keyword.
_WAVEFORM_BUILDERS: dict[str, tuple[Any, tuple[str, ...]]] = {
    "constant": (ConstantWaveform, ("duration", "value")),
    "ramp": (RampWaveform, ("duration", "start", "stop")),
    "blackman": (BlackmanWaveform, ("duration", "area")),
    "blackman_max": (BlackmanWaveform.from_max_val, ("max_val", "area")),
    "interpolated": (
        InterpolatedWaveform,
        ("duration", "values", "times"),
    ),
    "kaiser": (KaiserWaveform, ("duration", "area", "beta")),
    "kaiser_max": (
        KaiserWaveform.from_max_val,
        ("max_val", "area", "beta"),
    ),
    "custom": (CustomWaveform, ("samples",)),
}


def _deserialize_waveform(obj: dict, vars: dict) -> Waveform:
    kind = obj.get("kind")
    if kind == "composite":
        return CompositeWaveform(
            *(_deserialize_waveform(wf, vars) for wf in obj["waveforms"])
        )
    if kind in _WAVEFORM_BUILDERS:
        builder, fields = _WAVEFORM_BUILDERS[kind]
        return cast(
            Waveform,
            builder(
                **{
                    f: _deserialize_parameter(obj[f], vars)
                    for f in fields
                }
            ),
        )
    raise AbstractReprError(
        "The object does not encode a known waveform."
    )


def _deserialize_pulse(op: dict, vars: dict) -> Pulse | ParamObj:
    phase = _deserialize_parameter(op["phase"], vars)
    post_phase_shift = _deserialize_parameter(
        op["post_phase_shift"], vars
    )
    # A constant waveform of duration 0 marks a pulse built with
    # ConstantAmplitude/ConstantDetuning on a parametrized duration
    if (
        op["amplitude"].get("duration") == 0
        and op["amplitude"].get("kind") == "constant"
    ):
        return Pulse.ConstantAmplitude(
            amplitude=_deserialize_parameter(
                op["amplitude"]["value"], vars
            ),
            detuning=_deserialize_waveform(op["detuning"], vars),
            phase=phase,
            post_phase_shift=post_phase_shift,
        )
    if (
        op["detuning"].get("duration") == 0
        and op["detuning"].get("kind") == "constant"
    ):
        return Pulse.ConstantDetuning(
            amplitude=_deserialize_waveform(op["amplitude"], vars),
            detuning=_deserialize_parameter(
                op["detuning"]["value"], vars
            ),
            phase=phase,
            post_phase_shift=post_phase_shift,
        )
    return Pulse(
        amplitude=_deserialize_waveform(op["amplitude"], vars),
        detuning=_deserialize_waveform(op["detuning"], vars),
        phase=phase,
        post_phase_shift=post_phase_shift,
    )


# Field extractors for the declarative op table below: each returns
# a callable (op_dict, vars) -> kwarg value.
def _p(key: str):  # a (possibly parametrized) scalar
    return lambda op, vars: _deserialize_parameter(op[key], vars)


def _w(key: str):  # a waveform
    return lambda op, vars: _deserialize_waveform(op[key], vars)


def _r(key: str, *default: Any):  # a raw JSON value
    if default:
        return lambda op, vars: op.get(key, default[0])
    return lambda op, vars: op[key]


_EOM_SETPOINT_FIELDS = dict(
    channel=_r("channel"),
    amp_on=_p("amp_on"),
    detuning_on=_p("detuning_on"),
    optimal_detuning_off=_p("optimal_detuning_off"),
)

# op kind -> (Sequence method, {kwarg: extractor}). Kinds with
# irregular call shapes (varargs, composite pulse construction) are
# handled by _IRREGULAR_OPS instead.
_OP_TABLE: dict[str, tuple[str, dict[str, Any]]] = {
    "target": (
        "target_index",
        dict(qubits=_p("target"), channel=_r("channel")),
    ),
    "delay": (
        "delay",
        dict(
            duration=_p("time"),
            channel=_r("channel"),
            at_rest=_r("at_rest", False),
        ),
    ),
    "enable_eom_mode": (
        "enable_eom_mode",
        dict(
            **_EOM_SETPOINT_FIELDS,
            correct_phase_drift=_r("correct_phase_drift", False),
        ),
    ),
    "modify_eom_setpoint": (
        "modify_eom_setpoint",
        dict(
            **_EOM_SETPOINT_FIELDS,
            correct_phase_drift=_r("correct_phase_drift"),
        ),
    ),
    "add_eom_pulse": (
        "add_eom_pulse",
        dict(
            channel=_r("channel"),
            duration=_p("duration"),
            phase=_p("phase"),
            post_phase_shift=_p("post_phase_shift"),
            protocol=_r("protocol"),
            correct_phase_drift=_r("correct_phase_drift", False),
        ),
    ),
    "disable_eom_mode": (
        "disable_eom_mode",
        dict(
            channel=_r("channel"),
            correct_phase_drift=_r("correct_phase_drift", False),
        ),
    ),
    "add_dmm_detuning": (
        "add_dmm_detuning",
        dict(
            waveform=_w("waveform"),
            dmm_name=_r("dmm_name"),
            protocol=_r("protocol"),
        ),
    ),
    "config_slm_mask": (
        "config_slm_mask",
        dict(qubits=_r("qubits"), dmm_id=_r("dmm_id")),
    ),
    "truncate": ("truncate", dict(duration=_p("duration"))),
}


def _op_align(seq: Sequence, op: dict, vars: dict) -> None:
    seq.align(*op["channels"], at_rest=op.get("at_rest", True))


def _op_phase_shift(seq: Sequence, op: dict, vars: dict) -> None:
    seq.phase_shift_index(
        _deserialize_parameter(op["phi"], vars),
        *[_deserialize_parameter(t, vars) for t in op["targets"]],
        basis=op["basis"],
    )


def _op_pulse(seq: Sequence, op: dict, vars: dict) -> None:
    seq.add(
        pulse=cast(Pulse, _deserialize_pulse(op, vars)),
        channel=op["channel"],
        protocol=op["protocol"],
    )


def _op_pulse_arbitrary_phase(
    seq: Sequence, op: dict, vars: dict
) -> None:
    pulse = Pulse.ArbitraryPhase(
        amplitude=_deserialize_waveform(op["amplitude"], vars),
        phase=_deserialize_waveform(op["phase"], vars),
        post_phase_shift=_deserialize_parameter(
            op["post_phase_shift"], vars
        ),
    )
    seq.add(
        pulse=cast(Pulse, pulse),
        channel=op["channel"],
        protocol=op["protocol"],
    )


def _op_config_detuning_map(
    seq: Sequence, op: dict, vars: dict
) -> None:
    seq.config_detuning_map(
        detuning_map=_deserialize_det_map(op["detuning_map"]),
        dmm_id=op["dmm_id"],
    )


_IRREGULAR_OPS = {
    "align": _op_align,
    "phase_shift": _op_phase_shift,
    "pulse": _op_pulse,
    "pulse_arbitrary_phase": _op_pulse_arbitrary_phase,
    "config_detuning_map": _op_config_detuning_map,
}


def _deserialize_operation(
    seq: Sequence, op: dict, vars: dict
) -> None:
    kind = op["op"]
    if kind in _IRREGULAR_OPS:
        _IRREGULAR_OPS[kind](seq, op, vars)
        return
    if kind in _OP_TABLE:
        method, spec = _OP_TABLE[kind]
        getattr(seq, method)(
            **{
                kwarg: extract(op, vars)
                for kwarg, extract in spec.items()
            }
        )


def _deserialize_channel(obj: dict[str, Any]) -> Channel:
    params: dict[str, Any] = {}
    channel_cls: Type[Channel]
    if obj["basis"] == "ground-rydberg":
        if "bottom_detuning" in obj:
            channel_cls = DMM
        else:
            channel_cls = Rydberg
            params["eom_config"] = None
        if obj["eom_config"] is not None:
            data = obj["eom_config"]
            try:
                optional = {
                    key: data[key]
                    for key in OPTIONAL_ABSTR_EOM_FIELDS
                    if key in data
                }
                params["eom_config"] = RydbergEOM(
                    mod_bandwidth=data["mod_bandwidth"],
                    limiting_beam=RydbergBeam[data["limiting_beam"]],
                    max_limiting_amp=data["max_limiting_amp"],
                    intermediate_detuning=data[
                        "intermediate_detuning"
                    ],
                    controlled_beams=tuple(
                        RydbergBeam[beam]
                        for beam in data["controlled_beams"]
                    ),
                    **optional,
                )
            except ValueError as e:
                raise AbstractReprError(
                    "RydbergEOM deserialization failed."
                ) from e
    elif obj["basis"] == "digital":
        channel_cls = Raman
    elif obj["basis"] == "XY":
        channel_cls = Microwave
    # No other basis allowed by the schema

    channel_fields = dataclasses.fields(channel_cls)
    channel_defaults = get_dataclass_defaults(channel_fields)
    for param in channel_fields:
        use_default = (
            param.name not in obj and param.name in channel_defaults
        )
        if (
            param.init
            and param.name != "eom_config"
            and not use_default
        ):
            params[param.name] = obj[param.name]
    try:
        return channel_cls(**params)
    except (ValueError, NotImplementedError) as e:
        raise AbstractReprError(
            "Channel deserialization failed."
        ) from e


def _deserialize_layout(layout_obj: dict[str, Any]) -> RegisterLayout:
    try:
        return RegisterLayout(
            layout_obj["coordinates"], slug=layout_obj.get("slug")
        )
    except ValueError as e:
        raise AbstractReprError(
            "Register layout deserialization failed."
        ) from e


def _deserialize_register(
    qubits: list[dict[str, Any]], layout: RegisterLayout | None
) -> Register:
    coords = [(q["x"], q["y"]) for q in qubits]
    qubit_ids = [q["name"] for q in qubits]
    if layout:
        trap_ids = layout.get_traps_from_coordinates(*coords)
        reg = layout.define_register(*trap_ids, qubit_ids=qubit_ids)
    else:
        reg = pulser_tpu_torch.Register(dict(zip(qubit_ids, coords)))
    return cast("Register", reg)


def _deserialize_register3d(
    qubits: list[dict[str, Any]], layout: RegisterLayout | None
) -> Register3D:
    coords = [(q["x"], q["y"], q["z"]) for q in qubits]
    qubit_ids = [q["name"] for q in qubits]
    if layout:
        trap_ids = layout.get_traps_from_coordinates(*coords)
        reg = layout.define_register(*trap_ids, qubit_ids=qubit_ids)
    else:
        reg = pulser_tpu_torch.Register3D(dict(zip(qubit_ids, coords)))
    return cast("Register3D", reg)


def _deserialize_noise_model(
    noise_model_obj: dict[str, Any]
) -> NoiseModel:
    from pulser_tpu_torch.noise_model import NoiseModel

    eff_noise_rates = []
    eff_noise_opers = []
    for rate, oper in noise_model_obj.pop("eff_noise"):
        eff_noise_rates.append(rate)
        eff_noise_opers.append(deserialize_complex(oper))

    noise_types = noise_model_obj.pop("noise_types")
    with_leakage = "leakage" in noise_types
    disable_doppler = (
        noise_model_obj["temperature"] > 0
        and "doppler" not in noise_types
    )
    relevant_params = NoiseModel._find_relevant_params(
        # doppler parameters stay relevant even when doppler is disabled
        noise_types + (["doppler"] if disable_doppler else []),
        noise_model_obj["state_prep_error"],
        noise_model_obj["amp_sigma"],
        noise_model_obj["laser_waist"],
    ) - {  # Handled separately
        "eff_noise_rates",
        "eff_noise_opers",
        "with_leakage",
    }

    detuning_sigma = noise_model_obj.get("detuning_sigma", 0)
    relevant_params -= {"detuning_sigma"}

    detuning_hf_psd = []
    detuning_hf_omegas = []
    if "detuning_hf" in noise_model_obj:
        for psd, freq in noise_model_obj.pop("detuning_hf"):
            detuning_hf_psd.append(psd)
            detuning_hf_omegas.append(freq)
    relevant_params -= {"detuning_hf_psd", "detuning_hf_omegas"}

    dmm_sigma = noise_model_obj.get("dmm_sigma", 0)
    relevant_params -= {"dmm_sigma"}

    detuning_map_spot_waist = noise_model_obj.get(
        "detuning_map_spot_waist", None
    )
    relevant_params -= {"detuning_map_spot_waist"}

    noise_model = NoiseModel(
        **{
            param: noise_model_obj[param]
            for param in relevant_params
        },
        eff_noise_rates=tuple(eff_noise_rates),
        eff_noise_opers=tuple(eff_noise_opers),
        with_leakage=with_leakage,
        disable_doppler=disable_doppler,
        detuning_hf_psd=tuple(detuning_hf_psd),
        detuning_hf_omegas=tuple(detuning_hf_omegas),
        detuning_sigma=detuning_sigma,
        dmm_sigma=dmm_sigma,
        detuning_map_spot_waist=detuning_map_spot_waist,
    )
    assert set(noise_model.noise_types) == set(noise_types)
    return noise_model


def _deserialize_device_object(
    obj: dict[str, Any]
) -> Device | VirtualDevice:
    from pulser_tpu_torch.devices.interaction_coefficients import c3_dict

    device_cls: Type[Device] | Type[VirtualDevice] = (
        VirtualDevice if obj["is_virtual"] else Device
    )
    ch_ids = []
    ch_objs = []
    for ch in obj["channels"]:
        ch_ids.append(ch["id"])
        ch_objs.append(_deserialize_channel(ch))
    params: dict[str, Any] = dict(
        channel_ids=tuple(ch_ids), channel_objects=tuple(ch_objs)
    )
    if "dmm_objects" in obj:
        params["dmm_objects"] = tuple(
            _deserialize_channel(dmm_ch)
            for dmm_ch in obj["dmm_objects"]
        )
    device_fields = dataclasses.fields(device_cls)
    device_defaults = get_dataclass_defaults(device_fields)
    for param in device_fields:
        # noise_model travels as "default_noise_model" on the wire
        in_obj = param.name in obj or (
            param.name == "noise_model"
            and "default_noise_model" in obj
        )
        use_default = not in_obj and param.name in device_defaults
        if (
            not param.init
            or param.name in PARAMS_WITH_ABSTR_REPR
            or use_default
        ):
            continue
        if param.name == "pre_calibrated_layouts":
            params["pre_calibrated_layouts"] = tuple(
                _deserialize_layout(layout)
                for layout in obj["pre_calibrated_layouts"]
            )
        elif param.name == "noise_model":
            params["noise_model"] = _deserialize_noise_model(
                obj["default_noise_model"]
            )
        else:
            params[param.name] = obj[param.name]
    # 'interaction_coeff_xy' is inferred from 'rydberg_level' but always
    # present on the wire; only pass it through when customized.
    if "interaction_coeff_xy" in obj:
        rydberg_level = params.get("rydberg_level")
        if rydberg_level is None or (
            obj["interaction_coeff_xy"] != c3_dict[rydberg_level]
        ):
            params["interaction_coeff_xy"] = obj[
                "interaction_coeff_xy"
            ]
    try:
        return device_cls(**params)
    except (ValueError, TypeError) as e:
        raise AbstractReprError(
            "Device deserialization failed."
        ) from e


def _deserialize_det_map(ser_det_map: dict) -> DetuningMap:
    trap_coords = []
    weights = []
    for trap in ser_det_map["traps"]:
        trap_coords.append((trap["x"], trap["y"]))
        weights.append(trap["weight"])
    return DetuningMap(
        trap_coordinates=trap_coords,
        weights=weights,
        slug=ser_det_map.get("slug"),
    )


def deserialize_abstract_sequence(obj_str: str) -> Sequence:
    """Deserializes a sequence from an abstract JSON object.

    Args:
        obj_str: The JSON string representing the sequence encoded in
            the abstract JSON format.

    Returns:
        The deserialized Sequence.
    """
    import pulser_tpu_torch.devices as devices_pkg
    from pulser_tpu_torch.sequence import Sequence

    validate_abstract_repr(obj_str, "sequence")
    obj = json.loads(obj_str)

    if isinstance(obj["device"], str):
        device = getattr(devices_pkg, obj["device"])
    else:
        device = _deserialize_device_object(obj["device"])

    layout = (
        _deserialize_layout(obj["layout"]) if "layout" in obj else None
    )

    reg: Register | Register3D | MappableRegister
    qubits = obj["register"]
    if {"name", "x", "y"} == qubits[0].keys():
        reg = _deserialize_register(qubits, layout)
    elif {"name", "x", "y", "z"} == qubits[0].keys():
        reg = _deserialize_register3d(qubits, layout)
    else:
        assert (
            layout is not None
        ), "Layout must be defined in a MappableRegister."
        reg = MappableRegister(layout, *(d["qid"] for d in qubits))

    seq = Sequence(reg, device)

    for name, channel_id in obj["channels"].items():
        seq.declare_channel(name, channel_id)

    if "magnetic_field" in obj:
        seq.set_magnetic_field(*obj["magnetic_field"])

    if "slm_mask_targets" in obj:
        # Legacy (XY-mode) SLM mask form
        seq.config_slm_mask(obj["slm_mask_targets"])

    vars: dict[str, Variable] = {}
    for name, desc in obj["variables"].items():
        vars[name] = seq.declare_variable(
            cast(str, name),
            size=len(desc["value"]),
            dtype=VARIABLE_TYPE_MAP[desc["type"]],
        )

    for op in obj["operations"]:
        _deserialize_operation(seq, op, vars)

    if obj["measurement"] is not None:
        seq.measure(obj["measurement"])

    return seq


def deserialize_device(obj_str: str) -> Device | VirtualDevice:
    """Deserializes a device from an abstract JSON object.

    Args:
        obj_str: The JSON string representing the device encoded in the
            abstract JSON format.

    Raises:
        DeserializeDeviceError: If deserialization fails due to an
            invalid 'obj_str'.
    """
    if not isinstance(obj_str, str):
        type_error = TypeError(
            f"'obj_str' must be a string, not {type(obj_str)}."
        )
        raise DeserializeDeviceError from type_error
    try:
        validate_abstract_repr(obj_str, "device")
        return _deserialize_device_object(json.loads(obj_str))
    except Exception as e:
        # json.JSONDecodeError, schema validation or AbstractReprError
        raise DeserializeDeviceError from e


def deserialize_abstract_layout(obj_str: str) -> RegisterLayout:
    """Deserializes a layout from an abstract JSON object."""
    validate_abstract_repr(obj_str, "layout")
    return _deserialize_layout(json.loads(obj_str))


def deserialize_abstract_register(
    obj_str: str, expected_dim: Literal[None, 2, 3] = None
) -> Register | Register3D:
    """Deserializes a register from an abstract JSON object.

    Args:
        obj_str: The JSON string representing the register encoded in
            the abstract JSON format.
        expected_dim: If defined, ensures the register has the
            specified dimensionality.
    """
    if expected_dim not in (None, 2, 3):
        raise ValueError(
            "When specified, 'expected_dim' must be 2 or 3, "
            f"not {expected_dim!s}."
        )
    validate_abstract_repr(obj_str, "register")
    obj = json.loads(obj_str)
    layout = (
        _deserialize_layout(obj["layout"]) if "layout" in obj else None
    )
    qubits = obj["register"]
    dim_ = len(set(qubits[0]) - {"name"})
    assert dim_ == 2 or dim_ == 3
    assert layout is None or layout.dimensionality == dim_
    if expected_dim is not None and expected_dim != dim_:
        raise ValueError(
            f"The provided register must be in {expected_dim}D, "
            f"not {dim_}D."
        )
    if dim_ == 3:
        return _deserialize_register3d(qubits=qubits, layout=layout)
    return _deserialize_register(qubits=qubits, layout=layout)


def deserialize_abstract_noise_model(obj_str: str) -> NoiseModel:
    """Deserializes a noise model from an abstract JSON object."""
    validate_abstract_repr(obj_str, "noise")
    return _deserialize_noise_model(json.loads(obj_str))
