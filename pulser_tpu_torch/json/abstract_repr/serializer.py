"""JSON serialization for the abstract representation.

Wire-format parity with reference
``pulser-core/pulser/json/abstract_repr/serializer.py`` (the emitted
JSON must match the published schemas byte-for-byte in structure).
Internally organized differently: argument recovery goes through
``inspect.Signature.bind`` instead of hand-rolled default lookups, and
the per-operation emission logic is a declarative rule table with a
generic emitter, with closures only for the handful of operations that
mutate the top-level document.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Callable, Union, cast

import numpy as np
import torch

from pulser_tpu_torch.exceptions.serialization import AbstractReprError
from pulser_tpu_torch.json.abstract_repr.signatures import SIGNATURES

import pulser_tpu_torch.math as pm

if TYPE_CHECKING:
    from pulser_tpu_torch.sequence import Sequence


def _tensor_tolist(t: torch.Tensor) -> list:
    """A tensor's values as a list, read on the host; a tensor that
    requires grad is refused as ``AbstractArray`` refuses it."""
    if t.requires_grad:
        raise NotImplementedError(
            "A tensor that requires grad can't be serialized"
            " without losing the computational graph information."
        )
    return t.cpu().numpy().tolist()


# Ordered (type, converter) fallbacks for objects without a
# ``_to_abstract_repr`` method. Checked in sequence, first match wins.
# torch.Tensor takes the place of the JAX package's jax.Array, as in the
# reference encoder (pulser-core/pulser/json/abstract_repr/serializer.py:49-57).
_JSON_FALLBACKS: tuple[tuple[type, Callable[[Any], Any]], ...] = (
    (pm.AbstractArray, lambda a: a.tolist()),
    (torch.Tensor, _tensor_tolist),
    (np.ndarray, lambda a: a.tolist()),
    (np.integer, int),
    (np.floating, float),
    (set, list),
    (
        complex,
        lambda z: z.real if z.imag == 0 else dict(real=z.real, imag=z.imag),
    ),
)


class AbstractReprEncoder(json.JSONEncoder):
    """The custom encoder for abstract representation of pulser objects."""

    def default(self, o: Any) -> Union[dict[str, Any], list, int, float]:
        """Handles JSON encoding of objects not supported by default."""
        to_repr = getattr(o, "_to_abstract_repr", None)
        if to_repr is not None:
            return cast(dict, to_repr())
        for typ, convert in _JSON_FALLBACKS:
            if isinstance(o, typ):
                return cast(Any, convert(o))
        return cast(dict, json.JSONEncoder.default(self, o))  # pragma: no cover


def abstract_repr(name: str, *args: Any, **kwargs: Any) -> dict[str, Any]:
    """Generates the abstract repr of an object with a defined signature.

    Binds ``args``/``kwargs`` against the registered
    :class:`~pulser_tpu_torch.json.abstract_repr.signatures.PulserSignature`
    and returns the wire dict (``extra`` entries first, then the bound
    arguments).
    """
    sig = SIGNATURES.get(name)
    if sig is None:
        raise ValueError(f"No signature found for '{name}'.")

    # Required slots not covered positionally may arrive as kwargs —
    # but only for signatures without a variadic tail.
    missing = sig.pos[len(args):]
    if missing and (
        sig.var_pos is not None or any(m not in kwargs for m in missing)
    ):
        raise ValueError(
            f"Not enough arguments given for '{name}' (expected "
            f"{len(sig.pos)}, got {len(args)})."
        )

    out: dict[str, Any] = dict(sig.extra)
    if sig.var_pos is not None:
        out.update(zip(sig.pos, args))
        out[sig.var_pos] = args[len(sig.pos):]
    else:
        # Overflow positionals spill into keyword slots (in signature
        # order), but never past the slots left free by ``kwargs``.
        n_free = len(sig.pos) + sum(
            1 for kw in sig.keyword if kw not in kwargs
        )
        if len(args) > n_free:
            raise ValueError(
                f"Too many positional arguments given for '{name}' "
                f"(expected {n_free}, got {len(args)})."
            )
        out.update(zip(sig.all_pos_args(), args))

    accepted = set(sig.keyword).union(missing)
    for key, value in kwargs.items():
        if key not in accepted:
            raise ValueError(
                f"Keyword argument '{key}' is not in the signature of "
                f"'{name}'."
            )
        out[key] = value
    return out


@dataclass(frozen=True)
class _OpRule:
    """Declarative emission rule for one recorded sequence call.

    Generic rules map the call's (fully bound) arguments onto a wire
    dict ``{"op": op, **fields}``; ``trim`` lists keyword fields that
    are left out when they equal the method's declared default, and
    ``rename`` maps argument names onto differing wire keys.
    """

    op: str
    fields: tuple[str, ...]
    trim: tuple[str, ...] = ()
    rename: dict[str, str] = field(default_factory=dict)


_GENERIC_RULES: dict[str, _OpRule] = {
    "config_detuning_map": _OpRule(
        "config_detuning_map", ("detuning_map", "dmm_id")
    ),
    "delay": _OpRule(
        "delay",
        ("duration", "channel", "at_rest"),
        trim=("at_rest",),
        rename={"duration": "time"},
    ),
    "enable_eom_mode": _OpRule(
        "enable_eom_mode",
        (
            "channel",
            "amp_on",
            "detuning_on",
            "optimal_detuning_off",
            "correct_phase_drift",
        ),
        trim=("correct_phase_drift",),
    ),
    "modify_eom_setpoint": _OpRule(
        "modify_eom_setpoint",
        (
            "channel",
            "amp_on",
            "detuning_on",
            "optimal_detuning_off",
            "correct_phase_drift",
        ),
    ),
    "add_eom_pulse": _OpRule(
        "add_eom_pulse",
        (
            "channel",
            "duration",
            "phase",
            "post_phase_shift",
            "protocol",
            "correct_phase_drift",
        ),
        trim=("correct_phase_drift",),
    ),
    "disable_eom_mode": _OpRule(
        "disable_eom_mode",
        ("channel", "correct_phase_drift"),
        trim=("correct_phase_drift",),
    ),
    "add_dmm_detuning": _OpRule(
        "add_dmm_detuning", ("waveform", "dmm_name", "protocol")
    ),
    "truncate": _OpRule("truncate", ("duration",)),
}


def serialize_abstract_sequence(
    seq: Sequence,
    seq_name: str = "pulser-exported",
    json_dumps_options: dict[str, Any] = {},
    skip_validation: bool = False,
    metadata: dict[str, dict[str, Any]] | None = None,
    **defaults: Any,
) -> str:
    """Serializes a Sequence into the abstract JSON wire format.

    Wire-format parity with reference ``serializer.py:109-422``
    (``serialize_abstract_sequence``): every sequence-building call is
    mapped to its abstract operation dict.

    Keyword Args:
        seq_name: A name for the sequence.
        json_dumps_options: Optional parameters of ``json.dumps()``
            (cannot include "cls").
        skip_validation: Whether to skip validating the output against
            the abstract representation's JSON schema.
        metadata: Optional tool metadata, stored under "metadata".
        defaults: Default values for all declared variables (by name).
            With a MappableRegister, the qubit-to-trap mapping must also
            be given under the `qubits` keyword.

    Returns:
        The sequence encoded as an abstract JSON string.
    """
    import inspect
    from itertools import chain

    import pulser_tpu_torch
    from pulser_tpu_torch.json.abstract_repr.validation import (
        validate_abstract_repr,
    )
    from pulser_tpu_torch.json.utils import stringify_qubit_ids
    from pulser_tpu_torch.parametrized import Parametrized

    doc: dict[str, Any] = {
        "version": "1",
        "name": seq_name,
        "register": [],
        "channels": {},
        "variables": {},
        "operations": [],
        "measurement": None,
        "pulser_version": pulser_tpu_torch.__version__,
    }
    if metadata:
        doc["metadata"] = metadata

    # -- variables block -------------------------------------------
    # Every declared variable is listed with its dtype; its value is
    # either the caller-supplied default (validated by a trial build)
    # or a dtype-zero placeholder of the right size (the deserializer
    # infers each variable's size from its value).
    qubits_default = defaults.pop("qubits", None)
    with_values = bool(defaults) or qubits_default is not None
    if with_values:
        seq._cross_check_vars(defaults)
        try:
            seq.build(qubits=qubits_default, **defaults)
        except Exception:
            raise ValueError(
                "The given 'defaults' produce an invalid sequence."
            )
    for var in seq._variables.values():
        value = (
            var._validate_value(defaults[var.name]).tolist()
            if with_values
            else [var.dtype()] * var.size
        )
        doc["variables"][var.name] = dict(
            type=var.dtype.__name__, value=value
        )

    # -- call-argument recovery ------------------------------------

    def bound_args(call: Any) -> dict[str, Any]:
        """All of the call's arguments, with declared defaults filled."""
        method_sig = inspect.signature(getattr(seq, call.name))
        bound = method_sig.bind(*call.args, **call.kwargs)
        bound.apply_defaults()
        return dict(bound.arguments)

    def declared_default(call_name: str, arg: str) -> Any:
        sig = inspect.signature(getattr(seq, call_name))
        return sig.parameters[arg].default

    def single_or_list(target_ids: Any) -> Any:
        """Unwraps 1-element collections of qubit ids."""
        if isinstance(target_ids, (int, str)):
            return target_ids
        as_list = list(target_ids)
        return as_list[0] if len(as_list) == 1 else as_list

    def targets_to_indices(
        target_ids: Any, force_list_out: bool = False
    ) -> Union[int, list[int]]:
        """Qubit ids -> register indices, preserving scalar-ness."""
        unwrapped = single_or_list(target_ids)
        scalar = np.ndim(unwrapped) == 0
        reg = seq.get_register(include_mappable=True)
        indices = reg.find_indices(
            [unwrapped] if scalar else list(unwrapped)
        )
        if scalar and not force_list_out:
            return indices[0]
        return indices

    # -- operations ------------------------------------------------

    operations: list[dict[str, Any]] = doc["operations"]

    def emit_generic(rule: _OpRule, call: Any) -> None:
        data = bound_args(call)
        wire: dict[str, Any] = {"op": rule.op}
        for name in rule.fields:
            if name in rule.trim and data[name] == declared_default(
                call.name, name
            ):
                continue
            wire[rule.rename.get(name, name)] = data[name]
        operations.append(wire)

    def emit_init(call: Any) -> None:
        data = bound_args(call)
        doc["device"] = data["device"]
        doc["register"] = data["register"]
        layout = data["register"].layout
        if layout is not None:
            doc["layout"] = layout
        if qubits_default is not None:
            serial_reg = doc["register"]._to_abstract_repr()
            for q_dict in serial_reg:
                if q_dict["qid"] in qubits_default:
                    q_dict["default_trap"] = qubits_default[q_dict["qid"]]
            doc["register"] = serial_reg

    def emit_declare_channel(call: Any) -> None:
        data = bound_args(call)
        doc["channels"][data["name"]] = data["channel_id"]
        if data["initial_target"] is not None:
            operations.append(
                {
                    "op": "target",
                    "channel": data["name"],
                    "target": targets_to_indices(data["initial_target"]),
                }
            )

    def emit_target(call: Any) -> None:
        data = bound_args(call)
        if call.name == "target":
            target: Any = targets_to_indices(data["qubits"])
        elif isinstance(data["qubits"], Parametrized):
            target = data["qubits"]
        else:  # target_index with literal indices
            target = single_or_list(data["qubits"])
        operations.append(
            {"op": "target", "channel": data["channel"], "target": target}
        )

    def emit_align(call: Any) -> None:
        data = bound_args(call)
        wire: dict[str, Any] = {
            "op": "align",
            "channels": list(data["channels"]),
        }
        if data["at_rest"] != declared_default("align", "at_rest"):
            wire["at_rest"] = data["at_rest"]
        operations.append(wire)

    def emit_measure(call: Any) -> None:
        doc["measurement"] = bound_args(call)["basis"]

    def emit_add(call: Any) -> None:
        data = bound_args(call)
        pulse_repr = data["pulse"]._to_abstract_repr()
        kind = "pulse" if "detuning" in pulse_repr else (
            "pulse_arbitrary_phase"
        )
        operations.append(
            {
                "op": kind,
                "channel": data["channel"],
                "protocol": data["protocol"],
                **pulse_repr,
            }
        )

    def emit_phase_shift(call: Any) -> None:
        data = bound_args(call)
        targets: Any = list(data["specific_targets"])
        if call.name == "phase_shift":
            targets = targets_to_indices(targets, force_list_out=True)
        operations.append(
            {
                "op": "phase_shift",
                "phi": data["phi"],
                "targets": targets,
                "basis": data["basis"],
            }
        )

    def emit_magnetic_field(call: Any) -> None:
        doc["magnetic_field"] = seq.magnetic_field.tolist()

    def emit_slm_mask(call: Any) -> None:
        data = bound_args(call)
        qubit_ids = stringify_qubit_ids(data["qubits"])
        default_dmm = declared_default(call.name, "dmm_id")
        if seq._in_xy and data["dmm_id"] == default_dmm:
            # Preserve the legacy XY-mode form for compatibility
            doc["slm_mask_targets"] = tuple(qubit_ids)
        else:
            operations.append(
                {
                    "op": "config_slm_mask",
                    "qubits": qubit_ids,
                    "dmm_id": data["dmm_id"],
                }
            )

    special_rules: dict[str, Callable[[Any], None]] = {
        "__init__": emit_init,
        "declare_channel": emit_declare_channel,
        "target": emit_target,
        "target_index": emit_target,
        "align": emit_align,
        "measure": emit_measure,
        "add": emit_add,
        "phase_shift": emit_phase_shift,
        "phase_shift_index": emit_phase_shift,
        "set_magnetic_field": emit_magnetic_field,
        "config_slm_mask": emit_slm_mask,
    }

    for call in chain(seq._calls, seq._to_build_calls):
        if call.name in special_rules:
            special_rules[call.name](call)
        elif call.name in _GENERIC_RULES:
            emit_generic(_GENERIC_RULES[call.name], call)
        else:
            raise AbstractReprError(f"Unknown call '{call.name}'.")

    encoded = json.dumps(doc, cls=AbstractReprEncoder, **json_dumps_options)
    if not skip_validation:
        validate_abstract_repr(encoded, "sequence")
    return encoded
