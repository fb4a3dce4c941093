"""Signatures of objects for the abstract representation.

Wire-format parity with reference
``pulser-core/pulser/json/abstract_repr/signatures.py:29-122`` — the
field names and extras define the public JSON schema and must match
exactly. Unlike the reference's literal table, the registry here is
parsed from a compact spec line per object:

    ``Name: pos args | *var_pos | kw= kwargs ! extra=value``
"""

from __future__ import annotations

import operator
from collections.abc import Callable
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Optional

import numpy as np

if TYPE_CHECKING:
    from pulser_tpu_torch.parametrized.variable import Variable, VariableItem


@dataclass
class PulserSignature:
    """The signature of a serializable object."""

    pos: tuple[str, ...] = field(default_factory=tuple)
    var_pos: Optional[str] = None
    keyword: tuple[str, ...] = field(default_factory=tuple)
    extra: dict[str, str] = field(default_factory=dict)

    def all_pos_args(self) -> tuple[str, ...]:
        """All potential positional arguments.

        Includes the keyword args if var_pos is None.
        """
        if self.var_pos is not None:
            return self.pos
        return (*self.pos, *self.keyword)


# One line per serializable object. Tokens: plain words are positional
# args, ``*name`` a variadic positional, ``name=`` a keyword arg, and
# everything after ``!`` is a ``key=value`` extra.
_SIGNATURE_SPEC = """
CompositeWaveform: *waveforms ! kind=composite
CustomWaveform: samples ! kind=custom
ConstantWaveform: duration value ! kind=constant
RampWaveform: duration start stop ! kind=ramp
BlackmanWaveform: duration area ! kind=blackman
BlackmanWaveform.from_max_val: max_val area ! kind=blackman_max
InterpolatedWaveform: duration values times= ! kind=interpolated
KaiserWaveform: duration area beta= ! kind=kaiser
KaiserWaveform.from_max_val: max_val area beta= ! kind=kaiser_max
Pulse: amplitude detuning phase post_phase_shift=
Pulse.ArbitraryPhase: amplitude phase post_phase_shift=
truediv: lhs rhs ! expression=div
round_: lhs ! expression=round
"""


def _parse_signature(spec: str) -> PulserSignature:
    args_part, _, extra_part = spec.partition("!")
    pos: list[str] = []
    keyword: list[str] = []
    var_pos = None
    for token in args_part.split():
        if token.startswith("*"):
            var_pos = token[1:]
        elif token.endswith("="):
            keyword.append(token[:-1])
        else:
            pos.append(token)
    extra = dict(
        kv.split("=", 1) for kv in extra_part.split()
    )
    return PulserSignature(
        pos=tuple(pos),
        var_pos=var_pos,
        keyword=tuple(keyword),
        extra=extra,
    )


SIGNATURES: dict[str, PulserSignature] = {
    name.strip(): _parse_signature(spec)
    for line in _SIGNATURE_SPEC.strip().splitlines()
    for name, _, spec in (line.partition(":"),)
}


def _index_var(lhs: Variable, rhs: int) -> VariableItem:
    return lhs[rhs]


# Deferred-expression operators, resolved by name at build time
BINARY_OPERATORS: dict[str, Callable] = {
    **{
        name: getattr(operator, name)
        for name in ("add", "sub", "mul", "truediv", "pow", "mod")
    },
    "index": _index_var,
}

UNARY_OPERATORS: dict[str, Callable] = {
    "neg": operator.neg,
    "abs": operator.abs,
    **{
        name: getattr(np, name)
        for name in (
            "ceil",
            "floor",
            "sqrt",
            "exp",
            "log2",
            "log",
            "sin",
            "cos",
            "tan",
            "tanh",
        )
    },
}
