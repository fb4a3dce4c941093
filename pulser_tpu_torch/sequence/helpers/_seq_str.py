"""The string representation of a sequence.

Behavioral parity with reference
``pulser-core/pulser/sequence/helpers/_seq_str.py``.
"""

from __future__ import annotations

import warnings
from typing import TYPE_CHECKING, Iterator

from pulser_tpu_torch.channels import DMM
from pulser_tpu_torch.pulse import Pulse

if TYPE_CHECKING:
    from pulser_tpu_torch.sequence.sequence import Sequence


def _sorted_targets(ts) -> tuple[list, str]:
    try:
        tgts = sorted(ts.targets)
    except TypeError:
        raise NotImplementedError(
            "Can't print sequence with qubit IDs of different types."
        )
    return tgts, ", ".join(map(str, tgts))


def _pulse_slot_text(sequence: Sequence, ch: str, sched, ts) -> str:
    """The line describing one pulse slot."""
    _, tgt_txt = _sorted_targets(ts)
    pulse = ts.type
    if isinstance(sequence.declared_channels[ch], DMM):
        if sched.is_detuned_delay(pulse):
            shown = "{:.3g} rad/µs".format(float(pulse.detuning[0]))
        else:
            shown = f"{pulse.detuning!s} rad/µs"
        return (
            f"t: {ts.ti}->{ts.tf} | Detuning: {shown}"
            f" | Targets: {tgt_txt}\n"
        )
    if sched.is_detuned_delay(pulse):
        return (
            f"t: {ts.ti}->{ts.tf} | Detuned Delay | Detuning: "
            "{:.3g} rad/µs\n".format(float(pulse.detuning[0]))
        )
    return f"t: {ts.ti}->{ts.tf} | {pulse} | Targets: {tgt_txt}\n"


def _channel_block(sequence: Sequence, ch: str, sched) -> Iterator[str]:
    """Yields the text pieces describing one channel's timeline."""
    if (
        sched.channel_obj.addressing == "Global"
        and sequence.is_register_mappable()
    ):
        warnings.warn(
            "Showing the register for a sequence with a mappable"
            f" register. Target qubits of channel {ch} will be defined"
            " in build.",
            UserWarning,
        )
    basis = sequence.declared_channels[ch].basis
    yield f"Channel: {ch}\n"
    seen_first_target = False
    for ts in sched:
        if ts.type == "delay":
            yield f"t: {ts.ti}->{ts.tf} | Delay \n"
        elif isinstance(ts.type, Pulse):
            yield _pulse_slot_text(sequence, ch, sched, ts)
        elif ts.type == "target":
            tgts, tgt_txt = _sorted_targets(ts)
            phase = float(
                sequence._basis_ref[basis][tgts[0]].phase[ts.tf]
            )
            if not seen_first_target:
                seen_first_target = True
                yield (
                    f"t: 0 | Initial targets: {tgt_txt} | "
                    f"Phase Reference: {phase} \n"
                )
            else:
                yield (
                    f"t: {ts.ti}->{ts.tf} | Target: {tgt_txt}"
                    f" | Phase Reference: {phase}\n"
                )
    yield "\n"


def seq_to_str(sequence: Sequence) -> str:
    """Generates the string representation of a sequence."""
    pieces: list[str] = []
    for ch, sched in sequence._schedule.items():
        pieces.extend(_channel_block(sequence, ch, sched))
    if hasattr(sequence, "_measurement"):
        pieces.append(f"Measured in basis: {sequence._measurement}")
    text = "".join(pieces)

    if sequence.is_parametrized():
        blocks = ["Stored calls\n------------"]
        for i, call in enumerate(sequence._to_build_calls, 1):
            shown_args = [str(a) for a in call.args]
            shown_args += [
                f"{key}={str(value)}" for key, value in call.kwargs.items()
            ]
            blocks.append(f"{i}. {call.name}({', '.join(shown_args)})")
        text = "Prelude\n-------\n" + text + "\n\n".join(blocks)

    return text
