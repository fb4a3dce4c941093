"""The concrete Channel subclasses.

Behavioral parity with reference
``pulser-core/pulser/channels/channels.py:26-66``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal, Optional

from pulser_tpu_torch.channels.base_channel import Channel
from pulser_tpu_torch.channels.eom import RydbergEOM


@dataclass(init=True, frozen=True)
class Microwave(Channel):
    """Microwave addressing channel.

    Drives the transition between two Rydberg states — the 'XY' basis.
    See base class.
    """

    @property
    def basis(self) -> Literal["XY"]:
        """The addressed basis name."""
        return "XY"

    def default_id(self) -> str:
        """Generates the default ID for indexing this channel in a Device."""
        return f"mw_{self.addressing.lower()}"


@dataclass(init=True, frozen=True)
class Raman(Channel):
    """Raman beam channel.

    Drives the transition between the hyperfine ground states — the
    'digital' basis. See base class.
    """

    @property
    def basis(self) -> Literal["digital"]:
        """The addressed basis name."""
        return "digital"


@dataclass(init=True, frozen=True)
class Rydberg(Channel):
    """Rydberg beam channel.

    Drives the transition between the ground and Rydberg states — the
    'ground-rydberg' basis. Optionally carries a ``RydbergEOM``. See base
    class.
    """

    eom_config: Optional[RydbergEOM] = None

    def __post_init__(self) -> None:
        super().__post_init__()
        if self.eom_config is not None and not isinstance(
            self.eom_config, RydbergEOM
        ):
            raise TypeError(
                "When defined, 'eom_config' must be a valid 'RydbergEOM'"
                f" instance, not {type(self.eom_config)}."
            )

    @property
    def basis(self) -> Literal["ground-rydberg"]:
        """The addressed basis name."""
        return "ground-rydberg"
