"""Encodes a sequence-building call (for replay and serialization)."""

from collections import namedtuple

_Call = namedtuple("_Call", ["name", "args", "kwargs"])
