"""A minimal classproperty descriptor."""

from __future__ import annotations

from typing import Any, Callable, Generic, TypeVar

T = TypeVar("T")


class classproperty(Generic[T]):
    """Read-only property accessible on the class itself."""

    def __init__(self, fget: Callable[[Any], T]) -> None:
        self.fget = fget

    def __get__(self, obj: Any, owner: type | None = None) -> T:
        return self.fget(owner if owner is not None else type(obj))
