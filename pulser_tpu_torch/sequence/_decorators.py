"""Custom decorators used by the Sequence class.

Behavioral parity with reference
``pulser-core/pulser/sequence/_decorators.py:31-158``.
"""

from __future__ import annotations

from collections.abc import Callable
from functools import wraps
from itertools import chain
from typing import TYPE_CHECKING, Any, TypeVar, cast

from pulser_tpu_torch.parametrized import Parametrized
from pulser_tpu_torch.sequence._call import _Call

if TYPE_CHECKING:
    from pulser_tpu_torch.sequence.sequence import Sequence

F = TypeVar("F", bound=Callable)

# Calls that, once made, make a later parametrized `truncate()` freeze
# the sequence (only measurement remains possible afterwards).
_TRUNCATE_BLOCKERS = (
    "target",
    "enable_eom_mode",
    "disable_eom_mode",
)


def _check_owned_variables(seq: Sequence, obj: Parametrized) -> None:
    """Rejects parametrized objects built from foreign variables."""
    for name, var in obj.variables.items():
        if name not in seq._variables:
            raise ValueError(f"Unknown variable '{name}'.")
        if seq._variables[name] is not var:
            raise ValueError(
                f"{obj} has variables that don't come from this "
                "Sequence. Use only what's returned by this"
                "Sequence's 'declare_variable' method as your"
                "variables."
            )


def verify_variable(seq: Sequence, x: Any) -> None:
    """Ensures every variable inside ``x`` was declared on ``seq``."""
    if isinstance(x, Parametrized):
        # From here on the sequence is parametrized
        seq._building = False
        _check_owned_variables(seq, x)
        return
    if isinstance(x, str):
        return
    # Containers may hide parametrized objects — walk them. Anything
    # that fails to iterate (including mid-loop, e.g. 0-d arrays
    # reached through a waveform's index protocol) is a leaf.
    try:
        for y in x:
            verify_variable(seq, y)
    except TypeError:
        return


def _frozen_by_truncate(seq: Sequence) -> bool:
    """Whether a parametrized truncate followed a blocker call."""
    deferred = [c.name for c in seq._to_build_calls]
    if "truncate" not in deferred:
        return False
    # Everything scheduled up to the (first) truncate, plus every
    # eagerly-executed call
    before_cut = [c.name for c in seq._calls]
    before_cut += deferred[: deferred.index("truncate")]
    return bool(set(_TRUNCATE_BLOCKERS) & set(before_cut))


def screen(func: F) -> F:
    """Blocks the call to a function if the Sequence is parametrized."""

    @wraps(func)
    def wrapper(self: Sequence, *args: Any, **kwargs: Any) -> Any:
        if self.is_parametrized():
            raise RuntimeError(
                f"Sequence.{func.__name__} can't be called in"
                " parametrized sequences."
            )
        return func(self, *args, **kwargs)

    return cast(F, wrapper)


def verify_parametrization(func: F) -> F:
    """Checks and updates the sequence status' consistency with the call.

    - Checks the sequence can still be modified.
    - Checks if all Parametrized inputs stem from declared variables.
    """

    @wraps(func)
    def wrapper(self: Sequence, *args: Any, **kwargs: Any) -> Any:
        for x in chain(args, kwargs.values()):
            verify_variable(self, x)
        func(self, *args, **kwargs)

    return cast(F, wrapper)


def store(func: F) -> F:
    """Checks and stores the call so it can be replayed when building."""

    @wraps(func)
    @verify_parametrization
    def wrapper(self: Sequence, *args: Any, **kwargs: Any) -> Any:
        storage = self._calls if self._building else self._to_build_calls
        func(self, *args, **kwargs)
        storage.append(_Call(func.__name__, args, kwargs))

    return cast(F, wrapper)


def mark_non_empty(func: F) -> F:
    """Marks the sequence as non-empty."""

    @wraps(func)
    def wrapper(self: Sequence, *args: Any, **kwargs: Any) -> Any:
        func(self, *args, **kwargs)
        self._empty_sequence = False

    return cast(F, wrapper)


def conditionally_block(
    if_measured: bool = True, if_parametrized_truncated: bool = True
) -> Callable[[F], F]:
    """Blocks the call if the sequence accepts no more instructions."""

    def decorator(func: F) -> F:
        @wraps(func)
        def wrapper(self: Sequence, *args: Any, **kwargs: Any) -> Any:
            if if_measured and self.is_measured():
                raise RuntimeError(
                    "The sequence has been measured, no further "
                    "changes are allowed."
                )
            if (
                if_parametrized_truncated
                and self.is_parametrized()
                and _frozen_by_truncate(self)
            ):
                raise RuntimeError(
                    "The sequence can only be measured. This is because"
                    f" it is parametrized and one or more of"
                    f" {_TRUNCATE_BLOCKERS} was called before a `truncate()`"
                    " call."
                )
            return func(self, *args, **kwargs)

        return cast(F, wrapper)

    return decorator
