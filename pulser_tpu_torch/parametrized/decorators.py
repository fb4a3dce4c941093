"""Deferred-call decorator for parametrized arguments.

API parity with reference
``pulser-core/pulser/parametrized/decorators.py:28``.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, TypeVar, cast

from pulser_tpu_torch.parametrized.paramabc import Parametrized
from pulser_tpu_torch.parametrized.paramobj import ParamObj

F = TypeVar("F", bound=Callable)


def _has_parametrized(args: tuple, kwargs: dict) -> bool:
    """True when any positional or keyword argument is Parametrized."""
    scan = list(args)
    scan.extend(kwargs.values())
    return any(isinstance(item, Parametrized) for item in scan)


def parametrize(func: F) -> F:
    """Makes a function support parametrized arguments.

    When called with at least one :class:`Parametrized` argument, the
    decorated function returns a :class:`ParamObj` recording the call
    for later evaluation instead of executing immediately.

    Note:
        Designed for use in class methods. Usage in instance or static
        methods is not supported.
    """

    @functools.wraps(func)
    def deferred(*args: Any, **kwargs: Any) -> Any:
        if _has_parametrized(args, kwargs):
            return ParamObj(func, *args, **kwargs)
        return func(*args, **kwargs)

    return cast(F, deferred)
