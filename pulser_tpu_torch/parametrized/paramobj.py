"""Deferred calls (ParamObj) and operator support for parametrization.

API parity with reference
``pulser-core/pulser/parametrized/paramobj.py:71-437``: a ``ParamObj``
records a call whose arguments may contain ``Variable``s; ``build()``
evaluates the recorded DAG bottom-up. Assigning tensors that require
grad to the variables makes every build differentiable.
"""

from __future__ import annotations

import inspect
import operator
import warnings
from collections.abc import Callable
from itertools import chain
from typing import TYPE_CHECKING, Any, Union

import numpy as np

import pulser_tpu_torch.math as pm
import pulser_tpu_torch.parametrized
from pulser_tpu_torch.exceptions.serialization import AbstractReprError
from pulser_tpu_torch.json.abstract_repr.serializer import abstract_repr
from pulser_tpu_torch.json.abstract_repr.signatures import (
    BINARY_OPERATORS,
    SIGNATURES,
    UNARY_OPERATORS,
)
from pulser_tpu_torch.json.utils import obj_to_dict
from pulser_tpu_torch.parametrized.paramabc import Parametrized

if TYPE_CHECKING:
    from pulser_tpu_torch.parametrized import Variable


def _evaluated(x: Any) -> Any:
    """Builds ``x`` when it's parametrized, passes it through otherwise."""
    return x.build() if isinstance(x, Parametrized) else x


def _merged_variables(values: Any) -> dict[str, "Variable"]:
    """The union of the variables of every parametrized entry."""
    merged: dict[str, Variable] = {}
    for x in values:
        if isinstance(x, Parametrized):
            merged.update(x.variables)
    return merged

#: numpy ufunc name -> OpSupport method root (binary ufuncs use the
#: reflected method when the object sits on the right-hand side)
_UFUNC_MAP = {
    "add": "add",
    "subtract": "sub",
    "multiply": "mul",
    "divide": "truediv",
    "true_divide": "truediv",
    "floor_divide": "floordiv",
    "power": "pow",
    "float_power": "pow",
    "remainder": "mod",
    "mod": "mod",
    "fmod": "mod",
    "negative": "neg",
    "absolute": "abs",
    "fabs": "abs",
    "floor": "floor",
    "ceil": "ceil",
}

#: Binary dunder roots backed directly by the operator module
_BINARY_OPS = ("add", "sub", "mul", "truediv", "pow", "mod")

#: Math-method name -> pm function, each returning a deferred call
_MATH_METHODS = {
    "rint": ("round", "Rounds the value to the nearest int."),
    "sqrt": ("sqrt", "Calculates the square root of the object."),
    "exp": ("exp", "Calculates the exponential of the object."),
    "log2": ("log2", "Calculates the base-2 logarithm of the object."),
    "log": ("log", "Calculates the natural logarithm of the object."),
    "sin": ("sin", "Calculates the trigonometric sine of the object."),
    "cos": ("cos", "Calculates the trigonometric cosine of the object."),
    "tan": ("tan", "Calculates the trigonometric tangent of the object."),
    "tanh": ("tanh", "Calculates the hyperbolic tangent of the object."),
}


class OpSupport:
    """Arithmetic/ufunc support shared by all parametrized objects."""

    def __array_ufunc__(
        self, ufunc: np.ufunc, method: str, *inputs: Any, **kwargs: Any
    ) -> Any:
        if method != "__call__" or len(inputs) > 2:
            return NotImplemented

        ufunc_name = ufunc.__name__
        if ufunc_name in _UFUNC_MAP:
            root_name = _UFUNC_MAP[ufunc_name]
            if len(inputs) == 2 and inputs[1] is self:
                root_name = "r" + root_name
                inputs = inputs[::-1]
            method_name = f"__{root_name}__"
        else:
            method_name = ufunc_name

        if inputs[0] is self:
            try:
                return getattr(self, method_name)(*inputs[1:], **kwargs)
            except AttributeError:
                pass
        return NotImplemented

    def __neg__(self) -> ParamObj:
        return ParamObj(operator.neg, self)

    def __abs__(self) -> ParamObj:
        return ParamObj(operator.abs, self)

    def __ceil__(self) -> ParamObj:
        return ParamObj(pm.ceil, self)

    def __floor__(self) -> ParamObj:
        return ParamObj(pm.floor, self)

    def __round__(self, n: int = 0) -> ParamObj:
        return (self * 10**n).rint() / 10**n  # type: ignore

    def __floordiv__(self, other: Union[int, float], /) -> ParamObj:
        return (self / other).__floor__()

    def __rfloordiv__(self, other: Union[int, float], /) -> ParamObj:
        return (other / self).__floor__()


def _install_binary_op(root: str) -> None:
    op_fn = getattr(operator, root)

    def fwd(self: OpSupport, other: Any, /) -> ParamObj:
        return ParamObj(op_fn, self, other)

    def rev(self: OpSupport, other: Any, /) -> ParamObj:
        return ParamObj(op_fn, other, self)

    fwd.__name__ = f"__{root}__"
    rev.__name__ = f"__r{root}__"
    setattr(OpSupport, fwd.__name__, fwd)
    setattr(OpSupport, rev.__name__, rev)


def _install_math_method(name: str, pm_name: str, doc: str) -> None:
    pm_fn = getattr(pm, pm_name)

    def fn(self: OpSupport) -> ParamObj:
        return ParamObj(pm_fn, self)

    fn.__name__ = name
    fn.__doc__ = doc
    setattr(OpSupport, name, fn)


for _root in _BINARY_OPS:
    _install_binary_op(_root)
for _name, (_pm_name, _doc) in _MATH_METHODS.items():
    _install_math_method(_name, _pm_name, _doc)


class ParamObj(Parametrized, OpSupport):
    """A recorded call, evaluated lazily at build time.

    ``build()`` returns ``cls(*args, **kwargs)`` after recursively
    building every parametrized argument.

    Args:
        cls: The callable to invoke (usually a class).
        args: Positional arguments of the call.
        kwargs: Keyword arguments of the call.
    """

    def __init__(self, cls: Callable, *args: Any, **kwargs: Any) -> None:
        """Records the call and collects the involved variables."""
        self.cls = cls
        self.args = args
        self.kwargs = kwargs
        self._variables = _merged_variables(
            chain((cls,), args, kwargs.values())
        )
        self._instance = None
        self._vars_state: dict[str, int] = {}

    @property
    def variables(self) -> dict[str, Variable]:
        """Every variable this call (transitively) depends on."""
        return self._variables

    @property
    def _default_kwargs(self) -> dict[str, Any]:
        """Default values of the callable's keyword parameters."""
        defaults = {}
        for name, p in inspect.signature(self.cls).parameters.items():
            if p.default is not p.empty:
                defaults[name] = p.default
        return defaults

    def build(self) -> Any:
        """Evaluates the call with the variables' current values.

        The result is cached until any involved variable is reassigned.
        """
        state = {name: var._count for name, var in self._variables.items()}
        if state == self._vars_state:
            return self._instance
        self._vars_state = state
        target = _evaluated(self.cls)
        self._instance = target(
            *(_evaluated(a) for a in self.args),
            **{key: _evaluated(v) for key, v in self.kwargs.items()},
        )
        return self._instance

    def _is_classmethod_call(self) -> bool:
        """Whether this records ``SomeClass.some_classmethod(...)``."""
        return bool(
            self.args
            and hasattr(self.args[0], self.cls.__name__)
            and inspect.isfunction(self.cls)
            and self.cls.__module__ != "pulser_tpu_torch.math"
        )

    def _callable_ref(self, fn: Callable) -> dict[str, Any]:
        """Legacy-JSON pointer to a callable (not a built object)."""
        module = "numpy" if isinstance(fn, np.ufunc) else fn.__module__
        return obj_to_dict(
            self, _build=False, _name=fn.__name__, _module=module
        )

    def _to_dict(self) -> dict[str, Any]:
        if isinstance(self.cls, Parametrized):
            raise ValueError(
                "Serialization of calls to parametrized objects is not "
                "supported."
            )
        if not self._is_classmethod_call():
            return obj_to_dict(
                self, self._callable_ref(self.cls), *self.args, **self.kwargs
            )
        owner = self.args[0]
        if not inspect.isclass(owner):
            raise NotImplementedError(
                "Instance or static method serialization is not supported."
            )
        method_ref = obj_to_dict(
            self,
            _build=False,
            _name=self.cls.__name__,
            _module=owner.__module__,
            _submodule=owner.__name__,
        )
        return obj_to_dict(
            self,
            method_ref,
            self._callable_ref(owner),
            *self.args[1:],
            **self.kwargs,
        )

    # Pulse convenience constructors lower to a plain "Pulse" whose
    # constant leg becomes a zero-duration ConstantWaveform marker.
    _CONSTANT_LEG = {
        "Pulse.ConstantAmplitude": "amplitude",
        "Pulse.ConstantDetuning": "detuning",
    }

    def _classmethod_abstract_repr(self) -> dict[str, Any]:
        """Wire format of a recorded classmethod call."""
        owner = self.args[0]
        if not inspect.isclass(owner):
            raise NotImplementedError(
                "Instance or static method serialization is not supported."
            )
        name = f"{owner.__name__}.{self.cls.__name__}"
        lowers_to_pulse = name in self._CONSTANT_LEG or name == (
            "Pulse.ConstantPulse"
        )
        signature = SIGNATURES["Pulse" if lowers_to_pulse else name]
        assert (
            signature.var_pos is None
        ), "Unexpected signature with VAR_POSITIONAL arguments."
        all_args = {
            **self._default_kwargs,
            **dict(zip(signature.all_pos_args(), self.args[1:])),
            **self.kwargs,
        }
        leg = self._CONSTANT_LEG.get(name)
        if leg is not None:
            all_args[leg] = abstract_repr(
                "ConstantWaveform", 0, all_args[leg]
            )
            name = "Pulse"
        return abstract_repr(name, **all_args)

    def _signature_abstract_repr(self) -> dict[str, Any]:
        """Wire format of a call with a registered signature."""
        op_name = self.cls.__name__
        signature = SIGNATURES[op_name]
        filtered_defaults = {
            key: value
            for key, value in self._default_kwargs.items()
            if key in signature.keyword
        }
        full_kwargs = {**filtered_defaults, **self.kwargs}
        if signature.var_pos is not None:
            return abstract_repr(op_name, *self.args, **full_kwargs)

        all_args = {
            **full_kwargs,
            **dict(zip(signature.all_pos_args(), self.args)),
        }
        if op_name == "InterpolatedWaveform" and all_args["times"] is None:
            # The wire format always carries explicit times
            if isinstance(
                all_args["values"], pulser_tpu_torch.parametrized.Variable
            ):
                num_values = all_args["values"].size
            else:
                try:
                    num_values = len(all_args["values"])
                except TypeError:
                    raise AbstractReprError(
                        "An InterpolatedWaveform with 'values' of unknown "
                        "length and unspecified 'times' can't be "
                        "serialized to the abstract representation. To "
                        "keep the same argument for 'values', provide "
                        "compatible 'times' explicitly."
                    )
            all_args["times"] = np.linspace(0, 1, num=num_values)
        return abstract_repr(op_name, **all_args)

    def _to_abstract_repr(self) -> dict[str, Any]:
        if isinstance(self.cls, Parametrized):
            raise ValueError(
                "Serialization of calls to parametrized objects is not "
                "supported."
            )
        op_name = self.cls.__name__
        if self._is_classmethod_call():
            return self._classmethod_abstract_repr()
        if op_name in SIGNATURES:
            return self._signature_abstract_repr()
        if op_name in UNARY_OPERATORS:
            return dict(expression=op_name, lhs=self.args[0])
        if op_name in BINARY_OPERATORS:
            return dict(
                expression=op_name,
                lhs=self.args[0],
                rhs=self.args[1],
            )
        raise AbstractReprError(
            f"No abstract representation for '{op_name}'."
        )

    def __call__(self, *args: Any, **kwargs: Any) -> ParamObj:
        """Records a call on the (future) result of this ParamObj."""
        obj = ParamObj(self, *args, **kwargs)
        warnings.warn(
            "Calls to methods of parametrized objects are only "
            "executed if they serve as arguments of other "
            "parametrized objects that are themselves built. If this"
            f" is not the case, the call to {obj} will not be "
            "executed upon sequence building.",
            stacklevel=2,
        )
        return obj

    def __str__(self) -> str:
        shown_args = self.args
        if isinstance(self.cls, Parametrized):
            name = str(self.cls)
        elif (
            self.args
            and inspect.isclass(self.args[0])
            and inspect.isfunction(self.cls)
            and hasattr(self.args[0], self.cls.__name__)
        ):
            name = f"{self.args[0].__name__}.{self.cls.__name__}"
            shown_args = self.args[1:]
        else:
            name = self.cls.__name__
        parts = [str(a) for a in shown_args] + [
            f"{k}={v}" for k, v in self.kwargs.items()
        ]
        return f"{name}({', '.join(parts)})"

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, ParamObj):
            return False
        return self.args == other.args and self.kwargs == other.kwargs

    def __hash__(self) -> int:
        return id(self)
