"""Waveform primitives: the Waveform ABC and its seven built-ins.

Behavioral parity with reference ``pulser-core/pulser/waveforms.py``:
identical durations, per-nanosecond sample values, modulation buffers,
slicing and arithmetic for all seven waveform kinds. Samples are
generated host-side with numpy (once, at build time) but flow through
``pulser_tpu_torch.math`` so that tensor-valued parameters keep the
pipeline differentiable end to end.
"""

from __future__ import annotations

import functools
import inspect
import itertools
import sys
import warnings
from abc import ABC, abstractmethod
from functools import cached_property
from types import FunctionType
from typing import (
    TYPE_CHECKING,
    Any,
    Callable,
    Optional,
    Tuple,
    TypeVar,
    Union,
    cast,
)

import numpy as np
import scipy.interpolate as interpolate
import torch
from numpy.typing import ArrayLike

import pulser_tpu_torch.math as pm
from pulser_tpu_torch.exceptions.serialization import AbstractReprError
from pulser_tpu_torch.json.abstract_repr.serializer import abstract_repr
from pulser_tpu_torch.json.utils import obj_to_dict
from pulser_tpu_torch.parametrized import Parametrized, ParamObj
from pulser_tpu_torch.parametrized.decorators import parametrize

if TYPE_CHECKING:
    from matplotlib.axes import Axes

    from pulser_tpu_torch.channels.base_channel import Channel

__all__ = [
    "Waveform",
    "CompositeWaveform",
    "CustomWaveform",
    "ConstantWaveform",
    "RampWaveform",
    "BlackmanWaveform",
    "InterpolatedWaveform",
    "KaiserWaveform",
]

T = TypeVar("T", int, float)
_WaveformT = TypeVar("_WaveformT", bound="Waveform")
_InterpWaveformT = TypeVar("_InterpWaveformT", bound="InterpolatedWaveform")


def _is_traced(value: Any) -> bool:
    """True when a value is live: a tensor that requires grad."""
    if isinstance(value, pm.AbstractArray):
        value = value._array
    return isinstance(value, torch.Tensor) and value.requires_grad


def _cast_check(type_: type[T], value: Any, name: str) -> T:
    """Casts to a host scalar, passing live tensors through untouched."""
    if _is_traced(value):
        # The value is numeric by construction; defer the cast so the
        # computation stays differentiable
        return cast(T, value)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", category=UserWarning)
            return type_(value)
    except (ValueError, TypeError) as e:
        raise TypeError(
            f"'{name}' needs to be castable to {type_.__name__!s} "
            f"but type {type(value)} was provided."
        ) from e


class Waveform(ABC):
    """Base class of every pulse waveform."""

    def __new__(
        cls: type[_WaveformT], *args: Any, **kwargs: Any
    ) -> _WaveformT:
        """Defers construction to a ParamObj on parametrized inputs."""
        if any(
            isinstance(x, Parametrized)
            for x in itertools.chain(args, kwargs.values())
        ):
            return ParamObj(cls, *args, **kwargs)  # type: ignore
        return object.__new__(cls)

    def __init__(self, duration: Union[int, Parametrized]):
        """Stores a validated integer duration (ns).

        Args:
            duration: The waveform's duration (in ns).
        """
        assert not isinstance(duration, Parametrized)
        _duration = _cast_check(int, duration, "duration")
        if _duration <= 0:
            raise ValueError(
                "A waveform must have a positive duration, "
                + f"not {duration}."
            )
        if duration - _duration != 0:
            warnings.warn(
                f"A waveform duration of {duration} ns is below the"
                " supported precision of 1 ns. It was rounded down "
                + f"to {_duration} ns.",
                stacklevel=3,
            )
        self._duration = _duration

    # --- Core sample interface -------------------------------------

    @property
    @abstractmethod
    def duration(self) -> int:
        """The waveform duration (ns)."""

    @cached_property
    @abstractmethod
    def _samples(self) -> pm.AbstractArray:
        pass

    @property
    def samples(self) -> pm.AbstractArray:
        """One value per nanosecond describing the waveform."""
        return self._samples.copy()

    @property
    def first_value(self) -> float:
        """The waveform's initial sample."""
        return _cast_check(float, self[0], "first_value")

    @property
    def last_value(self) -> float:
        """The waveform's final sample."""
        return _cast_check(float, self[-1], "last_value")

    @property
    def integral(self) -> float:
        """The integral over time (in [units]·µs).

        Stays differentiable: the host-float cast is skipped for a
        tensor that requires grad, so ``torch.autograd`` flows through.
        """
        # 1 ns step × rad/µs values = 1e-3
        return _cast_check(float, pm.sum(self._samples) * 1e-3, "integral")

    # --- Duration manipulation --------------------------------------

    def with_new_duration(self, new_duration: int) -> Waveform:
        """A copy of this waveform stretched to a new duration."""
        raise NotImplementedError(
            f"{self.__class__.__name__} does not support"
            " modifications to its duration."
        )

    def change_duration(self, new_duration: int) -> Waveform:
        """Deprecated spelling of :meth:`with_new_duration`."""
        warnings.warn(
            "'Waveform.change_duration()' has been deprecated and replaced by"
            " 'Waveform.with_new_duration()'.",
            DeprecationWarning,
            stacklevel=2,
        )
        return self.with_new_duration(new_duration)

    def truncated(self, new_duration: int) -> Waveform:
        """This waveform cut short at ``new_duration``.

        Durations at or above the current one return an (independent)
        copy.
        """
        if new_duration >= self.duration:
            return self * 1.0
        cut = _cast_check(int, new_duration, "new_duration")
        return CustomWaveform(self.samples[:cut])

    # --- Output modulation -------------------------------------------

    def modulated_samples(
        self, channel: Channel, eom: bool = False
    ) -> pm.AbstractArray:
        """The samples as they leave a channel's modulator.

        The result is trimmed to the minimal buffer times.

        Args:
            channel: The modulating channel.
            eom: Use the channel's EOM bandwidth.
        """
        detach = True
        if self.samples.requires_grad:
            self._modulated_samples.cache_clear()
            detach = False
        start, end = self.modulation_buffers(channel)
        mod_samples = self._modulated_samples(channel, eom=eom)
        tr = channel.rise_time
        trimmed = mod_samples[tr - start: len(mod_samples) - tr + end]
        if detach:
            return pm.AbstractArray(trimmed.as_array(detach=True))
        return trimmed

    @functools.lru_cache()
    def modulation_buffers(
        self, channel: Channel, eom: bool = False
    ) -> tuple[int, int]:
        """The smallest leading/trailing buffers modulation requires.

        Args:
            channel: The modulating channel.
            eom: Use the channel's EOM bandwidth.

        Returns:
            (start, end) buffer durations in ns.
        """
        if not channel.mod_bandwidth:
            return 0, 0
        return channel.calc_modulation_buffer(
            self._samples,
            self._modulated_samples(channel, eom=eom),
            eom=eom,
        )

    @functools.lru_cache()
    def _modulated_samples(
        self, channel: Channel, eom: bool = False
    ) -> pm.AbstractArray:
        """Untrimmed modulated samples (cached per channel)."""
        return channel.modulate(self._samples, eom=eom)

    # --- Serialization hooks -----------------------------------------
    # Most waveforms serialize as their constructor values; each class
    # lists those in _serial_args and both wire formats derive from it.

    @abstractmethod
    def _serial_args(self) -> tuple[tuple, dict[str, Any]]:
        """(args, kwargs) reconstructing this waveform."""

    def _to_dict(self) -> dict[str, Any]:
        args, kwargs = self._serial_args()
        return obj_to_dict(self, *args, **kwargs)

    def _to_abstract_repr(self) -> dict[str, Any]:
        args, kwargs = self._serial_args()
        return abstract_repr(type(self).__name__, *args, **kwargs)

    # --- Indexing ------------------------------------------------------

    def __getitem__(
        self, index_or_slice: Union[int, slice]
    ) -> pm.AbstractArray:
        if isinstance(index_or_slice, slice):
            return self._samples[self._check_slice(index_or_slice)]
        return self._samples[self._check_index(index_or_slice)]

    def _check_index(self, i: int) -> int:
        if not (-self.duration <= i < self.duration):
            raise IndexError(
                "Index ('index_or_slice' = "
                f"{i}) must be in the range "
                f"0~{self.duration - 1}, or "
                f"{-self.duration}~-1 from the end."
            )
        return i if i >= 0 else self.duration + i

    def _check_slice(self, s: slice) -> slice:
        if s.step is not None and s.step != 1:
            raise IndexError("The step of the slice must be None or 1.")

        def resolve(bound: int | None, default: int) -> int:
            if bound is None:
                return default
            return bound if bound >= 0 else self.duration + bound

        start = min(max(resolve(s.start, 0), 0), self.duration)
        stop = min(max(resolve(s.stop, self.duration), 0), self.duration)
        return slice(start, max(stop, start))

    # --- Arithmetic -----------------------------------------------------

    @abstractmethod
    def __mul__(self, other: float | ArrayLike) -> Waveform:
        pass

    def __neg__(self) -> Waveform:
        return self.__mul__(-1.0)

    def __truediv__(self, other: float | ArrayLike) -> Waveform:
        other_ = pm.AbstractArray(other)
        if np.any(other_.as_array(detach=True) == 0):
            raise ZeroDivisionError("Can't divide a waveform by zero.")
        return self.__mul__(1 / other_)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Waveform):
            return False
        if self.duration != other.duration:
            return False
        return bool(
            np.all(
                np.isclose(
                    self.samples.as_array(detach=True),
                    other.samples.as_array(detach=True),
                )
            )
        )

    def __hash__(self) -> int:
        if self._samples.requires_grad:
            # Live samples belong to one autograd graph: hash by
            # identity.
            return object.__hash__(self)
        return hash(tuple(self.samples.tolist()))

    @abstractmethod
    def __str__(self) -> str:
        pass

    @abstractmethod
    def __repr__(self) -> str:
        pass

    # --- Plotting -------------------------------------------------------

    def draw(
        self,
        output_channel: Optional[Channel] = None,
        ylabel: str | None = None,
    ) -> None:
        """Plots the waveform (and optionally its modulated output).

        Args:
            output_channel: When given, the modulated output is drawn
                on top of the programmed input.
            ylabel: Optional y-axis label.
        """
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        if not output_channel:
            self._plot(ax, ylabel=ylabel)
        else:
            self._plot(
                ax,
                ylabel=ylabel,
                label="Input",
                start_t=self.modulation_buffers(output_channel)[0],
            )
            self._plot(ax, channel=output_channel, label="Output")
        plt.show()

    def _plot(
        self,
        ax: Axes,
        ylabel: Optional[str] = None,
        color: Optional[str] = None,
        channel: Optional[Channel] = None,
        label: str = "",
        start_t: int = 0,
    ) -> None:
        import matplotlib.pyplot as plt

        ax.set_xlabel("t (ns)")
        samples = (
            self.samples
            if channel is None
            else self.modulated_samples(channel)
        ).as_array(detach=True)
        ts = np.arange(len(samples)) + start_t
        if not channel and start_t:
            samples = np.pad(samples, 1)
            ts = np.pad(ts, 1, mode="edge")

        if color:
            color_kwargs: dict[str, Any] = {"color": color}
            hline_color = color
            ax.tick_params(axis="y", labelcolor=color)
        else:
            color_kwargs = {}
            hline_color = "black"

        if ylabel:
            ax.set_ylabel(ylabel, fontsize=14, **color_kwargs)
        ax.plot(ts, samples, label=label, **color_kwargs)
        ax.axhline(0, color=hline_color, linestyle=":", linewidth=0.5)
        if label:
            plt.legend()


class CompositeWaveform(Waveform):
    """The concatenation of two or more waveforms.

    Args:
        waveforms: Two or more waveforms to chain in order.
    """

    def __init__(self, *waveforms: Union[Parametrized, Waveform]):
        """Validates and stores the component waveforms."""
        if len(waveforms) < 2:
            raise ValueError(
                "Needs at least two waveforms to form a CompositeWaveform."
            )
        waveforms = cast(Tuple[Waveform, ...], waveforms)
        for wf in waveforms:
            if not isinstance(wf, Waveform):
                raise TypeError(
                    f"{wf!r} is not a valid waveform. "
                    "Please provide a valid Waveform."
                )
        self._waveforms = list(waveforms)

    @property
    def duration(self) -> int:
        """The summed duration of the components (ns)."""
        return sum(wf.duration for wf in self._waveforms)

    @cached_property
    def _samples(self) -> pm.AbstractArray:
        return pm.concatenate([wf.samples for wf in self._waveforms])

    @property
    def waveforms(self) -> list[Waveform]:
        """The component waveforms, in order."""
        return list(self._waveforms)

    def _serial_args(self) -> tuple[tuple, dict[str, Any]]:
        return tuple(self._waveforms), {}

    def __str__(self) -> str:
        pieces = ", ".join(repr(wf) for wf in self._waveforms)
        return f"Composite({pieces})"

    def __repr__(self) -> str:
        return f"CompositeWaveform({self.duration} ns, {self._waveforms!r})"

    def __mul__(self, other: float | ArrayLike) -> CompositeWaveform:
        k = pm.AbstractArray(other, dtype=float)
        return CompositeWaveform(*(wf * k for wf in self._waveforms))


class CustomWaveform(Waveform):
    """A waveform given directly by its samples.

    Args:
        samples: One modulation value per nanosecond; the sample count
            sets the duration.
    """

    def __init__(self, samples: ArrayLike | pm.TensorLike):
        """Stores the sample array."""
        samples_arr = pm.AbstractArray(samples, dtype=float)
        self._samples_arr: pm.AbstractArray = samples_arr
        super().__init__(len(samples_arr))

    @property
    def duration(self) -> int:
        """The waveform duration (ns)."""
        return int(self._duration)

    @cached_property
    def _samples(self) -> pm.AbstractArray:
        return self._samples_arr

    def _serial_args(self) -> tuple[tuple, dict[str, Any]]:
        return (self._samples,), {}

    def __str__(self) -> str:
        return "Custom"

    def __repr__(self) -> str:
        return f"CustomWaveform({self.duration} ns, {self.samples!r})"

    def __mul__(self, other: float | ArrayLike) -> CustomWaveform:
        return CustomWaveform(
            self._samples * pm.AbstractArray(other, dtype=float)
        )


class ConstantWaveform(Waveform):
    """A flat waveform.

    Args:
        duration: The waveform duration (in ns).
        value: The constant sample value.
    """

    def __init__(
        self,
        duration: Union[int, Parametrized],
        value: Union[float, pm.TensorLike, Parametrized],
    ):
        """Validates and stores the value."""
        super().__init__(duration)
        assert not isinstance(value, Parametrized)
        _cast_check(float, value, "value")
        self._value = pm.AbstractArray(value, dtype=float)

    @property
    def duration(self) -> int:
        """The waveform duration (ns)."""
        return self._duration

    @cached_property
    def _samples(self) -> pm.AbstractArray:
        return self._value * np.ones(self.duration)

    def with_new_duration(self, new_duration: int) -> ConstantWaveform:
        """The same value over a different duration."""
        return ConstantWaveform(new_duration, self._value)

    def truncated(self, new_duration: int) -> ConstantWaveform:
        """A shortened copy (still a ConstantWaveform)."""
        return self.with_new_duration(min(new_duration, self.duration))

    def _serial_args(self) -> tuple[tuple, dict[str, Any]]:
        return (self._duration, self._value), {}

    def __str__(self) -> str:
        return f"{float(self._value):.3g}"

    def __repr__(self) -> str:
        return (
            f"ConstantWaveform({self._duration} ns, "
            f"{float(self._value):.3g})"
        )

    def __mul__(self, other: float | ArrayLike) -> ConstantWaveform:
        return ConstantWaveform(
            self._duration,
            self._value * pm.AbstractArray(other, dtype=float),
        )


class RampWaveform(Waveform):
    """A linear ramp between two values.

    Args:
        duration: The waveform duration (in ns).
        start: The first sample's value.
        stop: The last sample's value.
    """

    def __init__(
        self,
        duration: Union[int, Parametrized],
        start: Union[float, pm.TensorLike, Parametrized],
        stop: Union[float, pm.TensorLike, Parametrized],
    ):
        """Validates and stores the endpoints."""
        super().__init__(duration)
        assert not isinstance(start, Parametrized)
        assert not isinstance(stop, Parametrized)
        _cast_check(float, start, "start")
        _cast_check(float, stop, "stop")
        self._start = pm.AbstractArray(start, dtype=float)
        self._stop = pm.AbstractArray(stop, dtype=float)

    @property
    def duration(self) -> int:
        """The waveform duration (ns)."""
        return self._duration

    @cached_property
    def _samples(self) -> pm.AbstractArray:
        ramp = (
            self._slope * np.arange(self._duration, dtype=float)
            + self._start
        )
        # Clamp fp noise to the endpoint range; live values clamp
        # with tensor bounds so gradients survive
        if _is_traced(self._start) or _is_traced(self._stop):
            lo = torch.minimum(
                self._start.as_tensor(), self._stop.as_tensor()
            )
            hi = torch.maximum(
                self._start.as_tensor(), self._stop.as_tensor()
            )
            return pm.clip(ramp, lo, hi)
        return pm.clip(
            ramp, *sorted(map(float, [self._start, self._stop]))
        )

    @property
    def _slope(self) -> pm.AbstractArray:
        return (self._stop - self._start) / (self._duration - 1)

    @property
    def slope(self) -> float:
        r"""The ramp's slope, in [units]/ns."""
        return float(self._slope)

    def with_new_duration(self, new_duration: int) -> RampWaveform:
        """The same endpoints over a different duration."""
        return RampWaveform(new_duration, self._start, self._stop)

    def _serial_args(self) -> tuple[tuple, dict[str, Any]]:
        return (self._duration, self._start, self._stop), {}

    def __str__(self) -> str:
        return f"Ramp({float(self._start):.3g}->{float(self._stop):.3g})"

    def __repr__(self) -> str:
        return (
            f"RampWaveform({self._duration} ns, "
            f"{float(self._start):.3g}->{float(self._stop):.3g})"
        )

    def __mul__(self, other: float | ArrayLike) -> RampWaveform:
        k = pm.AbstractArray(other, dtype=float)
        return RampWaveform(self._duration, self._start * k, self._stop * k)


def _matched_sign_or_raise(max_val: Any, area: Any) -> tuple[float, float]:
    """Validates the peak bound/area signs; returns host floats.

    Shared preamble of the ``from_max_val`` constructors: both
    quantities must carry the same sign, and neither may be
    parametrized at this point.
    """
    assert not isinstance(area, Parametrized)
    bound = cast(float, max_val)
    area_f = _cast_check(float, area, "area")
    if np.sign(bound) != np.sign(area_f):
        raise ValueError(
            "The maximum value and the area must have matching signs."
        )
    return bound, area_f


def _first_qualifying_duration(
    start: int,
    qualifies: Callable[[np.ndarray], np.ndarray],
    step: int = 1,
    chunk: int = 64,
) -> int:
    """Walks durations from ``start`` in ``step`` direction, chunked.

    Evaluates ``qualifies`` on whole candidate batches at once and
    returns the first duration for which it holds — a vectorized
    replacement for the reference's one-at-a-time marching loops.
    """
    lo = start
    while True:
        cands = lo + step * np.arange(chunk)
        if step < 0:
            cands = cands[cands >= 1]
            if cands.size == 0:
                raise RuntimeError("duration search exhausted")
        hits = np.flatnonzero(qualifies(cands))
        if hits.size:
            return int(cands[hits[0]])
        lo = int(cands[-1]) + step


class _WindowWaveform(Waveform):
    """Shared machinery of area-normalized window waveforms."""

    _area: pm.AbstractArray
    _norm_samples: pm.AbstractArray
    _scaling: pm.AbstractArray

    def _setup_window(
        self,
        area: Union[float, pm.TensorLike, Parametrized],
        window: np.ndarray,
    ) -> None:
        assert not isinstance(area, Parametrized)
        _cast_check(float, area, "area")
        self._area = pm.AbstractArray(area, dtype=float)
        self._norm_samples = pm.AbstractArray(
            np.clip(window, 0, np.inf)
        )
        # ns → µs conversion of the normalization
        self._scaling = self._area / pm.sum(self._norm_samples) * 1e3

    @property
    def duration(self) -> int:
        """The waveform duration (ns)."""
        return self._duration

    @cached_property
    def _samples(self) -> pm.AbstractArray:
        return self._norm_samples * self._scaling


class BlackmanWaveform(_WindowWaveform):
    """A Blackman window with a prescribed area.

    Warning:
        The area computation assumes rad/µs sample values; rescale
        'area' if the units differ.

    Args:
        duration: The waveform duration (in ns).
        area: The waveform integral. A negative area yields the
            sign-flipped positive waveform.
    """

    def __init__(
        self,
        duration: Union[int, Parametrized],
        area: Union[float, pm.TensorLike, Parametrized],
    ):
        """Builds the window for the given duration/area."""
        super().__init__(duration)
        self._setup_window(area, np.blackman(self._duration))

    @classmethod
    @parametrize
    def from_max_val(
        cls,
        max_val: Union[float, Parametrized],
        area: Union[float, pm.TensorLike, Parametrized],
    ) -> BlackmanWaveform:
        """The shortest Blackman window under a peak-value bound.

        Args:
            max_val: The peak bound (rad/µs); negative values bound
                from below and must match the sign of `area`.
            area: The waveform integral.
        """
        bound, area_f = _matched_sign_or_raise(max_val, area)
        sign = float(np.sign(area_f))
        # Work with positive quantities throughout
        area = pm.AbstractArray(area, dtype=float) * sign
        bound, area_f = sign * bound, sign * area_f

        def scaling_of(durs: np.ndarray) -> np.ndarray:
            # area / ∫window, the per-sample multiplier (ns → µs)
            sums = np.array(
                [np.sum(np.clip(np.blackman(int(d)), 0, None)) for d in durs]
            )
            return area_f * 1e3 / sums

        def true_peak(dur: int) -> float:
            win = np.clip(np.blackman(dur), 0, None)
            return float(np.max(win) * area_f * 1e3 / np.sum(win))

        # A unit Blackman window integrates to ~0.42 × duration; scan
        # candidate batches upward from there for the first duration
        # whose scaling respects the bound.
        start = int(np.ceil(area_f / (0.42 * bound) * 1e3))  # ns
        dur = _first_qualifying_duration(
            start, lambda ds: scaling_of(ds) <= bound
        )
        # np.blackman peaks at exactly 1.0 only for odd counts; the
        # even duration just below can approach the bound more closely
        if dur > start and dur % 2 == 1:
            if true_peak(dur) < true_peak(dur - 1) <= bound:
                dur -= 1

        wf = cls(dur, area)
        return wf if sign != -1.0 else cast(BlackmanWaveform, -wf)

    def with_new_duration(self, new_duration: int) -> BlackmanWaveform:
        """The same area spread over a different duration."""
        return BlackmanWaveform(new_duration, self._area)

    def _serial_args(self) -> tuple[tuple, dict[str, Any]]:
        return (self._duration, self._area), {}

    def __str__(self) -> str:
        return f"Blackman(Area: {float(self._area):.3g})"

    def __repr__(self) -> str:
        return (
            f"BlackmanWaveform({self._duration} ns, "
            f"Area: {float(self._area):.3g})"
        )

    def __mul__(self, other: float | ArrayLike) -> BlackmanWaveform:
        return BlackmanWaveform(
            self._duration,
            self._area * pm.AbstractArray(other, dtype=float),
        )


class InterpolatedWaveform(Waveform):
    """A waveform interpolated through a set of control points.

    Args:
        duration: The waveform duration (in ns).
        values: The control-point values (float-castable), or a
            parametrized object.
        times: Where each value sits on the time axis, as fractions of
            the duration in [0, 1]. Defaults to an even spread.
        interpolator: The SciPy interpolator: "PchipInterpolator"
            (default) or "interp1d" (deprecated).
        **interpolator_kwargs: Extra interpolator options (deprecated).
    """

    def __new__(
        cls: type[_InterpWaveformT], *args: Any, **kwargs: Any
    ) -> _InterpWaveformT:
        """Validates values/times, deferring to ParamObj when needed."""
        cls._check_values_times(
            args[1] if len(args) >= 2 else kwargs["values"],
            args[2] if len(args) >= 3 else kwargs.get("times", None),
        )
        if any(
            isinstance(x, Parametrized)
            for x in itertools.chain(args, kwargs.values())
        ):
            return ParamObj(cls, *args, **kwargs)  # type: ignore
        return object.__new__(cls)

    def __init__(
        self,
        duration: Union[int, Parametrized],
        values: Union[ArrayLike, Parametrized],
        times: Optional[Union[ArrayLike, Parametrized]] = None,
        interpolator: str = "PchipInterpolator",
        **interpolator_kwargs: Any,
    ):
        """Builds the interpolant over the control points."""
        super().__init__(duration)
        self._values = np.array(values, dtype=float)
        if times is None:
            self._times = np.linspace(0, 1, num=len(self._values))
        else:
            self._times = np.array(cast(ArrayLike, times), dtype=float)

        valid_interpolators = ("PchipInterpolator", "interp1d")
        if interpolator not in valid_interpolators:
            raise ValueError(
                f"Invalid interpolator '{interpolator}', only "
                "accepts: " + ", ".join(valid_interpolators)
            )
        if interpolator == "interp1d":
            warnings.warn(
                "Setting 'interpolator' to \"interp1d\" has been deprecated "
                "and will be removed in a future version. Only "
                "'PchipInterpolator' (the default) will remain supported.",
                DeprecationWarning,
                stacklevel=2,
            )
        if interpolator_kwargs:
            warnings.warn(
                "Passing extra keyword arguments to configure the SciPy "
                "interpolator has been deprecated and will be removed in a "
                "future version.",
                DeprecationWarning,
                stacklevel=2,
            )
        self._data_pts = np.array(
            list(
                zip(self._times * (self._duration - 1), self._values)
            )
        )
        interp_cls = getattr(interpolate, interpolator)
        self._interp_func = interp_cls(
            self._data_pts[:, 0],
            self._data_pts[:, 1],
            **interpolator_kwargs,
        )
        self._kwargs: dict[str, Any] = {
            "times": times,
            "interpolator": interpolator,
            **interpolator_kwargs,
        }

    @staticmethod
    def _check_values_times(
        values: Union[ArrayLike, Parametrized],
        times: Optional[Union[ArrayLike, Parametrized]] = None,
    ) -> None:
        """Early type/value validation of values and times."""

        def bad_type_msg(argument_name: str) -> str:
            return (
                f"`{argument_name}` must be a parametrized object or a "
                "sequence of elements castable to float. To make a sequence"
                " of parametrized objects, declare a variable with the "
                "desired size."
            )

        values_ = None
        if not isinstance(values, Parametrized):
            try:
                values_ = np.array(values, dtype=float)
            except TypeError as e:
                raise TypeError(bad_type_msg("values")) from e
        if times is None or isinstance(times, Parametrized):
            return
        try:
            times_ = np.array(times, dtype=float)
        except TypeError as e:
            raise TypeError(bad_type_msg("times")) from e
        if np.any(times_ < 0):
            raise ValueError(
                "All values in `times` must be greater than or equal to 0."
            )
        if np.any(times_ > 1):
            raise ValueError(
                "All values in `times` must be less than or equal to 1."
            )
        if len(times_) != len(np.unique(times)):
            raise ValueError(
                "`times` must be an array of non-repeating values."
            )
        if values_ is not None and times_.size != values_.size:
            raise ValueError(
                "When specified, the number of time coordinates in `times`"
                f" ({times_.size}) must match the number of `values` "
                f"({values_.size})."
            )

    @property
    def duration(self) -> int:
        """The waveform duration (ns)."""
        return self._duration

    @cached_property
    def _samples(self) -> pm.AbstractArray:
        samples = self._interp_func(np.arange(self._duration))
        default_config = self._kwargs[
            "interpolator"
        ] == "PchipInterpolator" and set(self._kwargs) == {
            "times",
            "interpolator",
        }
        if default_config:
            return pm.clip(
                samples, np.min(self._values), np.max(self._values)
            )
        # Legacy interpolators: round away sub-precision noise
        value_range = np.max(np.abs(samples))
        decimals = int(
            min(
                np.finfo(samples.dtype).precision
                - np.log10(value_range),
                9,
            )
        )
        return pm.AbstractArray(np.round(samples, decimals=decimals))

    @property
    def interp_function(
        self,
    ) -> Union[interpolate.PchipInterpolator, interpolate.interp1d]:
        """The underlying SciPy interpolant."""
        return self._interp_func

    @property
    def data_points(self) -> np.ndarray:
        """The (t[ns], value) control points."""
        return self._data_pts.copy()

    def with_new_duration(self, new_duration: int) -> InterpolatedWaveform:
        """The same control points over a different duration."""
        return InterpolatedWaveform(
            new_duration, self._values, **self._kwargs
        )

    def _plot(
        self,
        ax: Axes,
        ylabel: Optional[str] = None,
        color: Optional[str] = None,
        channel: Optional[Channel] = None,
        label: str = "",
        start_t: int = 0,
    ) -> None:
        super()._plot(
            ax,
            ylabel,
            color=color,
            channel=channel,
            label=label,
            start_t=start_t,
        )
        if not channel:
            ax.scatter(
                self._data_pts[:, 0] + start_t,
                self._data_pts[:, 1],
                c=color,
            )

    def _serial_args(self) -> tuple[tuple, dict[str, Any]]:
        return (self._duration, self._values), dict(self._kwargs)

    def _to_abstract_repr(self) -> dict[str, Any]:
        non_default = set(self._kwargs) - {"times", "interpolator"}
        if (
            self._kwargs["interpolator"] != "PchipInterpolator"
            or non_default
        ):
            raise AbstractReprError(
                "Export of an InterpolatedWaveform is only supported for the "
                "'PchipInterpolator' and without any 'interpolator_kwargs'."
            )
        return abstract_repr(
            "InterpolatedWaveform",
            self._duration,
            self._values,
            times=self._times,
        )

    def __str__(self) -> str:
        coords = [f"({int(x)}, {y:.4g})" for x, y in self.data_points]
        return f"InterpolatedWaveform(Points: {', '.join(coords)})"

    def __repr__(self) -> str:
        interp_str = f", Interpolator={self._kwargs['interpolator']})"
        return self.__str__()[:-1] + interp_str

    def __mul__(self, other: float | ArrayLike) -> InterpolatedWaveform:
        return InterpolatedWaveform(
            self._duration,
            self._values * np.array(other, dtype=float),
            **self._kwargs,
        )


class KaiserWaveform(_WindowWaveform):
    """A Kaiser window with a prescribed area and beta parameter.

    Warning:
        The area computation assumes rad/µs sample values; rescale
        'area' if the units differ.

    Args:
        duration: The waveform duration (in ns).
        area: The waveform integral; a negative area flips all signs.
        beta: The Kaiser beta parameter (default 14).
    """

    def __init__(
        self,
        duration: Union[int, Parametrized],
        area: Union[float, pm.TensorLike, Parametrized],
        beta: Optional[Union[float, Parametrized]] = 14.0,
    ):
        """Builds the window for the given duration/area/beta."""
        super().__init__(duration)
        beta = cast(float, beta)
        # beta can't require grad (it shapes the window itself)
        pm.AbstractArray(beta).as_array()
        self._beta = _cast_check(float, beta, "beta")
        if self._beta < 0.0:
            raise ValueError(
                f"The beta parameter (`beta` = {self._beta})"
                " must be greater than 0."
            )
        self._setup_window(
            area, np.kaiser(self._duration, self._beta)
        )

    @classmethod
    @parametrize
    def from_max_val(
        cls,
        max_val: Union[float, Parametrized],
        area: Union[float, pm.TensorLike, Parametrized],
        beta: Optional[Union[float, Parametrized]] = 14.0,
    ) -> KaiserWaveform:
        """The shortest Kaiser window under a peak-value bound.

        Args:
            max_val: The peak bound (rad/µs); must match the sign of
                `area`.
            area: The waveform integral.
            beta: The Kaiser beta parameter (default 14).
        """
        bound, area_f = _matched_sign_or_raise(max_val, area)
        beta_f = cast(float, beta)
        area = pm.AbstractArray(area, dtype=float)
        # Work with positive quantities throughout
        if area_f < 0:
            bound, area_f = -bound, -area_f

        def peaks_of(durs: np.ndarray) -> np.ndarray:
            # The realized maximum sample of each candidate window
            out = np.empty(len(durs))
            for i, d in enumerate(durs):
                win = np.kaiser(int(d), beta_f)
                out[i] = np.max(win) * 1000 * area_f / np.sum(win)
            return out

        # Seed from the long-window area-to-peak ratio
        ratio = bound * np.sum(np.kaiser(100, beta_f)) / 100
        guess = int(area_f * 1000.0 / ratio)

        if guess < 11:
            # Short windows see-saw; brute force the candidates and
            # keep the first duration whose peak lands highest while
            # still under the bound.
            cands = np.arange(1, 16)
            pk = peaks_of(cands)
            pk = np.where(pk <= bound, pk, -np.inf)
            best = 0 if not np.any(pk > 0.0) else int(cands[np.argmax(pk)])
        elif peaks_of(np.array([guess]))[0] >= bound:
            # Over the bound at the seed: first longer duration at or
            # under it
            best = _first_qualifying_duration(
                guess, lambda ds: peaks_of(ds) <= bound
            )
        else:
            # Under the bound: shrink until crossing, keep the last
            # duration still under
            best = (
                _first_qualifying_duration(
                    guess, lambda ds: peaks_of(ds) >= bound, step=-1
                )
                + 1
            )

        return cls(best, area, beta_f)

    def with_new_duration(self, new_duration: int) -> KaiserWaveform:
        """The same area/beta over a different duration."""
        return KaiserWaveform(new_duration, self._area, self._beta)

    def _serial_args(self) -> tuple[tuple, dict[str, Any]]:
        return (self._duration, self._area), {"beta": self._beta}

    def __str__(self) -> str:
        return (
            f"Kaiser({self._duration} ns, "
            f"Area: {float(self._area):.3g}, Beta: {self._beta:.3g})"
        )

    def __repr__(self) -> str:
        return (
            f"KaiserWaveform(duration: {self._duration}, "
            f"area: {float(self._area):.3g}, beta: {self._beta:.3g})"
        )

    def __mul__(self, other: float | ArrayLike) -> KaiserWaveform:
        return KaiserWaveform(
            self._duration,
            self._area * pm.AbstractArray(other, dtype=float),
            self._beta,
        )


def _copy_func(f: FunctionType) -> FunctionType:
    return FunctionType(
        f.__code__,
        f.__globals__,
        name=f.__name__,
        argdefs=f.__defaults__,
        closure=f.__closure__,
    )


# Give every subclass's __new__ the signature of its __init__, so
# introspection (and the parametrized machinery) sees real parameters
for _, _cls in inspect.getmembers(sys.modules[__name__], inspect.isclass):
    if _cls.__module__ == __name__:
        _new = _copy_func(_cls.__new__)  # type: ignore
        _cls.__new__ = functools.update_wrapper(_new, _cls.__init__)
