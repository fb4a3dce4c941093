"""The Pulse class, the building block of a pulse sequence.

Behavioral parity with reference ``pulser-core/pulser/pulse.py:48-367``.
"""

from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, cast

import numpy as np

import pulser_tpu_torch
import pulser_tpu_torch.math as pm
from pulser_tpu_torch.json.abstract_repr.serializer import abstract_repr
from pulser_tpu_torch.json.utils import obj_to_dict
from pulser_tpu_torch.parametrized import ParamObj, Parametrized
from pulser_tpu_torch.parametrized.decorators import parametrize
from pulser_tpu_torch.waveforms import (
    ConstantWaveform,
    CustomWaveform,
    RampWaveform,
    Waveform,
)

if TYPE_CHECKING:
    from pulser_tpu_torch.channels.base_channel import Channel

__all__ = ["Pulse"]

PHASE_PRECISION = 1e-6
_TWO_PI = 2 * np.pi


def _phases_close(phase1: float, phase2: float) -> np.bool_:
    """Phase equality robust to the 0/2π wrapping point."""
    return np.isclose(phase1, phase2, atol=1e-6) or np.isclose(
        (phase1 + 1) % _TWO_PI,
        (phase2 + 1) % _TWO_PI,
        atol=PHASE_PRECISION,
    )


def _detuning_from_phase(phase: Waveform) -> Waveform:
    """The detuning waveform realizing a given phase waveform.

    Inverts φ(t) = φ_c - Σ_{k<=t} δ(k): δ is (minus) the discrete
    derivative of φ, in rad/µs, with the first sample doubled up so the
    output has the phase waveform's length.
    """
    if isinstance(phase, ConstantWaveform):
        return ConstantWaveform(phase.duration, 0.0)
    if isinstance(phase, RampWaveform):
        return ConstantWaveform(phase.duration, -phase._slope * 1e3)
    steps = -pm.diff(phase.samples) * 1e3  # rad/ns -> rad/µs
    return CustomWaveform(pm.pad(steps, (1, 0), mode="edge"))


@dataclass(init=False, repr=False, frozen=True)
class Pulse:
    r"""One pulse: paired amplitude/detuning waveforms plus a phase.

    The ``amplitude`` waveform carries the Rabi frequency
    :math:`\Omega` and the ``detuning`` waveform carries
    :math:`\delta`, both in rad/µs, over a shared duration.

    Args:
        amplitude: The Rabi-frequency waveform (rad/µs); never negative.
        detuning: The detuning waveform (rad/µs).
        phase: The pulse's constant phase offset (rad).
        post_phase_shift: A virtual-Z rotation (rad) applied to the
            targets right after the pulse ends.
    """

    amplitude: Waveform = field(init=False)
    detuning: Waveform = field(init=False)
    phase: pm.AbstractArray = field(init=False)
    post_phase_shift: float = field(default=0.0, init=False)

    def __new__(cls, *args: Any, **kwargs: Any) -> Pulse:
        """Returns a ParamObj if any argument is parametrized."""
        if any(
            isinstance(x, Parametrized)
            for x in itertools.chain(args, kwargs.values())
        ):
            return ParamObj(cls, *args, **kwargs)  # type: ignore
        return object.__new__(cls)

    def __init__(
        self,
        amplitude: Waveform | Parametrized,
        detuning: Waveform | Parametrized,
        phase: float | pm.TensorLike | Parametrized,
        post_phase_shift: float | Parametrized = 0.0,
    ):
        """Initializes a new Pulse."""
        if not (
            isinstance(amplitude, Waveform) and isinstance(detuning, Waveform)
        ):
            raise TypeError(
                "'amplitude' and 'detuning' have to be waveforms."
            )
        if detuning.duration != amplitude.duration:
            raise ValueError(
                "The duration of detuning and amplitude waveforms must match."
            )
        amp_samples = amplitude.samples
        if not amp_samples.requires_grad and np.any(
            amp_samples.as_array(detach=True) < 0
        ):
            raise ValueError(
                "All samples of an amplitude waveform must be "
                "greater than or equal to zero."
            )
        assert not isinstance(phase, Parametrized)
        wrapped_phase = pm.AbstractArray(phase, dtype=float)
        if wrapped_phase.size != 1:
            raise TypeError(
                f"'phase' must be a single float, not {phase!r}."
            )
        object.__setattr__(self, "amplitude", amplitude)
        object.__setattr__(self, "detuning", detuning)
        object.__setattr__(self, "phase", wrapped_phase % _TWO_PI)
        object.__setattr__(
            self,
            "post_phase_shift",
            float(cast(float, post_phase_shift)) % _TWO_PI,
        )

    @property
    def duration(self) -> int:
        """The duration of the pulse (in ns)."""
        return self.amplitude.duration

    @classmethod
    @parametrize
    def ConstantDetuning(
        cls,
        amplitude: Waveform | Parametrized,
        detuning: float | pm.TensorLike | Parametrized,
        phase: float | pm.TensorLike | Parametrized,
        post_phase_shift: float | Parametrized = 0.0,
    ) -> Pulse:
        """An amplitude waveform over one fixed detuning value."""
        flat_detuning = ConstantWaveform(
            cast(Waveform, amplitude).duration, detuning
        )
        return cls(amplitude, flat_detuning, phase, post_phase_shift)

    @classmethod
    @parametrize
    def ConstantAmplitude(
        cls,
        amplitude: float | pm.TensorLike | Parametrized,
        detuning: Waveform | Parametrized,
        phase: float | pm.TensorLike | Parametrized,
        post_phase_shift: float | Parametrized = 0.0,
    ) -> Pulse:
        """A detuning waveform under one fixed amplitude value."""
        flat_amplitude = ConstantWaveform(
            cast(Waveform, detuning).duration, amplitude
        )
        return cls(flat_amplitude, detuning, phase, post_phase_shift)

    @classmethod
    def ConstantPulse(
        cls,
        duration: int | Parametrized,
        amplitude: float | pm.TensorLike | Parametrized,
        detuning: float | pm.TensorLike | Parametrized,
        phase: float | pm.TensorLike | Parametrized,
        post_phase_shift: float | Parametrized = 0.0,
    ) -> Pulse:
        """Fixed amplitude and detuning values over a duration."""
        return cls(
            ConstantWaveform(duration, amplitude),
            ConstantWaveform(duration, detuning),
            phase,
            post_phase_shift,
        )

    @classmethod
    @parametrize
    def ArbitraryPhase(
        cls,
        amplitude: Waveform | Parametrized,
        phase: Waveform | Parametrized,
        post_phase_shift: float | Parametrized = 0.0,
    ) -> Pulse:
        r"""A pulse whose phase follows a waveform.

        Since the accumulated phase obeys

        .. math:: \phi(t) = \phi_c - \sum_{k=0}^{t} \delta(k)

        any phase trajectory can be realized by the right detuning
        waveform plus a constant offset :math:`\phi_c`; both are
        extracted here from the given phase waveform.

        Args:
            amplitude: The Rabi-frequency waveform (rad/µs).
            phase: The desired phase waveform (rad).
            post_phase_shift: A virtual-Z rotation (rad) applied after
                the pulse ends.
        """
        if not isinstance(phase, Waveform):
            raise TypeError(
                f"'phase' must be a waveform, not of type {type(phase)}."
            )
        detuning = _detuning_from_phase(phase)
        # Fold the first detuning sample into the constant offset.
        phase_c = phase[0] + detuning[0] * 1e-3
        return cls(amplitude, detuning, phase_c, post_phase_shift)

    def draw(self) -> None:
        """Plots amplitude and detuning on twin axes."""
        import matplotlib.pyplot as plt

        fig, amp_ax = plt.subplots()
        det_ax = amp_ax.twinx()
        self.amplitude._plot(amp_ax, r"$\Omega$ (rad/µs)", color="darkgreen")
        self.detuning._plot(det_ax, r"$\delta$ (rad/µs)", color="indigo")
        fig.tight_layout()
        plt.show()

    def fall_time(self, channel: Channel, in_eom_mode: bool = False) -> int:
        """How long the output keeps ringing past the pulse's end."""
        if in_eom_mode:
            rise = cast(
                pulser_tpu_torch.channels.eom.BaseEOM, channel.eom_config
            ).rise_time
        else:
            rise = channel.rise_time
        tail = max(
            self.amplitude.modulation_buffers(channel, eom=in_eom_mode)[1],
            self.detuning.modulation_buffers(channel, eom=in_eom_mode)[1],
        )
        return rise + tail

    def get_full_duration(
        self, channel: Channel, in_eom_mode: bool = False
    ) -> int:
        """Programmed duration plus the channel's modulation tail.

        Args:
            channel: The channel that would run the pulse.
            in_eom_mode: True when the pulse runs inside an EOM block.
        """
        from pulser_tpu_torch.channels.base_channel import Channel as _Channel

        if not isinstance(channel, _Channel):
            raise TypeError(
                "'channel' must be a channel object instance, not "
                f"{type(channel)}."
            )
        if in_eom_mode and not channel.supports_eom():
            raise ValueError(
                "The given channel does not support EOM mode operation."
            )
        return self.duration + self.fall_time(channel, in_eom_mode)

    def _to_dict(self) -> dict[str, Any]:
        return obj_to_dict(
            self,
            self.amplitude,
            self.detuning,
            self.phase,
            post_phase_shift=self.post_phase_shift,
        )

    def _to_abstract_repr(self) -> dict[str, Any]:
        return abstract_repr(
            "Pulse",
            self.amplitude,
            self.detuning,
            self.phase,
            post_phase_shift=self.post_phase_shift,
        )

    def __str__(self) -> str:
        return (
            f"Pulse(Amp={self.amplitude!s} rad/µs, "
            f"Detuning={self.detuning!s} rad/µs, "
            f"Phase={float(self.phase):.3g})"
        )

    def __repr__(self) -> str:
        return (
            f"Pulse(amp={self.amplitude!r} rad/µs, "
            f"detuning={self.detuning!r} rad/µs, "
            f"phase={float(self.phase):.3g}, "
            f"post_phase_shift={float(self.post_phase_shift):.3g})"
        )

    def __eq__(self, other: Any) -> bool:
        if type(other) is not type(self):
            return False
        return bool(
            self.amplitude == other.amplitude
            and self.detuning == other.detuning
            and _phases_close(float(self.phase), float(other.phase))
            and _phases_close(
                self.post_phase_shift, other.post_phase_shift
            )
        )

    def __hash__(self) -> int:
        return hash((self.amplitude, self.detuning, float(self.phase)))


# Replicate __init__'s signature in __new__
functools.update_wrapper(Pulse.__new__, Pulse.__init__)
