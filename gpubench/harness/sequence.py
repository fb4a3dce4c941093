"""Builds a configuration's ``Sequence`` with the program's own API.

The configuration's register and pulses are data: the atoms' positions,
and for each pulse its duration and two waveforms ``[kind, *args]``,
``kind`` a waveform class of the program (``gpubench/waveforms/<kind>.py``
gives the reference its samples). A value that the traffic draws
becomes a variable of a parametrized sequence (``declare_variable``), so
a job builds its sequence with ``build(**values)``, as a user's design
loop does.
"""

from __future__ import annotations

import math

TWO_PI = 2.0 * math.pi


def register(P, spec: dict):
    """The atoms ``q0, q1, ...`` at the configuration's positions (µm)."""
    return P.Register(
        {f"q{i}": (float(x), float(y)) for i, (x, y) in enumerate(spec["coords_um"])}
    )


def sequence(P, config: dict, variables=()):
    """The configuration's sequence; ``variables`` are declared and left
    free (the result is then parametrized)."""
    seq = P.Sequence(register(P, config["register"]), getattr(P, config["device"]))
    seq.declare_channel("ch", config["channel"])
    values = {
        name: (
            seq.declare_variable(name)
            if name in variables
            else TWO_PI * float(v)
        )
        for name, v in config["values_2pi"].items()
    }
    for name in variables:
        if name not in values:
            values[name] = seq.declare_variable(name)

    def value(v):
        return values[v] if isinstance(v, str) else float(v)

    def wave(spec, duration):
        return getattr(P, spec[0])(duration, *(value(v) for v in spec[1:]))

    for p in config["pulses"]:
        seq.add(
            P.Pulse(wave(p["amplitude"], p["duration"]),
                    wave(p["detuning"], p["duration"]), 0.0),
            "ch",
        )
    return seq


def noise_model(P, config: dict):
    """The configuration's ``NoiseModel`` (its ``noise``, the model's
    keyword arguments), or None."""
    spec = config.get("noise")
    return P.NoiseModel(**spec) if spec else None


def build_values(params: dict) -> dict:
    """A job's drawn values (2π rad/µs) in rad/µs, for ``build``."""
    return {k: TWO_PI * float(v) for k, v in params.items()}
