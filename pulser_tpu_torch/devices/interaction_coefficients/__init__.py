"""Interaction coefficients for Rydberg levels between 50 and 100.

Stored values and units (physical constants, identical to the reference
``pulser-core/pulser/devices/interaction_coefficients``):
- C_6/hbar: rad/µs x µm^6
- C_3/hbar: rad/µs x µm^3

The values were originally calculated using ARC and double checked with
PairInteraction.
"""

import json
from pathlib import PurePath

_HERE = PurePath(__file__).parent


def _load_coeffs(filename: str) -> dict[int, float]:
    with open(_HERE / filename, "r", encoding="utf-8") as f:
        raw = json.load(f)
    return {int(level): coeff for level, coeff in raw.items()}


c6_dict = _load_coeffs("C6_coeffs.json")
c3_dict = _load_coeffs("C3_coeffs.json")
