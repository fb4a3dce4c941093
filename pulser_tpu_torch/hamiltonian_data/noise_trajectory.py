"""Definition of a noise trajectory.

Parity with reference
``pulser-core/pulser/_hamiltonian_data/noise_trajectory.py:27``.
"""

from dataclasses import dataclass

import numpy as np

import pulser_tpu_torch.math as pm
from pulser_tpu_torch.register.base_register import BaseRegister, QubitId

ChannelName = str


@dataclass(frozen=True)
class NoiseTrajectory:
    """Defines a noise trajectory.

    Args:
        bad_atoms: Whether each atom is present or bad.
            False means it's present, True means it's bad.
        doppler_detune: Time-independent doppler detuning error per qubit.
        amp_fluctuations: Time-independent amplitude fluctuation per
            channel.
        det_fluctuations: Time-independent detuning fluctuation per
            non-DMM channel.
        det_phases: The random phase for each frequency component in the
            time-dependent detuning noise.
        register: The qubit register positions including noise.
        interaction_matrix: Packed interaction matrix for the two-body
            term in the Hamiltonian. Of shape (2,N,N) for XY (C3 then C6),
            (1,N,N) otherwise.
        dmm_det_fluctuation: Time-independent detuning fluctuations per
            DMM channel.
    """

    bad_atoms: dict[QubitId, bool]
    doppler_detune: dict[QubitId, float]
    amp_fluctuations: dict[ChannelName, float]
    det_fluctuations: dict[ChannelName, float]
    det_phases: dict[ChannelName, np.ndarray]
    register: BaseRegister
    interaction_matrix: pm.AbstractArray
    dmm_det_fluctuation: dict[ChannelName, float]
