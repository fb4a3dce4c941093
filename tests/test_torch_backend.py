"""TorchBackendV2 and TorchBackend against TpuBackendV2 and TpuBackend.

Every scenario of ``tests/test_backend_v2.py`` (18) and
``tests/test_tpu_backend_v1.py`` (4), and ``run_from_sequence_samples``,
runs through both packages on the same inputs and the same numpy seed
(:func:`torch_parity.assert_parity`), the port on the CPU in complex128
(torch's default dtype at float64; the test configuration runs JAX in
x64), the JAX package on one device: the same result tags and times,
equal seeded ``BitStrings``, ``Occupation``, ``CorrelationMatrix``,
``Energy``, ``EnergyVariance`` and aggregated states within 1e-6, the
same errors, warnings and printed progress.

Sizes: the JAX scenarios that take minutes on a CPU run shorter here
(``output_state_normalization`` on 4 atoms for 1 µs instead of 7 atoms
for 4 µs; ``stochastic_noise`` with 6 trajectories and 101 times
instead of 30 and 1001). Register noise is not ported: the two
scenarios that use it check that the port refuses it, and
``run_twice`` draws detuning and Doppler noise instead.

The emulator methods this slice brought back (``config``,
``set_config``, ``add_config``, ``show_config``, ``reset_config``,
``get_hamiltonian``, ``build_operator``) run through both packages too,
to 1e-12. The scenarios are all defined here; the coherent ones run here, the
noisy ones in ``tests/test_torch_backend_noisy.py``, the deprecated
backend's and the emulator methods in ``tests/test_torch_backend_v1.py``,
so that the three files share the time. Two properties of the port's design are pinned besides:
a coherent run's observables read the solver's states on the device
(nothing fetches the state batch), and no observable builds the
Hamiltonian's matrix.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import math
from unittest.mock import patch

import numpy as np
import pytest
import torch

from torch_parity import TORCH, assert_parity

from pulser_tpu_torch.emulator import TorchBackendV2, TorchConfig
from pulser_tpu_torch.emulator.hamiltonian import Hamiltonian
from pulser_tpu_torch.ops.solver import DeviceStateBatch

torch.set_num_threads(1)

TOL = 1e-6


@pytest.fixture(autouse=True)
def _one_jax_device(monkeypatch):
    """The JAX package on one device (no trajectory sharding), as the
    port runs."""
    monkeypatch.setenv("PULSER_TPU_DISABLE_SHARDING", "1")


def _seq(ns):
    P = ns.pkg
    reg = P.Register.square(2, spacing=7.0, prefix="q")
    seq = P.Sequence(reg, P.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(P.Pulse.ConstantPulse(300, np.pi, 0.0, 0.0), "ryd")
    return seq


def sweep_sequence(ns, device=None):
    """The reference suite's two-atom adiabatic sweep."""
    P = ns.pkg
    omega_max = 4 * 2 * math.pi
    u = omega_max / 2
    delta_0, delta_f = -6 * u, 2 * u
    t_rise, t_fall = 500, 1000
    t_sweep = int((delta_f - delta_0) / (2 * np.pi * 10) * 1000)
    r_interatomic = P.MockDevice.rydberg_blockade_radius(u)
    reg = P.Register.rectangle(1, 2, r_interatomic, prefix="q")
    rise = P.Pulse.ConstantDetuning(
        P.RampWaveform(t_rise, 0.0, omega_max), delta_0, 0.0
    )
    sweep = P.Pulse.ConstantAmplitude(
        omega_max, P.RampWaveform(t_sweep, delta_0, delta_f), 0.0
    )
    fall = P.Pulse.ConstantDetuning(
        P.RampWaveform(t_fall, omega_max, 0.0), delta_f, 0.0
    )
    seq = P.Sequence(reg, device if device is not None else P.MockDevice)
    seq.declare_channel("ising_global", "rydberg_global")
    seq.add(rise, "ising_global")
    seq.add(sweep, "ising_global")
    seq.add(fall, "ising_global")
    return seq


def _config(ns, **kw):
    return ns.Config(**kw, **ns.kw)


def _printed(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        value = fn()
    return value, buf.getvalue()


def _counter(ns):
    class CountCalls(ns.backend.Callback):
        def __init__(self) -> None:
            super().__init__()
            self.counter = 0

        def __call__(self, **kwargs) -> None:
            self.counter += 1

    return CountCalls()


# -- tests/test_backend_v2.py ------------------------------------------


def observable_pipeline(ns):
    O = ns.obs
    ggg = ns.State.from_state_amplitudes(
        eigenstates=("r", "g"), amplitudes={"gggg": 1.0}
    )
    config = _config(
        ns,
        observables=[
            O.BitStrings(evaluation_times=[1.0], num_shots=500),
            O.Occupation(evaluation_times=[0.5, 1.0]),
            O.CorrelationMatrix(evaluation_times=[1.0]),
            O.Energy(evaluation_times=[1.0]),
            O.EnergyVariance(evaluation_times=[1.0]),
            O.EnergySecondMoment(evaluation_times=[1.0]),
            O.Fidelity(ggg, evaluation_times=[1.0]),
            O.StateResult(evaluation_times=[1.0]),
        ],
    )
    results = ns.BackendV2(_seq(ns), config=config).run()
    state = results.state[-1]
    return results, state.overlap(state), type(state).__name__


def default_config(ns):
    config = ns.BackendV2.default_config.with_changes(**ns.kw)
    return ns.BackendV2(_seq(ns), config=config).run()


def tpu_state_api(ns):
    st = ns.State.from_state_amplitudes(
        eigenstates=("r", "g"),
        amplitudes={"gg": 1 / np.sqrt(2), "rr": 1 / np.sqrt(2)},
    )
    other = ns.State.from_state_amplitudes(
        eigenstates=("r", "g"), amplitudes={"gg": 1.0}
    )
    return [
        st.n_qudits,
        st.bitstring_probabilities(),
        st.sample(num_shots=200),
        st.overlap(other),
    ]


def tpu_operator_api(ns):
    op = ns.Operator.from_operator_repr(
        eigenstates=("r", "g"),
        n_qudits=2,
        operations=[(1.0, [({"rr": 1.0}, [0])])],
    )
    st = ns.State.from_state_amplitudes(
        eigenstates=("r", "g"), amplitudes={"rg": 1.0}
    )
    return st.overlap(op.apply_to(st))


def callback(ns):
    seq = sweep_sequence(ns)
    backend = ns.BackendV2(seq, config=_config(ns, callbacks=[_counter(ns)]))
    backend.run()
    noisy = ns.BackendV2(
        seq,
        config=_config(
            ns,
            callbacks=[_counter(ns)],
            noise_model=ns.pkg.NoiseModel(amp_sigma=0.1),
            n_trajectories=1,
        ),
    )
    noisy.run()
    return [
        seq.get_duration() + 1,
        backend._config.callbacks[0].counter,
        noisy._config.callbacks[0].counter,
    ]


def energy(ns):
    seq = sweep_sequence(ns)
    O = ns.obs
    config = _config(
        ns,
        default_evaluation_times="Full",
        observables=[
            O.StateResult(),
            O.Energy(evaluation_times=[0.001 * n for n in range(1001)]),
        ],
        print_progress=True,
    )
    backend = ns.BackendV2(seq, config=config)
    results, printed = _printed(backend.run)
    mid_state = results.state[len(results.state) // 2].to_qobj()
    h_mid = backend._sim_obj.get_hamiltonian(seq.get_duration() // 2)
    h_end = backend._sim_obj.get_hamiltonian(seq.get_duration())
    return [
        printed,
        results.get_result_times("state") != results.get_result_times("energy"),
        results.energy,
        results.get_result("energy", 0.5),
        np.real(h_mid.expect(mid_state)),
        np.real(h_end.expect(results.state[-1].to_qobj())),
    ]


def energy_wrong_config(ns):
    return ns.BackendV2(sweep_sequence(ns), config="tralala")


def default_noise_model(print_progress):
    def case(ns):
        P = ns.pkg
        noisy_device = dataclasses.replace(
            P.MockDevice,
            noise_model=P.NoiseModel(dephasing_rate=0.01, temperature=50),
        )
        config = _config(
            ns,
            observables=[ns.obs.StateResult(evaluation_times=[1.0])],
            noise_model=P.NoiseModel(p_false_neg=0.1),
            prefer_device_noise_model=True,
            initial_state=ns.State(
                ns.tensor([ns.basis(2, 0) for _ in range(2)]),
                eigenstates=("r", "g"),
            ),
            n_trajectories=2,
            print_progress=print_progress,
        )
        backend = ns.BackendV2(sweep_sequence(ns, noisy_device), config=config)
        used = backend._sim_obj._hamiltonian_data.noise_model
        results, printed = _printed(backend.run)
        return [
            used.p_false_neg,
            used.temperature,
            used.dephasing_rate,
            backend._config.noise_model.p_false_neg,
            printed,
            results,
        ]

    return case


def stochastic_noise(ns):
    P = ns.pkg

    def noise(samples_per_run):
        return P.NoiseModel(
            temperature=50.0,
            p_false_neg=0.01,
            amp_sigma=1e-3,
            samples_per_run=samples_per_run,
        )

    config = _config(
        ns,
        default_evaluation_times=(1.0,),
        observables=[
            ns.obs.StateResult(evaluation_times=[1.0]),
            ns.obs.Occupation(evaluation_times=[0.01 * n for n in range(101)]),
        ],
        noise_model=noise(1),
        n_trajectories=6,
    )
    seq = sweep_sequence(ns)
    np.random.seed(123)
    backend = ns.BackendV2(seq, config=config)
    results = backend.run()
    np.random.seed(123)
    emulator = ns.Emulator.from_sequence(
        seq, noise_model=noise(100), n_trajectories=6, **ns.kw
    )
    old = emulator.run()
    times = results.get_result_times("occupation")
    indices = np.searchsorted(
        old._sim_times,
        np.array([int(t * seq.get_duration()) * 1e-3 for t in times]),
    )
    occ_old = np.asarray(
        old.expect([ns.tensor([ns.basis(2, 0).proj(), ns.qeye(2)])])[0]
    )[indices]
    occ = np.array([x[0] for x in results.occupation])
    return [
        backend._sim_obj.n_trajectories,
        results,
        occ_old,
        np.max(np.abs(occ - occ_old)) < 0.06,
    ]


def eval_times_rounding(ns):
    P = ns.pkg
    lengths = []
    for duration in range(400, 600, 20):
        reg = P.Register({"q0": (-5, 0), "q1": (5, 0)})
        seq = P.Sequence(reg, P.AnalogDevice)
        seq.declare_channel("rydberg_global", "rydberg_global")
        seq.add(
            P.Pulse(
                P.ConstantWaveform(duration, np.pi),
                P.ConstantWaveform(duration, 0.0),
                0,
            ),
            "rydberg_global",
        )
        obs = [ns.obs.StateResult(evaluation_times=np.linspace(0, 1, 100).tolist())]
        config = ns.backend.EmulationConfig(observables=obs, **ns.kw)
        lengths.append(len(ns.BackendV2(seq, config=config).run().state))
    return lengths


def leakage(amp_sigma):
    def case(ns):
        P = ns.pkg
        reg = P.Register.rectangle(1, 2, spacing=1000.0, prefix="q")
        seq = P.Sequence(reg, P.MockDevice)
        seq.declare_channel("ch0", "rydberg_global")
        seq.add(P.Pulse.ConstantPulse(500, np.pi, 0.0, 0.0), "ch0")
        basisx = np.array([0.0, 0.0, 1.0]).reshape(3, 1)
        basisg = np.array([0.0, 1.0, 0.0]).reshape(3, 1)
        basisr = np.array([1.0, 0.0, 0.0]).reshape(3, 1)
        noise_model = P.NoiseModel(
            eff_noise_rates=[0.5, 0.5],
            eff_noise_opers=[basisx @ basisr.T, basisx @ basisg.T],
            with_leakage=True,
            amp_sigma=amp_sigma,
        )
        config = _config(
            ns,
            default_evaluation_times=[1.0],
            observables=[ns.obs.StateResult(evaluation_times=[1.0])],
            noise_model=noise_model,
            solver=ns.Solver.MESOLVER,
            n_trajectories=1,
        )
        result = ns.BackendV2(seq, config=config).run()
        eig = ("r", "g", "x")
        xx = ns.Qobj(basisx @ basisx.T)
        p_no = np.zeros((3, 3))
        p_no[0, 0] = p_no[1, 1] = 1.0
        no = ns.Qobj(p_no)
        both = ns.Operator(ns.tensor([xx, xx]), eig)
        one = ns.Operator(ns.tensor([xx, no]), eig) + ns.Operator(
            ns.tensor([no, xx]), eig
        )
        none = ns.Operator(ns.tensor([no, no]), eig)
        p_leak = 1 - math.exp(-0.5 * 500 / 1000)
        final = result.final_state
        values = [one.expect(final), none.expect(final), both.expect(final)]
        expected = [2 * p_leak * (1 - p_leak), (1 - p_leak) ** 2, p_leak**2]
        return [values, np.allclose(values, expected, rtol=1e-6)]

    return case


def _register_noise_config(ns):
    return _config(
        ns,
        default_evaluation_times=[1.0],
        observables=[ns.obs.StateResult(evaluation_times=[1.0])],
        noise_model=ns.pkg.NoiseModel(
            trap_depth=1.0,
            trap_waist=1.0,
            temperature=50.0,
            disable_doppler=True,
            detuning_sigma=5.0,
        ),
        n_trajectories=10,
    )


def register_detuning_detection(ns):
    P = ns.pkg
    reg = P.Register.rectangle(1, 2, spacing=1000.0, prefix="q")
    seq = P.Sequence(reg, P.MockDevice)
    seq.declare_channel("ch0", "rydberg_global")
    seq.add(P.Pulse.ConstantPulse(500, np.pi, 0.0, 0.0), "ch0")
    result = ns.BackendV2(seq, config=_register_noise_config(ns)).run()
    return tuple(result.final_state.to_qobj().shape)


def config_type(ns):
    return ns.BackendV2.config_type is ns.Config


def aggregation(ns):
    P = ns.pkg
    reg = P.Register({"q0": [-1e5, 0], "q1": [1e5, 0], "q2": [0, 1e5]})
    seq = P.Sequence(reg, P.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(
        P.Pulse.ConstantDetuning(P.BlackmanWaveform(100, np.pi), 0.0, 0.0),
        "ryd",
    )
    O = ns.obs
    occup = O.Occupation(evaluation_times=[1.0])
    state = O.StateResult(evaluation_times=[1.0])
    bitstrings = O.BitStrings(evaluation_times=[1.0])
    variance = O.EnergyVariance(evaluation_times=[1.0])
    config = _config(
        ns,
        observables=(occup, state, bitstrings, variance),
        n_trajectories=5,
        noise_model=P.NoiseModel(state_prep_error=1 / 3),
    )
    with patch(
        f"{P.__name__}.hamiltonian_data.hamiltonian_data.np.random.uniform"
    ) as bad_atoms_mock:
        bad_atoms_mock.side_effect = [
            np.array([0.1, 0.5, 0.6]),
            np.array([0.1, 0.5, 0.6]),
            np.array([0.5, 0.1, 0.6]),
            np.array([0.5, 0.1, 0.6]),
            np.array([0.5, 0.6, 0.1]),
        ] + [np.array([0.1, 0.2, 0.3])] * 3
        results = ns.BackendV2(seq, config=config).run()
    expected_state = np.zeros((8, 8))
    expected_state[1, 1] = 0.2
    expected_state[2, 2] = 0.4
    expected_state[4, 4] = 0.4
    return [
        results,
        np.allclose(
            results.final_state.to_qobj().full(), expected_state, atol=1e-4
        ),
        np.allclose(results.occupation[-1], [0.6, 0.6, 0.8], atol=1e-4),
        results.final_bitstrings == {"011": 2000, "101": 2000, "110": 1000},
        [results.get_result_times(o) for o in (occup, state, bitstrings)],
    ]


def rounding_error_eval_time_duplication(ns):
    P = ns.pkg
    seq = P.Sequence(P.Register.square(1, prefix="q"), P.AnalogDevice)
    seq.declare_channel("rydberg_global", "rydberg_global")
    seq.add(P.Pulse.ConstantPulse(1000, 1, 0, 0), "rydberg_global")
    config = _config(
        ns,
        observables=[
            ns.obs.BitStrings(evaluation_times=np.linspace(0.0, 1.0, 1001)),
            ns.obs.BitStrings(
                evaluation_times=[0.49299999999999994], tag_suffix="mod"
            ),
        ],
    )
    return ns.BackendV2(seq, config=config).run()


def output_state_normalization(amp_sigma):
    def case(ns):
        P = ns.pkg
        factor = 1.2357175818662465 if not amp_sigma else 1.0
        register = P.Register.square(2, 5, prefix="q")
        seq = P.Sequence(register, P.MockDevice)
        seq.declare_channel("rydberg_global", "rydberg_global")
        u = P.AnalogDevice.interaction_coeff / 5**6
        interp_pts = np.linspace(0, 1, 4)
        seq.add(
            P.Pulse(
                P.InterpolatedWaveform(
                    1000,
                    u * np.array([1e-9, 0.22, 0.2181, 1e-9]) * factor,
                    times=interp_pts,
                ),
                P.InterpolatedWaveform(
                    1000, u * np.array([-1, 0.0556, 0.332, 1]), times=interp_pts
                ),
                0,
            ),
            "rydberg_global",
        )
        noise_model = P.NoiseModel(amp_sigma=amp_sigma)
        default = ns.BackendV2.default_config.with_changes(**ns.kw)
        np.random.seed(1234)
        config = default.with_changes(noise_model=noise_model)
        final_state = ns.BackendV2(seq, config=config).run().final_state
        norm = np.linalg.norm(final_state.to_qobj().full())
        np.random.seed(1234)
        config = default.with_changes(
            noise_model=noise_model, observables=[ns.obs.Fidelity(final_state)]
        )
        fidelity = ns.BackendV2(seq, config=config).run().fidelity[-1]
        return [final_state, norm < 1 + 1e-8, fidelity, fidelity < 1 + 1e-8]

    return case


def run_twice(ns):
    config = _register_noise_config(ns)
    backend = ns.BackendV2(sweep_sequence(ns), config=config)
    s1 = backend.run().final_state.to_qobj().full()
    s2 = backend.run().final_state.to_qobj().full()
    overlap = np.trace(s1 @ s2) / (np.linalg.norm(s1) * np.linalg.norm(s2))
    return [s1, s2, not np.isclose(overlap, 1.0)]


def run_twice_register_noise(ns):
    """Register noise alone: each trajectory's atoms jittered in three
    dimensions, the states aggregated into a density matrix."""
    noise = ns.pkg.NoiseModel(
        trap_depth=1.0, trap_waist=1.0, temperature=50.0, disable_doppler=True
    )
    config = _config(
        ns,
        default_evaluation_times=[1.0],
        observables=[
            ns.obs.StateResult(evaluation_times=[1.0]),
            ns.obs.Occupation(evaluation_times=[0.5, 1.0]),
        ],
        noise_model=noise,
        n_trajectories=6,
    )
    results = ns.BackendV2(sweep_sequence(ns), config=config).run()
    return [
        sorted(noise.noise_types),
        results.final_state.to_qobj().full(),
        [np.asarray(v) for v in results.occupation],
    ]


def dmm_temperature_without_spot_waist(ns):
    P = ns.pkg
    reg = P.Register.from_coordinates(
        [(0.0, 0.0), (6.0, 0.0)], center=False, prefix="q"
    )
    det_map = reg.define_detuning_map({"q0": 1.0, "q1": 0.5})
    mock_device = dataclasses.replace(
        P.AnalogDevice.to_virtual(),
        dmm_objects=(P.channels.dmm.DMM(),),
        reusable_channels=True,
    )
    seq = P.Sequence(reg, mock_device)
    seq.declare_channel("ch0", "rydberg_global")
    seq.add(P.Pulse.ConstantPulse(100, 1, -1, 0), "ch0")
    seq.config_detuning_map(det_map, "dmm_0")
    seq.add_dmm_detuning(P.ConstantWaveform(100, -10), "dmm_0")
    config = _config(
        ns,
        noise_model=P.NoiseModel(trap_waist=1, trap_depth=1, temperature=0.5),
        observables=[ns.obs.StateResult(evaluation_times=[1.0])],
    )
    return ns.BackendV2(seq, config=config)


def run_from_sequence_samples(modulation):
    def case(ns):
        P = ns.pkg
        seq = P.Sequence(P.Register.square(1, prefix="q"), P.AnalogDevice)
        seq.declare_channel("rydberg_global", "rydberg_global")
        seq.add(P.Pulse.ConstantPulse(1000, 1, 0, 0), "rydberg_global")
        config = ns.BackendV2.default_config.with_changes(**ns.kw)
        if modulation:
            config = _config(
                ns,
                with_modulation=True,
                observables=[ns.obs.StateResult()],
                initial_state=ns.State.from_state_amplitudes(
                    eigenstates=("r", "g"), amplitudes={"g": 1.0}
                ),
            )
        backend = ns.BackendV2(seq, config=config)
        s1 = backend.run().final_state.to_qobj().full()
        s2 = backend.run_from_sequence_samples(
            ns.sample(
                seq,
                modulation=modulation,
                extended_duration=seq.get_duration(include_fall_time=modulation),
            ),
            seq.register,
            seq.device,
            config=config,
        ).final_state.to_qobj().full()
        return [s1, np.allclose(s1, s2, atol=0, rtol=1e-16)]

    return case


V2_SCENARIOS = {
    "backend_v2_observable_pipeline": observable_pipeline,
    "backend_v2_default_config": default_config,
    "tpu_state_api": tpu_state_api,
    "tpu_operator_api": tpu_operator_api,
    "callback": callback,
    "backend_v2_energy": energy,
    "backend_v2_energy-wrong_config": energy_wrong_config,
    "backend_v2_eval_times_rounding": eval_times_rounding,
    "leakage-0.0": leakage(0.0),
    "leakage-1.0": leakage(1.0),
    "config_type": config_type,
    "rounding_error_eval_time_duplication": rounding_error_eval_time_duplication,
    "output_state_normalization-0.0": output_state_normalization(0.0),
    "dmm_temperature_without_spot_waist": dmm_temperature_without_spot_waist,
    "run_from_sequence_samples-True": run_from_sequence_samples(True),
    "run_from_sequence_samples-False": run_from_sequence_samples(False),
}

#: The scenarios with stochastic noise (their tests are in
#: tests/test_torch_backend_noisy.py, to spread the file's time).
V2_NOISY_SCENARIOS = {
    "backend_v2_default_noise_model-True": default_noise_model(True),
    "backend_v2_default_noise_model-False": default_noise_model(False),
    "backend_v2_stochastic_noise": stochastic_noise,
    "aggregation": aggregation,
    "output_state_normalization-0.5": output_state_normalization(0.5),
    "run_twice": run_twice,
}

#: The register-noise scenarios.
REGISTER_NOISE_SCENARIOS = {
    "register_detuning_detection": register_detuning_detection,
    "run_twice_register_noise": run_twice_register_noise,
}


def check_v2(scenario) -> None:
    """One scenario in both packages; its own boolean claims hold too."""
    ours = assert_parity(scenario, tol=TOL)
    if ours[0] == "ok" and isinstance(ours[1], list):
        assert all(v is not False for v in ours[1] if isinstance(v, bool))


@pytest.mark.parametrize("name", list(V2_SCENARIOS))
def test_backend_v2_parity(name):
    """The scenarios of tests/test_backend_v2.py, in both packages."""
    check_v2(V2_SCENARIOS[name])


# -- tests/test_tpu_backend_v1.py --------------------------------------


def _raman_seq(ns, device=None, register=None):
    P = ns.pkg
    reg = register if register is not None else P.Register({"q0": (0, 0)})
    seq = P.Sequence(reg, device if device is not None else P.MockDevice)
    seq.declare_channel("raman_local", "raman_local", initial_target="q0")
    seq.add(
        P.Pulse.ConstantDetuning(P.BlackmanWaveform(1000, np.pi), 0, 0),
        "raman_local",
    )
    return seq


def tpu_backend(ns):
    backend = ns.Backend(_raman_seq(ns), **ns.kw)
    results = backend.run()
    final = results[-1].get_state()
    return [
        type(results).__name__,
        results[0].get_state(),
        type(results[-1]).__name__,
        final == results.get_final_state(),
        final,
    ]


def tpu_backend_wrong_config(ns):
    return ns.Backend(_raman_seq(ns), ns.pkg.NoiseModel(), **ns.kw)


def mimic_qpu(which):
    def case(ns):
        P = ns.pkg
        layout = P.register.SquareLatticeLayout(5, 5, 5)
        seq = {
            "virtual": lambda: _raman_seq(ns),
            "no_layout": lambda: _raman_seq(ns).with_new_device(
                P.DigitalAnalogDevice
            ),
            "layout": lambda: _raman_seq(ns)
            .with_new_device(P.DigitalAnalogDevice)
            .with_new_register(layout.square_register(2)),
        }[which]()
        return type(ns.Backend(seq, mimic_qpu=True, **ns.kw)).__name__

    return case


def with_default_noise(ns):
    P = ns.pkg
    spam_noise = P.NoiseModel(
        p_false_pos=0.1,
        p_false_neg=0.05,
        state_prep_error=0.1,
        runs=10,
        samples_per_run=1,
    )
    new_device = dataclasses.replace(P.MockDevice, noise_model=spam_noise)
    backend = ns.Backend(
        _raman_seq(ns, new_device),
        config=ns.backend.EmulatorConfig(prefer_device_noise_model=True),
        **ns.kw,
    )
    results = backend.run()
    return [
        type(results).__name__,
        backend._sim_obj.noise_model == spam_noise,
        [dict(r.bitstring_counts) for r in results],
    ]


def collapse_op(which):
    def case(ns):
        proj = [[0, 0], [0, 1]]
        op = {
            "0": lambda: ns.Qobj(np.array([[0.0, 1.0], [1.0, 0.0]])),
            "1": lambda: ns.Qobj(np.asarray(proj, dtype=float)),
            "2": lambda: np.array(proj),
            "3": lambda: proj,
        }[which]()
        noise_model = ns.pkg.NoiseModel(eff_noise_opers=[op], eff_noise_rates=[0.1])
        backend = ns.Backend(
            _raman_seq(ns),
            config=ns.backend.EmulatorConfig(noise_model=noise_model),
            **ns.kw,
        )
        final = backend.run().get_final_state()
        return [final, np.real(final.tr())]

    return case


V1_SCENARIOS = {
    "tpu_backend": tpu_backend,
    "tpu_backend-wrong_config": tpu_backend_wrong_config,
    **{f"mimic_qpu-{w}": mimic_qpu(w) for w in ("virtual", "no_layout", "layout")},
    "with_default_noise": with_default_noise,
    **{f"collapse_op-collapse_op{w}": collapse_op(w) for w in "0123"},
}


# -- the emulator's façade (config, get_hamiltonian, build_operator) ------


def _simple_sequence(ns):
    P = ns.pkg
    reg = P.Register.from_coordinates([[10, 0], [0, 0]], prefix="atom")
    seq = P.Sequence(reg, P.DigitalAnalogDevice)
    seq.declare_channel("ising", "rydberg_global")
    seq.add(
        P.Pulse.ConstantDetuning(P.RampWaveform(1500, 0.0, 2.0), 1.0, 0.0),
        "ising",
    )
    return seq


def get_hamiltonian_values(ns):
    seq = _simple_sequence(ns)
    sim = ns.Emulator.from_sequence(seq, sampling_rate=0.01, **ns.kw)
    np.random.seed(123)
    noisy = ns.Emulator.from_sequence(
        seq,
        noise_model=ns.pkg.NoiseModel(samples_per_run=1, temperature=20000),
        n_trajectories=15,
        **ns.kw,
    )
    return [
        sim.get_hamiltonian(143),
        noisy.get_hamiltonian(144),
        noisy.get_hamiltonian(144, noiseless=True),
    ]


def _xy_sim(ns):
    P = ns.pkg
    seq = P.Sequence(P.Register.square(2, prefix="atom"), P.MockDevice)
    seq.declare_channel("ch0", "mw_global")
    seq.add(P.Pulse.ConstantPulse(1000, 3.0, 1.0, 0.0), "ch0")
    return ns.Emulator.from_sequence(seq, sampling_rate=0.1, **ns.kw)


def config_roundtrip(ns):
    sim = ns.Emulator.from_sequence(_simple_sequence(ns), **ns.kw)
    SimConfig = ns.emulator.SimConfig
    out = [str(sim.config)]
    sim.set_config(SimConfig(noise=("SPAM", "doppler"), temperature=30))
    out += [str(sim.config), sim.noise_model.temperature]
    sim.add_config(SimConfig(noise="amplitude", amp_sigma=0.2))
    out += [sorted(sim.noise_model.noise_types), sim.noise_model.amp_sigma]
    out.append(_printed(sim.show_config)[1])
    sim.reset_config()
    out += [str(sim.config), sim.initial_state]
    return out


def build_operator(ns):
    sim = ns.Emulator.from_sequence(_simple_sequence(ns), **ns.kw)
    return [
        sim.build_operator([("sigma_rr", "global")]),
        sim.build_operator([("sigma_gr", ["atom0"]), ("sigma_rg", ["atom1"])]),
        sim.build_operator([("I", "global")]),
    ]


FACADE_CASES = {
    "get_hamiltonian_values": get_hamiltonian_values,
    "get_hamiltonian-too_late": lambda ns: ns.Emulator.from_sequence(
        _simple_sequence(ns), sampling_rate=0.01, **ns.kw
    ).get_hamiltonian(1650),
    "get_hamiltonian-negative": lambda ns: ns.Emulator.from_sequence(
        _simple_sequence(ns), sampling_rate=0.01, **ns.kw
    ).get_hamiltonian(-10),
    "get_xy_hamiltonian": lambda ns: _xy_sim(ns).get_hamiltonian(143),
    "set_config-not_a_config": lambda ns: _xy_sim(ns).set_config("SimConfig"),
    "set_config-xy_amplitude": lambda ns: _xy_sim(ns).set_config(
        ns.emulator.SimConfig(noise="amplitude")
    ),
    "config_set_add_show_reset": config_roundtrip,
    "build_operator": build_operator,
    "build_operator-duplicate": lambda ns: ns.Emulator.from_sequence(
        _simple_sequence(ns), **ns.kw
    ).build_operator([("sigma_gg", ["atom0", "atom0"])]),
    "build_operator-invalid_name": lambda ns: ns.Emulator.from_sequence(
        _simple_sequence(ns), **ns.kw
    ).build_operator([("sigma_gg", ["q0"])]),
}


# -- the port's own design ---------------------------------------------


def _all_observables(ns):
    O = ns.obs
    return [
        O.StateResult(evaluation_times=[0.5, 1.0]),
        O.Occupation(evaluation_times=[0.25, 1.0]),
        O.CorrelationMatrix(evaluation_times=[1.0]),
        O.Energy(evaluation_times=[0.5, 1.0]),
        O.EnergyVariance(evaluation_times=[1.0]),
        O.EnergySecondMoment(evaluation_times=[1.0]),
        O.BitStrings(evaluation_times=[1.0], num_shots=300),
    ]


def test_coherent_observables_read_device_states_and_no_matrix(monkeypatch):
    """A coherent run's observables take the solver's states where they
    lie (the state batch is never fetched) and never build the
    Hamiltonian's matrix; the values equal the JAX package's."""

    def refuse(*args, **kwargs):
        raise AssertionError("the backend fetched or densified")

    monkeypatch.setattr(DeviceStateBatch, "state", refuse)
    monkeypatch.setattr(DeviceStateBatch, "fetch_all", refuse)
    monkeypatch.setattr(Hamiltonian, "get_matrix", refuse)

    def case(ns):
        config = _config(ns, observables=_all_observables(ns))
        return ns.BackendV2(sweep_sequence(ns), config=config).run()

    assert_parity(case, tol=TOL)


def test_backend_needs_a_card_or_the_cpu(monkeypatch):
    """Without torch_device the backend runs on the card, and raises
    where there is none; TorchConfig carries the device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="No CUDA device"):
        TorchBackendV2(sweep_sequence(TORCH))
    config = TorchConfig(
        observables=[TORCH.obs.StateResult()], torch_device="cpu"
    )
    assert config.torch_device == "cpu"
    assert "torch_device" in config._expected_kwargs()
    backend = TorchBackendV2(sweep_sequence(TORCH), config=config)
    assert backend._sim_obj._torch_device.type == "cpu"
