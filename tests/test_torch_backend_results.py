"""The port's backend layer against pulser_tpu's: results, aggregators,
configs, the backend ABCs and the observables.

The cases of ``tests/test_backend_results.py``, ``tests/test_aggregators.py``,
``tests/test_tpu_config.py`` and ``tests/test_backend_api.py`` run through
both packages on the same inputs and numpy seed
(:func:`torch_parity.assert_parity`): the same values within 1e-12, equal
seeded counts, the same errors and warnings. Their serialization cases
are not ported: the JSON layer is not, and the port's entry points raise
``NotImplementedError`` naming the ROADMAP item that brings it, which is
pinned here. The aggregators' torch-tensor branches (the JAX package's
``jax.Array`` ones) are pinned against numpy.
"""

from __future__ import annotations

import dataclasses
import pickle
from collections import Counter

import numpy as np
import pytest
import torch

from torch_parity import JAX, TORCH, assert_parity, outcome

from pulser_tpu_torch.backend import aggregators as torch_agg
from pulser_tpu_torch.backend.config import EmulationConfig
from pulser_tpu_torch.backend.results import Results
from pulser_tpu_torch.emulator import TorchConfig

torch.set_num_threads(1)

TOL = 1e-12


def ghz2(ns):
    return ns.State.from_state_amplitudes(
        eigenstates=("r", "g"),
        amplitudes={"gg": 1 / np.sqrt(2), "rr": 1 / np.sqrt(2)},
    )


def ghz3(ns):
    return ns.State.from_state_amplitudes(
        eigenstates=("r", "g"),
        amplitudes={"rrr": np.sqrt(0.5), "ggg": np.sqrt(0.5)},
    )


def number_op(ns, q, n=2):
    return ns.Operator.from_operator_repr(
        eigenstates=("r", "g"), n_qudits=n, operations=[(1.0, [({"rr": 1.0}, [q])])]
    )


def identity3(ns):
    return ns.Operator.from_operator_repr(
        eigenstates=("r", "g"), n_qudits=3, operations=[(1.0, [])]
    )


def zzz(ns):
    return ns.Operator.from_operator_repr(
        eigenstates=("r", "g"),
        n_qudits=3,
        operations=[(1.0, [({"rr": 1.0, "gg": -1.0}, [0, 1, 2])])],
    )


def _results(ns, atoms=("q0", "q1"), duration=100):
    return ns.results.Results(atom_order=atoms, total_duration=duration)


# -- tests/test_backend_results.py ---------------------------------------


def store_and_retrieve(ns):
    res = _results(ns)
    obs = ns.obs.Occupation(evaluation_times=[0.5, 1.0])
    res._store(observable=obs, time=0.5, value=[0.1, 0.2])
    res._store(observable=obs, time=1.0, value=[0.3, 0.4])
    return [
        res.get_result_tags(),
        res.get_result_times("occupation"),
        res.get_tagged_results(),
        res.get_result("occupation", 1.0),
        res.occupation,
        res.get_result(obs, 0.5),
        str(res),
    ]


def double_store(ns):
    res = _results(ns)
    obs = ns.obs.Occupation(evaluation_times=[1.0])
    res._store(observable=obs, time=1.0, value=[0.5])
    res._store(observable=obs, time=1.0, value=[0.6])


def missing_time(ns):
    res = _results(ns)
    obs = ns.obs.Occupation(evaluation_times=[1.0])
    res._store(observable=obs, time=1.0, value=[0.5])
    return res.get_result("occupation", 0.123)


def ghz_expectations(ns):
    O = ns.obs
    g = ghz2(ns)
    cfg = ns.backend.EmulationConfig(observables=[O.BitStrings()])
    return [
        O.Occupation(evaluation_times=[1.0]).apply(
            state=g, hamiltonian=number_op(ns, 0)
        ),
        O.CorrelationMatrix(evaluation_times=[1.0]).apply(
            state=g, hamiltonian=number_op(ns, 0)
        ),
        O.Expectation(number_op(ns, 0), tag_suffix="n0").apply(state=g),
        O.Energy().apply(state=g, hamiltonian=number_op(ns, 0)),
        O.BitStrings(evaluation_times=[1.0], num_shots=2000).apply(
            state=g, config=cfg
        ),
    ]


def _traj_results(ns, occupations, counters):
    out = []
    for occ, cnt in zip(occupations, counters):
        res = _results(ns)
        res._store(
            observable=ns.obs.Occupation(evaluation_times=[1.0]),
            time=1.0,
            value=np.asarray(occ),
        )
        res._store(
            observable=ns.obs.BitStrings(evaluation_times=[1.0], num_shots=10),
            time=1.0,
            value=Counter(cnt),
        )
        out.append(res)
    return out


def aggregate_mean_and_bag(ns):
    results = _traj_results(
        ns, [[0.2, 0.4], [0.4, 0.6]], [{"00": 6, "11": 4}, {"00": 2, "11": 8}]
    )
    agg = ns.results.Results.aggregate(results)
    single = ns.results.Results.aggregate(results[:1])
    return [agg.occupation, agg.bitstrings, single is results[0]]


def aggregate_incompatible(ns):
    a = _traj_results(ns, [[0.2, 0.4]], [{"00": 10}])[0]
    b = _results(ns, atoms=("q0",), duration=50)
    return ns.results.Results.aggregate([a, b])


def observable_validation(ns):
    O = ns.obs
    a, b = O.Occupation(evaluation_times=[1.0]), O.Occupation()
    return [
        O.Occupation(evaluation_times=[1.0], tag_suffix="qubits").tag,
        a.uuid != b.uuid,
        repr(a).startswith("occupation:"),
    ]


def spam_flips(ns):
    all_g = ns.State.from_state_amplitudes(
        eigenstates=("r", "g"), amplitudes={"gg": 1.0}
    )
    return all_g.sample(num_shots=5000, p_false_pos=0.2, p_false_neg=0.0)


RESULTS_CASES = {
    "TestResultsStorage-store_and_retrieve_by_tag": store_and_retrieve,
    "TestResultsStorage-double_store_same_time_rejected": double_store,
    "TestResultsStorage-get_result_missing_time": missing_time,
    "TestGHZExpectations": ghz_expectations,
    "TestAggregation-mean_and_bag_union": aggregate_mean_and_bag,
    "TestAggregation-requires_compatible_results": aggregate_incompatible,
    "TestAggregation-aggregate_empty": lambda ns: ns.results.Results.aggregate([]),
    "TestObservableValidation-bounds_high": lambda ns: ns.obs.Occupation(
        evaluation_times=[1.5]
    ),
    "TestObservableValidation-bounds_low": lambda ns: ns.obs.Occupation(
        evaluation_times=[-0.1]
    ),
    "TestObservableValidation-tag_and_uuid": observable_validation,
    "TestEmulationConfigValidation-interaction_matrix_shapes": lambda ns: [
        ns.backend.EmulationConfig(interaction_matrix=np.zeros((3, 3))).interaction_matrix.shape,
    ],
    "TestEmulationConfigValidation-interaction_matrix_bad": lambda ns: ns.backend.EmulationConfig(
        interaction_matrix=np.zeros((3, 4))
    ),
    "TestEmulationConfigValidation-interaction_matrix_symmetry": lambda ns: ns.backend.EmulationConfig(
        interaction_matrix=np.array([[0.0, 1.0], [2.0, 0.0]])
    ),
    "TestEmulationConfigValidation-default_evaluation_times": lambda ns: ns.backend.EmulationConfig(
        default_evaluation_times=[0.0, 0.5, 1.0]
    ).default_evaluation_times,
    "TestEmulationConfigValidation-unsorted_times": lambda ns: ns.backend.EmulationConfig(
        default_evaluation_times=[0.5, 0.2]
    ),
    "TestEmulationConfigValidation-with_changes": lambda ns: (
        lambda cfg: [
            cfg.with_changes(default_num_shots=500).default_num_shots,
            cfg.default_num_shots,
        ]
    )(ns.backend.EmulationConfig(default_num_shots=100)),
    "TestStateSampling-spam_flips": spam_flips,
    "TestStateSampling-overlap": lambda ns: ghz2(ns).overlap(
        ns.State.from_state_amplitudes(eigenstates=("r", "g"), amplitudes={"gg": 1.0})
    ),
}


@pytest.mark.parametrize("name", list(RESULTS_CASES))
def test_backend_results_parity(name):
    """The cases of tests/test_backend_results.py."""
    assert_parity(RESULTS_CASES[name], tol=TOL)


# -- tests/test_aggregators.py -------------------------------------------


def _agg(ns, which):
    return getattr(ns.aggregators, f"_{which}_aggregator")


AGG_VALUES = {
    "floats": [1.0, 2.0, 3.0, 4.0],
    "complex": [1.0j, 2.0j, 3.0j, 4.0j],
    "arrays": [np.array([1.0, 2.0, 3.0]), np.array([2.0, 3.0, 4.0]), np.array([3.0, 4.0, 5.0])],
    "lists": [[1.0, 2.0, 3.0], [2.0, 3.0, 4.0], [3.0, 4.0, 5.0]],
    "matrices": [[[1.0, 2.0, 3.0]], [[2.0, 3.0, 4.0]], [[3.0, 4.0, 5.0]]],
}
AGG_ERRORS = {
    "empty": [],
    "empty_lists": [[], []],
    "not_a_list": "abcd",
    "dicts": [{}, {}],
    "lists_of_dicts": [[{}], [{}]],
    "matrices_of_str": [[["abcd"]], [["efgh"]]],
    "empty_columns": [[[]], [[]]],
}

AGGREGATOR_CASES = {
    "bag_union": lambda ns: _agg(ns, "bag_union")(
        [{"1010": 5, "0101": 7, "0000": 2}, Counter({"1010": 3, "0101": 9, "1111": 4})]
    ),
    **{
        f"{which}_aggregator-{kind}": (
            lambda ns, which=which, v=v: _agg(ns, which)(v)
        )
        for which in ("mean", "std", "mean_std")
        for kind, v in AGG_VALUES.items()
    },
    **{
        f"{which}_aggregator_errors-{kind}": (
            lambda ns, which=which, v=v: _agg(ns, which)(v)
        )
        for which in ("mean", "std")
        for kind, v in AGG_ERRORS.items()
    },
}


@pytest.mark.parametrize("name", list(AGGREGATOR_CASES))
def test_aggregators_parity(name):
    """The cases of tests/test_aggregators.py."""
    assert_parity(AGGREGATOR_CASES[name], tol=TOL)


@pytest.mark.parametrize("which", ["mean", "std", "mean_std"])
def test_aggregators_take_torch_tensors(which):
    """The torch branch (the JAX package's jax.Array one) stacks along a
    new first axis, the std with Bessel's correction, as numpy does."""
    values = [np.array([1.0, 2.0, 3.0]), np.array([2.0, 3.0, 5.0]), np.array([3.0, 4.0, 5.0])]
    got = getattr(torch_agg, f"_{which}_aggregator")([torch.tensor(v) for v in values])
    want = getattr(torch_agg, f"_{which}_aggregator")(values)
    got, want = (got, want) if which == "mean_std" else ((got,), (want,))
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-15)


# -- tests/test_tpu_config.py --------------------------------------------


def _state_result(ns):
    return [ns.obs.StateResult(evaluation_times=[1.0])]


def evaluation_times_union(ns):
    config = ns.Config(
        observables=[
            ns.obs.StateResult(evaluation_times=np.array([0.2, 0.4, 0.8])),
            ns.obs.StateResult(
                evaluation_times=np.array([0.15, 0.35, 0.65, 0.95]),
                tag_suffix="second",
            ),
        ],
        default_evaluation_times=np.array([0.0, 0.25, 0.5, 0.75, 1.0]),
        **ns.kw,
    )
    return [
        config._get_legacy_evaluation_times(1000),
        config._get_sampling_indices(40),
    ]


CONFIG_CASES = {
    "no_interaction_matrix": lambda ns: ns.Config(
        observables=_state_result(ns), interaction_matrix=np.eye(4), **ns.kw
    ),
    "sampling_rate-too_high": lambda ns: ns.Config(
        observables=_state_result(ns), sampling_rate=1.2, **ns.kw
    ),
    "sampling_rate": lambda ns: [
        ns.Config(observables=_state_result(ns), sampling_rate=0.5, **ns.kw).sampling_rate
    ],
    "samples_per_run": lambda ns: ns.Config(
        observables=_state_result(ns),
        noise_model=ns.pkg.NoiseModel(temperature=45, samples_per_run=5),
        **ns.kw,
    ).noise_model.samples_per_run,
    "initial_state": lambda ns: ns.Config(
        observables=_state_result(ns), initial_state="all-ground", **ns.kw
    ),
    "preferred_types": lambda ns: [
        ns.Config.state_type is ns.State,
        ns.Config.operator_type is ns.Operator,
    ],
    "progress_bar": lambda ns: ns.Config(
        observables=_state_result(ns), progress_bar=True, **ns.kw
    ).progress_bar,
    "evaluation_times_as_numpy_arrays": evaluation_times_union,
    **{
        f"solver-{s}": (
            lambda ns, s=s: ns.Config(
                observables=[ns.obs.BitStrings(evaluation_times=[1.0])],
                solver=s,
                **ns.kw,
            ).solver.value
        )
        for s in ("default", "MasterEquation", "MonteCarlo")
    },
    "invalid_solver_error": lambda ns: ns.Config(
        observables=[ns.obs.BitStrings(evaluation_times=[1.0])],
        solver="fakesolver",
        **ns.kw,
    ),
}


@pytest.mark.parametrize("name", list(CONFIG_CASES))
def test_torch_config_parity(name):
    """The cases of tests/test_tpu_config.py (serialization aside)."""
    assert_parity(CONFIG_CASES[name], tol=TOL)


def test_torch_config_expected_kwargs():
    """TorchConfig's own keyword: the device, handed to the emulator."""
    obs = [TORCH.obs.StateResult()]
    config = TorchConfig(observables=obs, torch_device=torch.device("cpu"))
    assert config.torch_device == "cpu"
    assert {"sampling_rate", "progress_bar", "torch_device"} <= config._expected_kwargs()
    assert TorchConfig(observables=obs).torch_device is None
    with pytest.raises(ValueError, match="unexpected keyword arguments"):
        TorchConfig(observables=obs, device="cpu")


# -- tests/test_backend_api.py -------------------------------------------


def _sequence(ns):
    P = ns.pkg
    reg = P.Register.square(2, spacing=5, prefix="q")
    seq = P.Sequence(reg, P.MockDevice)
    seq.declare_channel("rydberg_global", "rydberg_global")
    seq.add(P.Pulse.ConstantPulse(1000, 1, -1, 0), "rydberg_global")
    return seq


def _concrete_backend(ns):
    class ConcreteBackend(ns.backend.Backend):
        def run(self):
            pass

    return ConcreteBackend


def _concrete_emulator(ns):
    class ConcreteEmulator(ns.backend.EmulatorBackend):
        default_config = ns.backend.EmulationConfig(
            observables=(ns.obs.BitStrings(num_shots=100),),
            with_modulation=True,
            extra_param="foo",
        )

        def run(self):
            pass

    return ConcreteEmulator


def validate_rejects_empty(parametrized):
    def case(ns):
        P = ns.pkg
        coords = [(5.0 * i, 5.0 * j) for i in range(3) for j in range(3)]
        reg = P.register.RegisterLayout(coords).define_register(
            0, 1, 3, 4, qubit_ids=["q0", "q1", "q2", "q3"]
        )
        seq = P.Sequence(reg, P.DigitalAnalogDevice)
        seq.declare_channel("rydberg_local", "rydberg_local")
        targ = seq.declare_variable("targ", dtype=int) if parametrized else 0
        seq.target_index(targ, "rydberg_local")
        out = []
        try:
            ns.backend.Backend.validate_sequence(seq, mimic_qpu=True)
        except ValueError as err:
            out.append(str(err))
        seq.delay(100, "rydberg_local")
        ns.backend.Backend.validate_sequence(seq, mimic_qpu=True)
        return out

    return case


def validate_config_merges_defaults(ns):
    cls = _concrete_emulator(ns)
    config = ns.backend.EmulationConfig(
        observables=(ns.obs.BitStrings(num_shots=100),),
        default_evaluation_times="Full",
        my_param="bar",
    )
    merged = cls(_sequence(ns), config=config)._config
    return [
        merged.with_modulation,
        merged.extra_param,
        merged.my_param,
        merged.default_evaluation_times,
        type(merged).__name__,
    ]


def device_noise_runs_ignored(ns):
    cls = _concrete_emulator(ns)
    config = ns.backend.EmulationConfig(
        observables=(ns.obs.StateResult(),), prefer_device_noise_model=True
    )
    seq = _sequence(ns)
    device = dataclasses.replace(
        seq.device, default_noise_model=ns.pkg.NoiseModel(amp_sigma=0.1, runs=3)
    )
    cls(ns.pkg.Sequence(seq.register, device), config=config)
    return config.n_trajectories


def pickle_roundtrip(ns):
    cf = ns.backend.EmulationConfig(observables=[ns.obs.StateResult()])
    new_cf = pickle.loads(pickle.dumps(cf))
    return [
        sorted(cf._backend_options) == sorted(new_cf._backend_options),
        [o.uuid for o in cf.observables] == [o.uuid for o in new_cf.observables],
        new_cf.n_trajectories,
    ]


def results_access(ns):
    res = _results(ns, atoms=(), duration=100)
    out = [res.get_result_tags(), res.get_tagged_results()]
    for probe in (
        lambda: res.bitstrings,
        lambda: res.get_result_times("bitstrings"),
        lambda: res.get_result(ns.obs.BitStrings(num_shots=100, tag_suffix="t"), 1.0),
        lambda: _results(ns, atoms=(), duration=0).final_bitstrings,
        lambda: _results(ns, atoms=(), duration=0).final_state,
        lambda: res.not_an_attr,
        *[
            (lambda a=a: getattr(res, a))
            for a in ns.results._SAMPLED_RESULT_ATTRS
        ],
    ):
        try:
            probe()
        except Exception as err:
            out.append((type(err).__name__, str(err)))
    return out


def final_state_stored(ns):
    res = _results(ns, atoms=("q0", "q1", "q2"))
    obs = ns.obs.StateResult()
    obs(
        config=ns.backend.EmulationConfig(observables=(obs,)),
        t=1.0,
        state=ghz3(ns),
        hamiltonian=identity3(ns),
        result=res,
    )
    stored = res.final_state
    return [stored == res.get_result(obs, 1.0), stored.overlap(ghz3(ns))]


def from_final_bitstrings(ns):
    R = ns.results.Results
    res = R.from_final_bitstrings(
        atom_order=("q0", "q1", "q2"),
        total_duration=1000,
        final_bitstrings={"000": 60, "111": 40},
    )
    res2 = R.from_final_bitstrings(
        atom_order=("q0", "q1"),
        total_duration=100,
        final_bitstrings=Counter({"01": 5, "10": 5}),
    )
    return [
        res.atom_order,
        res.total_duration,
        res.final_bitstrings,
        res.get_result_times("bitstrings"),
        res2.final_bitstrings,
        res.bitstring_counts,
        str(res),
    ]


def storage_window(eval_times):
    def case(ns):
        config = ns.backend.EmulationConfig(observables=(ns.obs.BitStrings(num_shots=1),))
        results = _results(ns, atoms=("q0", "q1", "q2"), duration=1000)
        obs = ns.obs.StateResult(evaluation_times=eval_times)
        g, h = ghz3(ns), identity3(ns)
        tol = 0.5 / results.total_duration
        out = []
        for t in (0.1, 1.0 - tol, 1.0, 1.0, 1.0 + tol):
            try:
                obs(config, t, g, h, results)
                out.append(results.get_result_times(obs) if results.get_result_tags() else [])
            except RuntimeError as err:
                out.append(str(err))
        return out

    return case


def _results_pair(ns, values1=(1.0, 2.0), values2=(3.0, 4.0)):
    out = []
    for vals in (values1, values2):
        res = _results(ns, atoms=(0, 1))
        obs = ns.obs.Energy()
        for t, v in zip((0.1, 0.2), vals):
            res._store(observable=obs, time=t, value=v)
        out.append(res)
    return out


def aggregation_semantics(which):
    def case(ns):
        R = ns.results.Results
        AM = ns.backend.AggregationMethod
        r1, r2 = _results_pair(ns)
        if which == "custom_callable_aggregator":
            calls = []

            def aggregator(values):
                calls.append(tuple(values))
                return min(values)

            agg = R.aggregate([r1, r2], energy=aggregator)
            return [calls, agg.energy, agg.get_result_times("energy")]
        if which == "meanstd_override":
            return R.aggregate([r1, r2], energy=AM.MEANSTD).energy
        if which == "mean_default":
            return R.aggregate([r1, r2]).energy
        if which == "single_results_returned_unchanged":
            return R.aggregate([r1]) is r1
        if which == "times_mismatch":
            r2._times[next(iter(r2._times))] = [0.1, 0.3]
        elif which == "missing_tag_not_skipped":
            r2 = _results(ns, atoms=(0, 1))
            r2._store(observable=ns.obs.Occupation(), time=0.1, value=[0.5, 0.5])
        elif which == "missing_tag_skipped_is_fine":
            r2._store(observable=ns.obs.StateResult(), time=0.1, value="a state")
        elif which == "skip_warn_common_tag_warns":
            for res in (r1, r2):
                res._store(observable=ns.obs.StateResult(), time=0.1, value="a state")
        elif which in ("atom_order_mismatch", "duration_mismatch"):
            r2 = _results(
                ns,
                atoms=(0, 2) if which == "atom_order_mismatch" else (0, 1),
                duration=100 if which == "atom_order_mismatch" else 200,
            )
            r2._store(observable=ns.obs.Energy(), time=0.1, value=1.0)
            r2._store(observable=ns.obs.Energy(), time=0.2, value=1.0)
        elif which == "aggregation_method_mismatch":
            for uid in r2._aggregation_methods:
                r2._aggregation_methods[uid] = AM.BAG_UNION
        elif which == "legacy_results_not_aggregatable":
            r1._aggregation_methods = {}
        return R.aggregate([r1, r2]).get_result_tags()

    return case


def default_aggregation_methods(ns):
    O = ns.obs
    out = []
    for cls in (
        O.StateResult,
        O.BitStrings,
        O.CorrelationMatrix,
        O.Occupation,
        O.Energy,
        O.EnergyVariance,
        O.EnergySecondMoment,
    ):
        out.append(int(cls().default_aggregation_method))
        out.append(
            int(
                cls(
                    default_aggregation_method=ns.backend.AggregationMethod.SKIP
                ).default_aggregation_method
            )
        )
    return out


def one_state_values(one_state):
    def case(ns):
        corr = ns.obs.CorrelationMatrix(one_state=one_state)
        occ = ns.obs.Occupation(one_state=one_state)
        ggr = ns.State.from_state_amplitudes(
            eigenstates=("r", "g"), amplitudes={"ggr": 1.0}
        )
        h = identity3(ns)
        return [
            corr.tag,
            occ.tag,
            corr.apply(state=ghz3(ns), hamiltonian=h),
            occ.apply(state=ghz3(ns), hamiltonian=h),
            corr.apply(state=ggr, hamiltonian=h),
            occ.apply(state=ggr, hamiltonian=h),
        ]

    return case


def energy_trio(ns):
    O = ns.obs
    ggg_proj = ns.Operator.from_operator_repr(
        eigenstates=("r", "g"),
        n_qudits=3,
        operations=[(1.0, [({"gg": -1.0}, [0, 1, 2])])],
    )
    out = []
    for ham in (identity3(ns), zzz(ns), ggg_proj):
        for obs in (O.Energy(), O.EnergySecondMoment(), O.EnergyVariance()):
            out.append(obs.apply(state=ghz3(ns), hamiltonian=ham))
    return out


API_CASES = {
    "TestBackendABC-cannot_instantiate_abstract": lambda ns: ns.backend.Backend(
        _sequence(ns)
    ),
    "TestBackendABC-requires_sequence_instance": lambda ns: _concrete_backend(ns)(
        "a serialized sequence"
    ),
    "TestBackendABC-validate_sequence_rejects_empty-True": validate_rejects_empty(True),
    "TestBackendABC-validate_sequence_rejects_empty-False": validate_rejects_empty(False),
    **{
        f"TestEmulatorConfigLegacy-value_errors-{i}": (
            lambda ns, kw=kw: ns.backend.EmulatorConfig(**kw)
        )
        for i, kw in enumerate(
            [
                {"sampling_rate": 0},
                {"sampling_rate": 1.2},
                {"evaluation_times": "full"},
                {"evaluation_times": 1.001},
                {"evaluation_times": [-1e9, 1]},
                {"initial_state": "all_ground"},
            ]
        )
    },
    **{
        f"TestEmulatorConfigLegacy-type_errors-{k}": (
            lambda ns, k=k: ns.backend.EmulatorConfig(**{k: None})
        )
        for k in ("evaluation_times", "initial_state", "noise_model")
    },
    "TestEmulatorConfigLegacy-defaults_valid": lambda ns: (
        lambda c: [c.sampling_rate, c.evaluation_times, c.initial_state, c.noise_model == ns.pkg.NoiseModel()]
    )(ns.backend.EmulatorConfig()),
    "TestBackendConfigCore-rejects_unexpected_kwargs": lambda ns: ns.backend.BackendConfig(
        prefer_device_noise_model=True
    ),
    "TestBackendConfigCore-missing_attribute_error": lambda ns: ns.backend.BackendConfig().dt,
    "TestBackendConfigCore-legacy_backend_options_deprecated": lambda ns: (
        lambda c: [c.backend_options, c.dt, c.default_num_shots]
    )(ns.backend.BackendConfig(default_num_shots=1, backend_options={"dt": 10})),
    "TestBackendConfigCore-default_num_shots_validation": lambda ns: ns.backend.BackendConfig(
        default_num_shots=0.1
    ),
    "TestBackendConfigCore-default_num_shots_cast": lambda ns: ns.backend.BackendConfig(
        default_num_shots=5.0
    ).default_num_shots,
    "TestBackendConfigCore-read_only": lambda ns: setattr(
        ns.backend.BackendConfig(), "default_num_shots", 1
    ),
    "TestBackendConfigCore-with_changes": lambda ns: (
        lambda c: [c.with_changes(default_num_shots=1).default_num_shots, c.default_num_shots]
    )(ns.backend.BackendConfig()),
    "TestBackendConfigCore-repr": lambda ns: repr(ns.backend.BackendConfig()),
    "TestBackendConfigCore-pickle_roundtrip": pickle_roundtrip,
    "TestEmulationConfigValidation-warns_without_observables": lambda ns: ns.backend.EmulationConfig().observables,
    "TestEmulationConfigValidation-observables_must_be_observables": lambda ns: ns.backend.EmulationConfig(
        observables=["fidelity"]
    ),
    "TestEmulationConfigValidation-callbacks_must_not_be_observables": lambda ns: ns.backend.EmulationConfig(
        callbacks=(ns.obs.BitStrings(),), observables=(ns.obs.StateResult(),)
    ),
    "TestEmulationConfigValidation-callbacks_must_be_callbacks": lambda ns: ns.backend.EmulationConfig(
        callbacks=("Hello",), observables=(ns.obs.StateResult(),)
    ),
    "TestEmulationConfigValidation-duplicate_observable_tags": lambda ns: ns.backend.EmulationConfig(
        observables=[ns.obs.BitStrings(), ns.obs.BitStrings(num_shots=200000)]
    ),
    **{
        f"TestEmulationConfigValidation-default_evaluation_times_validation-{i}": (
            lambda ns, t=t: ns.backend.EmulationConfig(
                observables=(ns.obs.BitStrings(num_shots=10),),
                default_evaluation_times=t,
            )
        )
        for i, t in enumerate(
            [[-1e15, 0.0, 0.5, 1.0], [0.0, 0.5, 0.5 + 1e-14, 1.0], [0.0, 1.0, 0.5]]
        )
    },
    "TestEmulationConfigValidation-initial_state_type": lambda ns: ns.backend.EmulationConfig(
        observables=(ns.obs.StateResult(),), initial_state=[[1], [0]]
    ),
    "TestEmulationConfigValidation-interaction_matrix_vs_initial_state": lambda ns: ns.backend.EmulationConfig(
        observables=(ns.obs.StateResult(),),
        interaction_matrix=np.eye(2),
        initial_state=ns.State.from_state_amplitudes(
            eigenstates=("r", "g"), amplitudes={"rrr": 1.0}
        ),
    ),
    **{
        f"TestEmulationConfigValidation-interaction_matrix_diagonal_warning-{len(s)}": (
            lambda ns, s=s: ns.backend.EmulationConfig(
                observables=(ns.obs.StateResult(),), interaction_matrix=np.ones(s)
            ).interaction_matrix.shape
        )
        for s in [(4, 4), (2, 4, 4)]
    },
    **{
        f"TestEmulationConfigValidation-interaction_matrix_asymmetry-{len(s)}": (
            lambda ns, s=s: ns.backend.EmulationConfig(
                observables=(ns.obs.StateResult(),),
                interaction_matrix=np.ones(s)
                + np.pad([[1e-4]], [(0, s[-2] - 1), (s[-1] - 1, 0)]),
            )
        )
        for s in [(4, 4), (2, 4, 4)]
    },
    "TestEmulationConfigValidation-xy_shaped_interaction_matrix_accepted": lambda ns: ns.backend.EmulationConfig(
        observables=(ns.obs.StateResult(),),
        interaction_matrix=np.array([[[0, 1], [1, 0]], [[0, 2], [2, 0]]]),
    ).interaction_matrix.shape,
    "TestEmulationConfigValidation-bad_interaction_matrix_shape": lambda ns: ns.backend.EmulationConfig(
        observables=(ns.obs.StateResult(),), interaction_matrix=np.arange(12).reshape((4, 3))
    ),
    "TestEmulationConfigValidation-noise_model_type": lambda ns: ns.backend.EmulationConfig(
        observables=(ns.obs.StateResult(),), noise_model={"p_false_pos": 0.1}
    ),
    "TestEmulationConfigValidation-extra_kwargs_tolerated": lambda ns: ns.backend.EmulationConfig(
        observables=(ns.obs.StateResult(),), dt=1
    ).dt,
    **{
        f"TestEmulationConfigValidation-n_trajectories_must_be_positive_int-{b}": (
            lambda ns, b=b: ns.backend.EmulationConfig(
                observables=(ns.obs.StateResult(),), n_trajectories=b
            )
        )
        for b in (0, 1.001)
    },
    "TestEmulationConfigValidation-n_trajectories_vs_noise_model_runs": lambda ns: ns.backend.EmulationConfig(
        observables=(ns.obs.StateResult(),),
        noise_model=ns.pkg.NoiseModel(amp_sigma=0.1, runs=10),
        n_trajectories=2,
    ),
    "TestEmulationConfigValidation-n_trajectories_resolution": lambda ns: [
        ns.backend.EmulationConfig(
            observables=(ns.obs.StateResult(),),
            noise_model=ns.pkg.NoiseModel(amp_sigma=0.1, runs=10),
            **kw,
        ).n_trajectories
        for kw in ({"n_trajectories": 10.0}, {}, {"prefer_device_noise_model": True})
    ],
    "TestEmulationConfigValidation-n_trajectories_default_and_with_changes": lambda ns: (
        lambda c: [c.n_trajectories, c.with_changes(n_trajectories=10).n_trajectories]
    )(ns.backend.EmulationConfig(observables=(ns.obs.StateResult(),))),
    "TestEmulationConfigValidation-state_and_operator_types": lambda ns: [
        ns.backend.EmulationConfig.state_type is ns.backend.StateRepr,
        ns.backend.EmulationConfig.operator_type is ns.backend.OperatorRepr,
    ],
    "TestEmulationConfigValidation-numpy_default_evaluation_times": lambda ns: ns.backend.EmulationConfig(
        default_evaluation_times=np.array([0.5, 1.0]), observables=(ns.obs.StateResult(),)
    ).default_evaluation_times,
    "TestEmulatorBackendConfig-config_type_check": lambda ns: _concrete_emulator(ns)(
        _sequence(ns), config=ns.backend.EmulatorConfig
    ),
    "TestEmulatorBackendConfig-validate_config_merges_defaults": validate_config_merges_defaults,
    "TestEmulatorBackendConfig-device_noise_runs_ignored_warning": device_noise_runs_ignored,
    "TestResultsAccess-errors": results_access,
    "TestResultsAccess-final_state_stored": final_state_stored,
    "TestResultsAccess-from_final_bitstrings": from_final_bitstrings,
    "TestResultsAccess-from_final_bitstrings-invalid": lambda ns: ns.results.Results.from_final_bitstrings(
        atom_order=("q0",), total_duration=100, final_bitstrings=42
    ),
    "TestObservableCallTiming-storage_window-None": storage_window(None),
    "TestObservableCallTiming-storage_window-times": storage_window((0.0, 0.5, 1.0)),
    "TestAggregationSemantics-default_aggregation_methods": default_aggregation_methods,
    **{
        f"TestAggregationSemantics-{w}": aggregation_semantics(w)
        for w in (
            "custom_callable_aggregator",
            "meanstd_override",
            "mean_default",
            "single_results_returned_unchanged",
            "times_mismatch",
            "missing_tag_not_skipped",
            "missing_tag_skipped_is_fine",
            "skip_warn_common_tag_warns",
            "atom_order_mismatch",
            "duration_mismatch",
            "aggregation_method_mismatch",
            "legacy_results_not_aggregatable",
        )
    },
    "TestAggregationSemantics-aggregate_empty": lambda ns: ns.results.Results.aggregate([]),
    **{
        f"TestObservableValues-correlation_and_occupation_one_state-{o}": one_state_values(o)
        for o in (None, "r", "g")
    },
    "TestObservableValues-energy_trio": energy_trio,
    "TestObservableValues-expectation": lambda ns: [
        ns.obs.Expectation(identity3(ns)).apply(state=ghz3(ns)),
        ns.obs.Expectation(zzz(ns), tag_suffix="zzz").tag,
        ns.obs.Expectation(zzz(ns), tag_suffix="zzz").apply(state=ghz3(ns)),
    ],
    "TestObservableValues-expectation-not_an_operator": lambda ns: ns.obs.Expectation(
        "not an operator"
    ),
    "TestObservableValues-fidelity": lambda ns: [
        ns.obs.Fidelity(
            ns.State.from_state_amplitudes(eigenstates=("r", "g"), amplitudes={"ggg": 1.0}),
            tag_suffix="ggg",
        ).apply(state=ghz3(ns)),
        ns.obs.Fidelity(ghz3(ns)).apply(state=ghz3(ns)),
    ],
    "TestObservableValues-fidelity-not_a_state": lambda ns: ns.obs.Fidelity("not a state"),
    "TestObservableValues-state_result_identity": lambda ns: ns.obs.StateResult()
    .apply(state=ghz3(ns))
    .overlap(ghz3(ns)),
}


@pytest.mark.parametrize("name", list(API_CASES))
def test_backend_api_parity(name):
    """The non-serialization cases of tests/test_backend_api.py."""
    assert_parity(API_CASES[name], tol=TOL)


# -- the JSON round trip ----------------------------------------------------


def _config_pair(ns, config_cls):
    """A config with an observable and a noise model, written by the
    package behind ``ns``."""
    return config_cls(
        observables=[ns.obs.Occupation(evaluation_times=[0.5, 1.0])],
        noise_model=ns.pkg.NoiseModel(dephasing_rate=0.1),
        **(ns.kw if config_cls is ns.Config else {}),
    ).to_abstract_repr()


def _stored_results(ns) -> str:
    res = _results(ns)
    res._store(
        observable=ns.obs.Occupation(evaluation_times=[1.0]),
        time=1.0,
        value=[0.25, 0.75],
    )
    return res.to_abstract_repr()


def _writes_back(cls, s: str) -> bool:
    return cls.from_abstract_repr(s).to_abstract_repr() == s


@pytest.mark.parametrize(
    "call",
    [
        # The port writes a config; it and the JAX package load it back
        lambda: _writes_back(EmulationConfig, _config_pair(TORCH, EmulationConfig))
        and _writes_back(
            JAX.config.EmulationConfig, _config_pair(TORCH, EmulationConfig)
        ),
        # The port loads a config the JAX package wrote
        lambda: _writes_back(
            EmulationConfig, _config_pair(JAX, JAX.config.EmulationConfig)
        ),
        # The backend's config, its torch device left off the wire
        lambda: _writes_back(TorchConfig, _config_pair(TORCH, TorchConfig))
        and "torch_device" not in _config_pair(TORCH, TorchConfig)
        and _writes_back(JAX.Config, _config_pair(TORCH, TorchConfig)),
        # Results without tags: the same string as the JAX package's
        lambda: Results(atom_order=(), total_duration=0).to_abstract_repr()
        == JAX.results.Results(atom_order=(), total_duration=0).to_abstract_repr()
        and _writes_back(Results, Results(atom_order=(), total_duration=0).to_abstract_repr()),
        # The port loads results the JAX package wrote
        lambda: _writes_back(Results, _stored_results(JAX))
        and _writes_back(JAX.results.Results, _stored_results(TORCH)),
    ],
    ids=[
        "config.to_abstract_repr",
        "config.from_abstract_repr",
        "torch_config.to_abstract_repr",
        "results.to_abstract_repr",
        "results.from_abstract_repr",
    ],
)
def test_serialization_raises_quoting_the_roadmap(call):
    """The five JSON calls that raised until the JSON layer was ported
    (quoting its ROADMAP item) now round-trip: each string loads back in
    the port and in the JAX package and is written back unchanged."""
    assert call() is True


def test_results_abstract_repr_dict_is_the_jax_packages():
    """The serialization dict (built without the JSON layer) equals the
    JAX package's."""

    def case(ns):
        res = _results(ns)
        res._store(
            observable=ns.obs.Occupation(evaluation_times=[1.0]),
            time=1.0,
            value=[0.25, 0.75],
        )
        out = res._to_abstract_repr()
        return [out["atom_order"], out["total_duration"], list(out["tagmap"]), list(out["results"].values())]

    assert outcome(case, TORCH)[1] == outcome(case, JAX)[1]
