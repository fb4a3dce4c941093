"""The JSON layer: the port against pulser_tpu, payload by payload.

Each case is a function of a package namespace (``tests/torch_parity.py``:
:data:`JAX` or :data:`TORCH`). The abstract representation carries no
module names, so the two packages must write equal strings, and each must
load the other's string and write it back unchanged (a payload with
random observable tags is compared after one load: JAX writes J, the port
loads J and writes J' == J). A loaded sequence's samples equal the direct
build's bit for bit. The legacy format (``_serialize``) names modules, so
its strings compare after the module root is normalized. Error cases of
the JAX package's own JSON tests run through both packages and must raise
the same exception types with the same messages
(``torch_parity.assert_parity``). The last tests pin the payloads that
``chip_smoke.py`` sends and validate them with both validators.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import re
import uuid
import warnings
from unittest.mock import patch

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import pulser_tpu as tpu

import pulser_tpu_torch as ptt

import chip_smoke
from test_torch_sampler import samples_facts
from test_torch_sequence import SCENARIOS, _rng, assert_same
from test_torch_sequence_diff import _mod_device
from torch_parity import JAX, TORCH, assert_parity

torch.set_num_threads(1)

#: The modules the cases reach through ``ns.pkg`` in both packages.
for _root in ("pulser_tpu", "pulser_tpu_torch"):
    for _module in (
        "abstract_repr",
        "json.abstract_repr.backend",
        "json.abstract_repr.deserializer",
        "json.abstract_repr.serializer",
        "json.abstract_repr.validation",
        "json.coders",
        "json.supported",
        "json.utils",
        "parametrized.decorators",
        "register.special_layouts",
        "sequence._call",
    ):
        importlib.import_module(f"{_root}.{_module}")


def _json(ns):
    """The JSON layer of the package behind ``ns``."""
    return ns.pkg.json


def _ser(ns):
    return ns.pkg.json.abstract_repr.serializer


def _de(ns):
    return ns.pkg.json.abstract_repr.deserializer


def _normalized(legacy: str) -> str:
    """A legacy payload with the port's module root written as the JAX
    package's."""
    return legacy.replace("pulser_tpu_torch", "pulser_tpu")


@contextlib.contextmanager
def _quiet():
    """Ignores warnings for the duration of a block."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def _both(case, seed: int = 1234) -> tuple:
    """``case`` run in the JAX package and in the port (raw values, the
    numpy global RNG seeded, warnings ignored)."""
    out = []
    for ns in (JAX, TORCH):
        np.random.seed(seed)
        with _quiet():
            out.append(case(ns))
    return tuple(out)


def _assert_cross(jax_str: str, port_str: str, load) -> None:
    """Each package loads the other's string and writes it back
    unchanged; ``load(ns, s)`` returns the string ``ns`` writes back."""
    with _quiet():
        assert load(TORCH, jax_str) == jax_str
        assert load(JAX, port_str) == port_str


# -- sequences ----------------------------------------------------------


#: chip_smoke.py's sequence builders, each a function of a package root.
BUILDERS = {
    "AFM16": chip_smoke.afm16_sequence,
    "TRI16": lambda P: chip_smoke.tri16_build(P),
    "TRI16_direct": lambda P: chip_smoke.tri16_build(P, direct=True),
    "XY16": chip_smoke.xy16_build,
    **{
        name.upper(): (lambda fn: lambda P: fn(P)[0])(
            getattr(chip_smoke, f"{name}_sequence")
        )
        for name in (
            "noisy10", "regnoise10", "pauli10", "spd10", "deph10",
            "mesolve10", "eff8", "relax10", "mcdepol10",
        )
    },
}

SEQUENCES = {
    **{name: (lambda fn: lambda P: fn(P, _rng(31)))(fn)
       for name, fn in SCENARIOS.items()},
    **BUILDERS,
}


def _load_sequence(ns, s: str) -> str:
    return ns.pkg.Sequence.from_abstract_repr(s).to_abstract_repr()


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_sequence_abstract_repr_parity(name):
    """Every scenario and every chip_smoke.py sequence: equal strings,
    loaded by the other package and written back unchanged."""
    build = SEQUENCES[name]
    out = assert_parity(lambda ns: build(ns.pkg).to_abstract_repr())
    if out[0] == "raise":
        # Both packages refuse a built parametrized sequence whose
        # target is a 0-d array (ROADMAP Queue 3)
        assert name == "parametrized" and out[1] == "TypeError"
        return
    jax_str, port_str = _both(lambda ns: build(ns.pkg).to_abstract_repr())
    assert port_str == jax_str
    _assert_cross(jax_str, port_str, _load_sequence)


def _loaded_facts(seq) -> dict:
    """The samples of ``seq`` (of either package) as ``samples_facts``
    reads them, up to orders the wire does not keep: the list of channels
    (a DMM channel configured before the global one is declared after it
    on a load) and the order of a detuning map's traps (written
    sorted)."""
    P = ptt if isinstance(seq, ptt.Sequence) else tpu
    facts = samples_facts(P.sampler.sample(seq))
    facts["channels"] = sorted(facts["channels"])
    for ch in facts["per_channel"].values():
        if "dmm" in ch:
            coords, weights, qubits = ch["dmm"]
            order = np.lexsort(coords.T[::-1])
            ch["dmm"] = (coords[order], [weights[i] for i in order], qubits)
    return facts


#: Scenarios whose detuning map has weights with more decimals than the
#: wire keeps (``weight_maps.WEIGHT_PRECISION``): their loaded DMM
#: samples differ from the direct build's by that rounding, in both
#: packages.
WEIGHTS_ROUNDED = ("dmm_detuning",)


def _assert_close_tree(a, b, where: str) -> None:
    """``a`` and ``b`` equal but for the rounding of detuning-map weights
    to 6 decimals (relative 1e-5)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_close_tree(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)) and not (
        a and all(isinstance(x, (int, float)) for x in a)
    ):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_close_tree(x, y, f"{where}[{i}]")
    elif isinstance(a, (str, bool, type(None))):
        assert a == b, where
    else:
        assert np.allclose(a, b, rtol=1e-5, atol=1e-9), where


@pytest.mark.parametrize("name", [n for n in SEQUENCES if n != "parametrized"])
def test_loaded_sequence_samples_bit_equal(name):
    """A sequence loaded from its own string and from the JAX package's:
    every channel's samples, slots and EOM blocks, the durations and the
    measurement equal to the direct build's, bit for bit (and to the JAX
    package's load of the same string), but for the wire's rounding of
    detuning-map weights (:data:`WEIGHTS_ROUNDED`)."""
    build = SEQUENCES[name]
    with _quiet():
        direct = build(ptt)
        jax_str = build(tpu).to_abstract_repr()
        loaded = [
            ptt.Sequence.from_abstract_repr(s)
            for s in (direct.to_abstract_repr(), jax_str)
        ]
        jax_loaded = _loaded_facts(tpu.Sequence.from_abstract_repr(jax_str))
        want = _loaded_facts(direct)
        for seq in loaded:
            assert seq.get_duration() == direct.get_duration()
            assert seq.is_measured() == direct.is_measured()
            got = _loaded_facts(seq)
            assert_same(got, jax_loaded, name)
            if name in WEIGHTS_ROUNDED:
                assert not np.array_equal(
                    got["per_channel"]["dmm_0"]["dmm"][1],
                    want["per_channel"]["dmm_0"]["dmm"][1],
                )
                _assert_close_tree(got, want, name)
            else:
                assert_same(got, want, name)


def _parametrized(P):
    """The ``parametrized`` scenario before its build."""
    reg = P.Register.square(2, spacing=6.0, prefix="q")
    seq = P.Sequence(reg, P.DigitalAnalogDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.declare_channel("ram", "raman_local", initial_target="q0")
    omega = seq.declare_variable("omega", dtype=float)
    dets = seq.declare_variable("dets", size=2, dtype=float)
    dur = seq.declare_variable("dur", dtype=int)
    tgt = seq.declare_variable("tgt", dtype=int)
    seq.add(
        P.Pulse.ConstantDetuning(
            P.BlackmanWaveform(dur * 4, omega / 4), dets[0], 0.0
        ),
        "ryd",
    )
    seq.add(
        P.Pulse.ConstantAmplitude(
            omega * 2, P.RampWaveform(dur, dets[0], dets[1]), 0.5
        ),
        "ram",
    )
    seq.target_index(tgt, "ram")
    seq.delay(dur // 2, "ram")
    seq.phase_shift_index(dets[1] / 4, tgt)
    seq.add(
        P.Pulse.ConstantPulse(dur, omega, -dets[1], np.sqrt(omega)), "ram"
    )
    seq.measure("digital")
    return seq


PARAM_VALUES = [
    dict(omega=2.5, dets=[-1.5, 3.25], dur=40, tgt=2),
    dict(omega=1.25, dets=[0.5, -2.0], dur=52, tgt=1),
]
PARAM_DEFAULTS = dict(omega=[2.0], dets=[1.0, -1.0], dur=[48], tgt=[3])


@pytest.mark.parametrize("defaults", [False, True])
def test_parametrized_sequence(defaults):
    """A parametrized sequence: the same string (with or without the
    variables' defaults), the same variables after a load, and
    ``build(...)`` after a load equal to ``build(...)`` before it."""
    kwargs = PARAM_DEFAULTS if defaults else {}
    jax_str, port_str = _both(
        lambda ns: _parametrized(ns.pkg).to_abstract_repr(**kwargs)
    )
    assert port_str == jax_str
    with _quiet():
        seq = _parametrized(ptt)
        loaded = ptt.Sequence.from_abstract_repr(jax_str)
        assert loaded.is_parametrized()
        assert {
            n: (v.dtype, v.size) for n, v in loaded.declared_variables.items()
        } == {n: (v.dtype, v.size) for n, v in seq.declared_variables.items()}
        assert loaded.to_abstract_repr(**kwargs) == jax_str
        for values in PARAM_VALUES:
            before, after = seq.build(**values), loaded.build(**values)
            assert str(after) == str(before)
            assert_same(
                samples_facts(ptt.sample(after)),
                samples_facts(ptt.sample(before)),
                str(values),
            )


# -- devices, registers, layouts, noise ----------------------------------


DEVICE_NAMES = [
    name
    for name in ptt.devices.__all__
    if name not in ("Device", "VirtualDevice")
]


def _device_load(ns, s: str) -> str:
    dev = ns.pkg.devices.VirtualDevice.from_abstract_repr(s)
    if not json.loads(s)["is_virtual"]:
        dev = ns.pkg.devices.Device.from_abstract_repr(s)
    return dev.to_abstract_repr()


@pytest.mark.parametrize("name", DEVICE_NAMES + ["ModDevice"])
def test_device_abstract_repr_parity(name):
    """Every device of the package (and a maximal one): equal strings,
    each loads the other's, and a load equals the device."""

    def device(ns):
        if name == "ModDevice":
            return _mod_device(ns.pkg)
        return getattr(ns.pkg.devices, name)

    assert_parity(lambda ns: device(ns).to_abstract_repr())
    jax_str, port_str = _both(lambda ns: device(ns).to_abstract_repr())
    assert port_str == jax_str
    _assert_cross(jax_str, port_str, _device_load)
    dev = device(TORCH)
    cls = type(dev)
    assert cls.from_abstract_repr(jax_str) == dev


def _layouts(P) -> dict:
    sl = P.register.special_layouts
    return {
        "RegisterLayout": P.register.RegisterLayout(
            [[0, 0], [6, 0], [0, 6.5], [6.25, 6]], slug="four"
        ),
        "TriangularLatticeLayout": sl.TriangularLatticeLayout(61, 5),
        "SquareLatticeLayout": sl.SquareLatticeLayout(3, 4, 5.5),
        "RectangularLatticeLayout": sl.RectangularLatticeLayout(
            2, 3, 4.0, 6.0
        ),
        "3D": P.register.RegisterLayout([[0, 0, 0], [5, 0, 1.5], [0, 5, 3.0]]),
    }


@pytest.mark.parametrize("name", list(_layouts(ptt)))
def test_layout_abstract_repr_parity(name):
    jax_str, port_str = _both(lambda ns: _layouts(ns.pkg)[name].to_abstract_repr())
    assert port_str == jax_str
    _assert_cross(
        jax_str,
        port_str,
        lambda ns, s: ns.pkg.register.RegisterLayout.from_abstract_repr(s)
        .to_abstract_repr(),
    )


def _registers(P) -> dict:
    layout = _layouts(P)["TriangularLatticeLayout"]
    return {
        "square": P.Register.square(3, spacing=5.0, prefix="q"),
        "from_layout": layout.define_register(3, 7, 11, 20),
        "hexagonal": layout.hexagonal_register(7),
        "3D": P.Register3D.cuboid(2, 2, 2, spacing=6.0, prefix="a"),
        "3D_layout": _layouts(P)["3D"].define_register(0, 2),
    }


@pytest.mark.parametrize("name", list(_registers(ptt)))
def test_register_abstract_repr_parity(name):
    jax_str, port_str = _both(lambda ns: _registers(ns.pkg)[name].to_abstract_repr())
    assert port_str == jax_str

    def load(ns, s):
        cls = ns.pkg.Register3D if "3D" in name else ns.pkg.Register
        reg = cls.from_abstract_repr(s)
        assert reg == _registers(ns.pkg)[name]
        return reg.to_abstract_repr()

    _assert_cross(jax_str, port_str, load)


def _encoded(ns, obj) -> str:
    return json.dumps(obj, cls=_ser(ns).AbstractReprEncoder)


def test_mappable_register_and_detuning_map_parity():
    """A ``MappableRegister`` and a ``DetuningMap`` (written inside a
    sequence, and on their own by the encoder)."""

    def case(ns):
        layout = _layouts(ns.pkg)["RegisterLayout"]
        mreg = layout.make_mappable_register(2)
        dmap = layout.define_detuning_map({0: 0.5, 1: 0.25, 3: 1.0})
        seq = ns.pkg.Sequence(mreg, ns.pkg.MockDevice)
        seq.declare_channel("ryd", "rydberg_global")
        seq.config_detuning_map(dmap, "dmm_0")
        seq.add(ns.pkg.Pulse.ConstantPulse(100, 1.0, 0.0, 0.0), "ryd")
        seq.add_dmm_detuning(ns.pkg.RampWaveform(100, -2.0, 0.0), "dmm_0")
        return [
            _encoded(ns, mreg),
            _encoded(ns, dmap),
            seq.to_abstract_repr(qubits={"q0": 2, "q1": 0}),
            seq.to_abstract_repr(),
        ]

    jax_out, port_out = _both(case)
    assert port_out == jax_out
    _assert_cross(jax_out[3], port_out[3], _load_sequence)
    _assert_cross(
        jax_out[2],
        port_out[2],
        lambda ns, s: ns.pkg.Sequence.from_abstract_repr(s).to_abstract_repr(
            qubits={"q0": 2, "q1": 0}
        ),
    )


def _noise_models(P) -> dict:
    models = {
        name.upper(): getattr(chip_smoke, f"{name}_sequence")(P)[1]
        for name in (
            "noisy10", "regnoise10", "pauli10", "spd10", "deph10", "eff8",
            "relax10", "mcdepol10",
        )
    }
    models.update(
        default=P.NoiseModel(),
        leakage=P.NoiseModel(
            eff_noise_rates=(0.1,),
            eff_noise_opers=(np.diag([1.0, 0.0, 0.0]),),
            with_leakage=True,
        ),
        detuning=P.NoiseModel(
            detuning_sigma=0.5,
            detuning_hf_psd=(1.0, 0.5),
            detuning_hf_omegas=(2.0, 4.0),
            runs=5,
            samples_per_run=1,
        ),
        doppler_disabled=P.NoiseModel(
            temperature=30.0, disable_doppler=True, amp_sigma=0.1,
            laser_waist=100.0, runs=3, samples_per_run=1,
        ),
    )
    return models


@pytest.mark.parametrize("name", list(_noise_models(ptt)))
def test_noise_model_abstract_repr_parity(name):
    jax_str, port_str = _both(
        lambda ns: _noise_models(ns.pkg)[name].to_abstract_repr()
    )
    assert port_str == jax_str

    def load(ns, s):
        noise = ns.pkg.NoiseModel.from_abstract_repr(s)
        assert noise == _noise_models(ns.pkg)[name]
        return noise.to_abstract_repr()

    _assert_cross(jax_str, port_str, load)


def test_top_level_abstract_repr_module():
    """``pulser_tpu_torch.abstract_repr``'s five aliases, as the JAX
    package's."""
    ar, impl = ptt.abstract_repr, _de(TORCH)
    assert ar.__all__ == tpu.abstract_repr.__all__
    assert ar.deserialize_sequence is impl.deserialize_abstract_sequence
    assert ar.deserialize_layout is impl.deserialize_abstract_layout
    assert ar.deserialize_register is impl.deserialize_abstract_register
    assert ar.deserialize_noise_model is impl.deserialize_abstract_noise_model
    assert ar.deserialize_device is impl.deserialize_device
    dev = ar.deserialize_device(tpu.DigitalAnalogDevice.to_abstract_repr())
    assert dev == ptt.DigitalAnalogDevice


# -- configs and results --------------------------------------------------


def _state(ns, eigenstates=("r", "g"), amplitudes=None):
    return ns.backend.StateRepr.from_state_amplitudes(
        eigenstates=eigenstates,
        amplitudes=amplitudes or {"rgr": 1.0j + 0.2, "grg": 0.22j},
    )


def _operator(ns):
    return ns.backend.OperatorRepr.from_operator_repr(
        eigenstates=("r", "g"),
        n_qudits=3,
        operations=[(0.3, [({"rr": 0.2j, "gg": 1.0}, [0, 2])])],
    )


def _configs(ns) -> dict:
    obs = ns.obs
    noise = chip_smoke.noisy10_sequence(ns.pkg)[1]
    return {
        "NOISY10": chip_smoke.wire_noisy10_config(noise, ns.pkg),
        "all_observables": ns.config.EmulationConfig(
            observables=[
                obs.BitStrings(num_shots=211, one_state="r", tag_suffix="7"),
                obs.CorrelationMatrix(one_state="r"),
                obs.Occupation(one_state="g"),
                obs.Energy(evaluation_times=[0.0, 0.5]),
                obs.EnergyVariance(evaluation_times=np.linspace(0, 1, 5)),
                obs.EnergySecondMoment(),
                obs.Fidelity(_state(ns)),
                obs.Expectation(
                    _operator(ns),
                    default_aggregation_method=(
                        ns.pkg.backend.AggregationMethod.SKIP
                    ),
                ),
            ],
            default_evaluation_times="Full",
            initial_state=_state(ns),
            with_modulation=True,
            prefer_device_noise_model=True,
            interaction_matrix=[[0.0, 0.5, 0.1], [0.5, 0.0, 0.2],
                                [0.1, 0.2, 0.0]],
            max_bond_dim=10,
        ),
        "backend_config": ns.Config(
            observables=[obs.Occupation(), obs.Energy()],
            noise_model=ns.pkg.NoiseModel(dephasing_rate=0.1),
            default_evaluation_times=[0.25, 1.0],
            **ns.kw,
        ),
    }


@pytest.mark.parametrize("name", ["NOISY10", "all_observables", "backend_config"])
def test_config_abstract_repr_after_one_load(name):
    """An ``EmulationConfig`` (and the backend's own config, whose torch
    device stays off the wire): JAX writes J, the port loads J and writes
    J' == J; the port writes P, JAX loads P and writes P' == P."""

    def load(ns, s):
        cls = type(_configs(ns)[name])
        return cls.from_abstract_repr(s).to_abstract_repr()

    with _quiet():
        jax_str = _configs(JAX)[name].to_abstract_repr()
        port_str = _configs(TORCH)[name].to_abstract_repr()
    _assert_cross(jax_str, port_str, load)
    tags = re.compile(r'"uuid": "[0-9a-f-]+"')
    assert tags.sub("", port_str) == tags.sub("", jax_str)
    if name == "backend_config":
        assert "torch_device" not in port_str


def _stored_results(ns, tensor: bool):
    """A ``Results`` with stored values of every payload type (as the JAX
    package's ``test_result_serialization``): arrays as the package's
    tensors where ``tensor``."""
    obs = ns.obs
    bitstrings, corr = obs.BitStrings(), obs.CorrelationMatrix()
    energy, occ = obs.Energy(), obs.Occupation()
    for i, o in enumerate((bitstrings, corr, energy, occ)):
        o._uuid = uuid.UUID(int=i + 1)
    results = ns.results.Results(atom_order=("a", "b"), total_duration=100)
    rng = np.random.default_rng(7)
    cor_mat = rng.normal(size=(6, 6))
    occ_vec = rng.normal(size=6).astype(complex)
    occ_vec[0] += 1j
    if tensor:
        as_tensor = jnp.asarray if ns is JAX else torch.as_tensor
        cor_mat, occ_vec = as_tensor(cor_mat), as_tensor(occ_vec)
    results._store(observable=bitstrings, time=0.1, value="rgrgrg")
    results._store(observable=corr, time=0.2, value=cor_mat)
    results._store(observable=energy, time=0.3, value=5.0)
    results._store(observable=occ, time=0.4, value=occ_vec)
    return results


def _results_load(ns, s: str) -> str:
    return ns.results.Results.from_abstract_repr(s).to_abstract_repr()


@pytest.mark.parametrize("tensor", [False, True])
def test_stored_results_parity(tensor):
    jax_str, port_str = _both(lambda ns: _stored_results(ns, tensor).to_abstract_repr())
    assert port_str == jax_str
    _assert_cross(jax_str, port_str, _results_load)


def _tiny_run(ns):
    """A tiny backend run on the CPU: 3 atoms, states and occupations at
    two times, the energy and 50 shots."""
    P = ns.pkg
    seq = P.Sequence(
        P.Register.rectangle(1, 3, spacing=6.0, prefix="q"), P.MockDevice
    )
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(P.Pulse.ConstantPulse(300, 2.0, -1.0, 0.0), "ryd")
    obs = ns.obs
    config = ns.Config(
        observables=[
            obs.Occupation(evaluation_times=[0.5, 1.0]),
            obs.Energy(evaluation_times=[1.0]),
            obs.BitStrings(evaluation_times=[1.0], num_shots=50),
            obs.CorrelationMatrix(evaluation_times=[1.0]),
        ],
        **ns.kw,
    )
    return ns.BackendV2(seq, config=config).run()


def test_backend_run_results():
    """The ``Results`` of a tiny backend run in each package: each loads
    the other's string and writes it back unchanged, and the two runs'
    values agree (the states differ by rounding, so the strings are not
    compared directly)."""
    assert_parity(lambda ns: _tiny_run(ns), tol=1e-9)
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        jax_str, port_str = _both(lambda ns: _tiny_run(ns).to_abstract_repr())
    finally:
        torch.set_default_dtype(old)
    _assert_cross(jax_str, port_str, _results_load)
    back = ptt.backend.Results.from_abstract_repr(jax_str)
    assert set(back.get_result_tags()) == set(json.loads(jax_str)["tagmap"])


# -- the legacy format ----------------------------------------------------


LEGACY = {
    name: SEQUENCES[name]
    for name in ("global_local", "eom_mode", "dmm_detuning", "slm_mask",
                 "xy_field", "truncated", "mappable", "new_register",
                 "AFM16", "TRI16", "NOISY10")
}
LEGACY["parametrized"] = _parametrized


def _legacy_load(ns, s: str) -> str:
    return ns.pkg.Sequence._deserialize(s)._serialize()


@pytest.mark.parametrize("name", list(LEGACY))
def test_legacy_serialize_parity(name):
    """``_serialize``: equal after the module root is normalized; the port
    loads the JAX package's string, and the JAX package loads the port's
    once its root is normalized (the JAX package knows no
    ``pulser_tpu_torch`` module); both write back what the JAX package
    writes back from its own string."""
    jax_str, port_str = _both(lambda ns: LEGACY[name](ns.pkg)._serialize())
    assert '"pulser_tpu_torch.' in port_str
    assert _normalized(port_str) == jax_str
    with _quiet():
        # What the JAX package writes back from its own string (a
        # sequence built from a mappable register comes back with its
        # arguments as keywords)
        want = _legacy_load(JAX, jax_str)
        assert _normalized(_legacy_load(TORCH, jax_str)) == want
        assert _legacy_load(JAX, _normalized(port_str)) == want


def test_legacy_payloads_of_the_reference_and_the_jax_package():
    """A payload naming ``pulser.*`` (the reference's) or
    ``pulser_tpu.*`` (the JAX package's) modules decodes into the port's
    classes."""
    with _quiet():
        jax_str = SEQUENCES["global_local"](tpu)._serialize()
        for payload in (jax_str, jax_str.replace('"pulser_tpu.', '"pulser.')):
            seq = ptt.Sequence._deserialize(payload)
            assert type(seq) is ptt.Sequence
            assert type(seq.device) is ptt.devices.Device
            assert seq._serialize() == jax_str.replace(
                '"pulser_tpu.', '"pulser_tpu_torch.'
            )


# -- error cases of the JAX package's JSON tests ---------------------------


def _serialized_seq(ns, operations=(), variables=None, **overrides) -> dict:
    """The hand-built sequence payload of the JAX package's
    ``test_abstract_repr_violations.py``."""
    seq_dict = {
        "version": "1",
        "name": "John Doe",
        "device": json.loads(ns.pkg.DigitalAnalogDevice.to_abstract_repr()),
        "register": [
            {"name": "q0", "x": 0.0, "y": 2.0},
            {"name": "q42", "x": -2.0, "y": 9.0},
            {"name": "q666", "x": 12.0, "y": 0.0},
        ],
        "channels": {"digital": "raman_local", "global": "rydberg_global"},
        "operations": list(operations),
        "variables": variables or {},
        "measurement": None,
        "pulser_version": ns.pkg.__version__,
    }
    seq_dict.update(overrides)
    return seq_dict


def _load(ns, payload: dict, validate: bool = True) -> str:
    """Loads a hand-built payload (with the schema check bypassed unless
    ``validate``) and writes it back."""
    s = json.dumps(payload)
    if validate:
        return _load_sequence(ns, s)
    with patch.object(_de(ns), "validate_abstract_repr"):
        return ns.pkg.Sequence.from_abstract_repr(s).to_abstract_repr(
            skip_validation=True
        )


def _pulse_op(amplitude, detuning, **extra) -> dict:
    return {
        "op": "pulse", "channel": "global", "phase": 1,
        "post_phase_shift": 2, "protocol": "min-delay",
        "amplitude": amplitude, "detuning": detuning, **extra,
    }


def _const(value, duration=1000) -> dict:
    return {"kind": "constant", "duration": duration, "value": value}


VAR1 = {"variable": "var1"}
IDX1 = {"expression": "index", "lhs": VAR1, "rhs": 0}
EXPRESSIONS = [
    {"expression": "neg", "lhs": VAR1},
    {"expression": "abs", "lhs": IDX1},
    {"expression": "ceil", "lhs": VAR1},
    {"expression": "floor", "lhs": IDX1},
    {"expression": "sqrt", "lhs": IDX1},
    {"expression": "exp", "lhs": IDX1},
    {"expression": "log", "lhs": IDX1},
    {"expression": "log2", "lhs": VAR1},
    {"expression": "sin", "lhs": VAR1},
    {"expression": "cos", "lhs": IDX1},
    {"expression": "tan", "lhs": VAR1},
    {"expression": "index", "lhs": VAR1, "rhs": 0},
    {"expression": "index", "lhs": {"variable": "var2"}, "rhs": [0, 2]},
    {"expression": "add", "lhs": IDX1, "rhs": 2.0},
    {"expression": "sub", "lhs": VAR1, "rhs": 1.0},
    {"expression": "mul", "lhs": VAR1, "rhs": 3.0},
    {"expression": "div", "lhs": IDX1, "rhs": 2.0},
    {"expression": "pow", "lhs": VAR1, "rhs": 2.0},
    {"expression": "mod", "lhs": VAR1, "rhs": 2.0},
]
EXPR_VARIABLES = {
    "var1": {"type": "float", "value": [1.5]},
    "var2": {"type": "int", "value": [0, 1, 2, 3, 4]},
}


def _seq_with_amp(ns):
    P = ns.pkg
    seq = P.Sequence(P.Register.square(2, prefix="q"), P.DigitalAnalogDevice)
    seq.declare_channel("ch0", "rydberg_global")
    amp = seq.declare_variable("amp", dtype=float)
    seq.add(P.Pulse.ConstantPulse(100, amp, 0, 0), "ch0")
    return seq


def _unknown_call(ns, name, args, kwargs):
    P = ns.pkg
    seq = P.Sequence(P.Register.square(2, prefix="q"), P.DigitalAnalogDevice)
    seq.declare_channel("ch0", "rydberg_global")
    seq._calls.append(P.sequence._call._Call(name, args, kwargs))
    return seq.to_abstract_repr()


VIOLATIONS = {
    "signature-none": lambda ns: _ser(ns).abstract_repr("FakeWaveform", 100, 1),
    "signature-not_enough": lambda ns: _ser(ns).abstract_repr(
        "ConstantWaveform", 1000
    ),
    "signature-too_many": lambda ns: _ser(ns).abstract_repr(
        "ConstantWaveform", 1000, 1, 4
    ),
    "signature-bad_keyword": lambda ns: _ser(ns).abstract_repr(
        "ConstantWaveform", 1000, 1, foo=0
    ),
    "signature-spill": lambda ns: _ser(ns).abstract_repr(
        "KaiserWaveform", 1000, np.pi, 10.0
    ),
    "signature-spill_taken": lambda ns: _ser(ns).abstract_repr(
        "KaiserWaveform", 1000, np.pi, 10.0, beta=5.0
    ),
    "signature-missing_as_keyword": lambda ns: _ser(ns).abstract_repr(
        "ConstantWaveform", 1000, value=2.0
    ),
    "register_name_collision": lambda ns: ns.pkg.Register(
        {"0": (0, 0), 0: (20, 20)}
    )._to_abstract_repr(),
    "interpolated_export": lambda ns: ns.pkg.InterpolatedWaveform(
        1000, [0, 1, 0], interpolator="interp1d"
    )._to_abstract_repr(),
    "invalid_defaults": lambda ns: _seq_with_amp(ns).to_abstract_repr(
        amp=-1.0
    ),
    "defaults_not_declared": lambda ns: _seq_with_amp(ns).to_abstract_repr(
        amp=1.0, foo=2.0
    ),
    "unknown_call-targets": lambda ns: _unknown_call(
        ns, "targets", ({"q0", "q1"}, "ch0"), {}
    ),
    "unknown_call-phase_shifts": lambda ns: _unknown_call(
        ns, "phase_shifts", (1.0, "q2", "q3"), dict(basis="ground-rydberg")
    ),
    "unknown_call-wait": lambda ns: _unknown_call(ns, "wait", (100,), {}),
    **{
        f"encoder-{key}": (lambda obj: lambda ns: _encoded(ns, obj(ns)))(obj)
        for key, obj in {
            "register": lambda ns: ns.pkg.Register({"q0": (0.0, 0.0)}),
            "np.array": lambda ns: np.arange(3),
            "set": lambda ns: {"a"},
            "np.float": lambda ns: np.float64(1.5),
            "np.int": lambda ns: np.int32(7),
            "real_complex": lambda ns: complex(1, 0),
            "complex": lambda ns: complex(1, 2),
            "tensor": lambda ns: (
                jnp.arange(3.0) if ns is JAX else torch.arange(3.0)
            ),
        }.items()
    },
    **{
        f"expression-{i}-{e['expression']}": (
            lambda e: lambda ns: _load(
                ns,
                _serialized_seq(
                    ns,
                    [_pulse_op(_const(2.0), _const(e))],
                    EXPR_VARIABLES,
                ),
            )
        )(e)
        for i, e in enumerate(EXPRESSIONS)
    },
    **{
        f"param-{key}-{'unchecked' if not validate else 'checked'}": (
            lambda param, validate: lambda ns: _load(
                ns,
                _serialized_seq(
                    ns, [{"op": "delay", "time": param, "channel": "global"}]
                ),
                validate,
            )
        )(param, validate)
        for key, param in {
            "bad_var": VAR1,
            "bad_param": {"abs": 1},
            "bad_exp": {"expression": "floordiv", "lhs": 0, "rhs": 0},
        }.items()
        for validate in (False, True)
    },
    **{
        f"unknown_waveform-{'checked' if validate else 'unchecked'}": (
            lambda validate: lambda ns: _load(
                ns,
                _serialized_seq(
                    ns,
                    [_pulse_op({"kind": "gaussian", "duration": 1000},
                               _const(1.0))],
                ),
                validate,
            )
        )(validate)
        for validate in (False, True)
    },
    "bad_top_level_type": lambda ns: ns.pkg.Sequence.from_abstract_repr(
        _serialized_seq(ns)
    ),
    **{
        f"missing-{key}": (
            lambda key: lambda ns: _load(
                ns,
                {k: v for k, v in _serialized_seq(ns).items() if k != key},
            )
        )(key)
        for key in ("register", "channels", "operations", "variables",
                    "device")
    },
    **{
        f"invalid_op-{key}": (
            lambda op: lambda ns: _load(ns, _serialized_seq(ns, [op]))
        )(op)
        for key, op in {
            "negative_delay": {"op": "delay", "time": -5, "channel": "global"},
            "unknown_channel": {
                "op": "delay", "time": 100, "channel": "nonexistent",
            },
            "bad_target": {"op": "target", "target": 99, "channel": "digital"},
            "bad_protocol": _pulse_op(
                _const(1.0, 100), _const(0.0, 100), protocol="banana"
            ),
        }.items()
    },
    "not_json": lambda ns: ns.pkg.Sequence.from_abstract_repr("{nope"),
    "device-not_a_string": lambda ns: _de(ns).deserialize_device(1.0),
    "device-bad_json": lambda ns: _de(ns).deserialize_device("{}"),
    "device-virtual_as_device": lambda ns: ns.pkg.devices.Device.from_abstract_repr(
        ns.pkg.MockDevice.to_abstract_repr()
    ),
    "device-device_as_virtual": lambda ns: ns.pkg.devices.VirtualDevice.from_abstract_repr(
        ns.pkg.AnalogDevice.to_abstract_repr()
    ).to_abstract_repr(),
    "device-from_non_string": lambda ns: ns.pkg.devices.Device.from_abstract_repr(
        {}
    ),
    "register-expected_dim": lambda ns: ns.pkg.Register.from_abstract_repr(
        ns.pkg.Register3D.cuboid(2, 1, 1, prefix="q").to_abstract_repr()
    ),
    "register-bad_dim_argument": lambda ns: _de(ns).deserialize_abstract_register(
        ns.pkg.Register.square(1, prefix="q").to_abstract_repr(), expected_dim=4
    ),
    "register-not_a_string": lambda ns: ns.pkg.Register3D.from_abstract_repr(1),
    "layout-not_a_string": lambda ns: ns.pkg.register.RegisterLayout.from_abstract_repr(
        []
    ),
    "noise-not_a_string": lambda ns: ns.pkg.NoiseModel.from_abstract_repr(0),
    "noise-schema": lambda ns: ns.pkg.NoiseModel.from_abstract_repr(
        '{"noise_types": ["bogus"]}'
    ),
    "sequence-not_a_string": lambda ns: ns.pkg.Sequence._deserialize({}),
    "parametrized_schema_failure": lambda ns: _seq_with_amp(ns).to_abstract_repr(
        amp=1.0, json_dumps_options={"indent": 1}
    ),
    "interpolated_unknown_length": lambda ns: _interpolated_unknown(ns),
}


def _interpolated_unknown(ns):
    P = ns.pkg
    seq = P.Sequence(P.Register.square(1, prefix="q"), P.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    vals = seq.declare_variable("vals", size=3)
    wf = P.InterpolatedWaveform(1000, vals * 2)
    seq.add(P.Pulse.ConstantDetuning(wf, 0.0, 0.0), "ryd")
    return seq.to_abstract_repr()


@pytest.mark.parametrize("name", list(VIOLATIONS))
def test_abstract_repr_violation_parity(name):
    """The cases of ``tests/test_abstract_repr_violations.py`` (and the
    entry points' type checks): the same output, or the same exception
    type and message."""
    assert_parity(VIOLATIONS[name])


def _deserialize_test_params(cls_name: str, fn: str) -> list:
    """The payloads a test of ``tests/test_abstract_repr_deserialize.py``
    is parametrized with (read off its ``parametrize`` mark)."""
    import test_abstract_repr_deserialize as mod

    test = getattr(getattr(mod, cls_name), fn)
    (mark,) = [m for m in test.pytestmark if m.name == "parametrize"]
    names, values = mark.args[:2]
    return values


def _hand_built(ns, ops, variables=None, device="DigitalAnalogDevice"):
    payload = _serialized_seq(ns, ops, variables)
    payload["name"] = "pulser-exported"
    payload["device"] = json.loads(
        getattr(ns.pkg, device).to_abstract_repr()
    )
    return payload


HAND_BUILT = {
    **{
        f"op-{i}-{op['op']}": (
            lambda op: lambda ns: _load(
                ns, _hand_built(ns, [op], device="MockDevice")
            )
        )(op)
        for i, op in enumerate(
            _deserialize_test_params(
                "TestNonParametrizedOps", "test_op_becomes_expected_call"
            )
        )
    },
    **{
        f"waveform-{wf['kind']}": (
            lambda wf: lambda ns: _load(ns, _hand_built(ns, [_pulse_op(wf, wf)]))
        )(wf)
        for wf in _deserialize_test_params(
            "TestNonParametrizedWaveforms", "test_waveform_reconstruction"
        )
    },
    **{
        f"parametrized_op-{i}-{op['op']}": (
            lambda op: lambda ns: _load(
                ns,
                _hand_built(
                    ns,
                    [op],
                    {
                        "var1": {"type": "int", "value": [0]},
                        "var2": {"type": "int", "value": [44]},
                    },
                ),
            )
        )(op)
        for i, op in enumerate(
            _deserialize_test_params(
                "TestParametrizedOps", "test_parametrized_op_becomes_deferred_call"
            )
        )
    },
    **{
        f"fold-{cls}": (
            lambda amp, det: lambda ns: _load(
                ns,
                _hand_built(
                    ns,
                    [
                        _pulse_op(
                            amp, det,
                            phase={"expression": "index",
                                   "lhs": {"variable": "var1"}, "rhs": 0},
                        )
                    ],
                    {
                        "var1": {"type": "int", "value": [0]},
                        "var2": {"type": "int", "value": [42]},
                    },
                ),
            )
        )(amp, det)
        for amp, det, cls in _deserialize_test_params(
            "TestParametrizedOps", "test_zero_duration_constants_fold"
        )
    },
}


@pytest.mark.parametrize("name", list(HAND_BUILT))
def test_hand_built_payload_parity(name):
    """The hand-built payloads of
    ``tests/test_abstract_repr_deserialize.py``: each package loads them
    and writes the same string back."""
    assert_parity(HAND_BUILT[name])


def _encode(ns, obj) -> str:
    return json.dumps(obj, cls=_json(ns).coders.PulserEncoder)


def _decode(ns, s: str):
    return json.loads(s, cls=_json(ns).coders.PulserDecoder)


def _round_trip(ns, make) -> list:
    """``make(ns)`` through the legacy encoder and decoder: the
    normalized string, whether the decoded object equals the original,
    and the decoded object's class name."""
    obj = make(ns)
    s = _encode(ns, obj)
    back = _decode(ns, s)
    same = obj == back
    if isinstance(same, np.ndarray):
        same = bool(same.all())
    return [_normalized(s), bool(same), type(back).__name__]


def _rare_cases(ns):
    P = ns.pkg
    seq = P.Sequence(P.Register.square(4, prefix="q"), P.DigitalAnalogDevice)
    var = seq.declare_variable("var")
    wf = P.BlackmanWaveform(var * 100 // 10, var)
    s = _encode(ns, wf)
    wf_ = _decode(ns, s)
    wf_._variables["var"]._assign(10)
    return [_normalized(s), str(wf_.build())]


def _support(ns, step: int):
    P = ns.pkg
    seq = P.Sequence(P.Register.square(2, prefix="q"), P.DigitalAnalogDevice)
    var = seq.declare_variable("var")
    obj_dict = P.BlackmanWaveform.from_max_val(1, var)._to_dict()
    validate = _json(ns).supported.validate_serialization
    del obj_dict["__module__"]
    if step == 0:
        return validate(obj_dict)
    obj_dict["__module__"] = "pulser.fake"
    if step == 1:
        return validate(obj_dict)
    wf_obj_dict = obj_dict["__args__"][0]
    wf_obj_dict["__submodule__"] = "RampWaveform"
    if step == 2:
        return validate(wf_obj_dict)
    del wf_obj_dict["__submodule__"]
    return validate(wf_obj_dict)


def _mappable_legacy(ns):
    P = ns.pkg
    layout = P.register.RegisterLayout([[0, 0], [1, 1], [1, 0], [0, 1]])
    mapp_reg = layout.make_mappable_register(2)
    back = _decode(ns, _encode(ns, mapp_reg))
    seq = P.Sequence(mapp_reg, P.MockDevice)
    mapped = seq.build(qubits={"q0": 2, "q1": 1})
    new = P.Sequence._deserialize(mapped._serialize())
    return [back.layout == layout, back.qubit_ids,
            new.is_register_mappable()]


def _register_from_layout(ns):
    P = ns.pkg
    layout = P.register.RegisterLayout([[0, 0], [1, 1], [1, 0], [0, 1]])
    reg = layout.define_register(1, 0)
    new_reg = _decode(ns, _encode(ns, P.Sequence(reg, P.MockDevice))).register
    return [reg == new_reg, new_reg.layout == layout,
            new_reg._layout_info.trap_ids]


CODERS = {
    "encoder-arange": lambda ns: _round_trip(ns, lambda ns: np.arange(10)),
    "encoder-set": lambda ns: _round_trip(ns, lambda ns: set(range(5))),
    "encoder-complex": lambda ns: _encode(ns, 1j),
    "device": lambda ns: _round_trip(ns, lambda ns: ns.pkg.DigitalAnalogDevice),
    "device-modified": lambda ns: _encode(
        ns, dataclasses.replace(ns.pkg.DigitalAnalogDevice, name="ModDevice")
    ),
    "virtual_device": lambda ns: _round_trip(ns, lambda ns: ns.pkg.MockDevice),
    "virtual_device-modified": lambda ns: _round_trip(
        ns,
        lambda ns: dataclasses.replace(
            ns.pkg.DigitalAnalogDevice, name="ModDevice"
        ).to_virtual(),
    ),
    "register_2d": lambda ns: _decode(
        ns,
        _encode(
            ns,
            ns.pkg.Sequence(
                ns.pkg.Register({"c": (1, 2), "d": (8, 4)}),
                ns.pkg.DigitalAnalogDevice,
            ),
        ),
    ).register.to_abstract_repr(),
    "register_3d": lambda ns: _decode(
        ns,
        _encode(
            ns,
            ns.pkg.Sequence(
                ns.pkg.Register3D({"a": (1, 2, 3), "b": (8, 5, 6)}),
                ns.pkg.MockDevice,
            ),
        ),
    ).register.to_abstract_repr(),
    **{
        f"layout-{name}": (
            lambda name: lambda ns: _round_trip(
                ns, lambda ns: _layouts(ns.pkg)[name]
            )
        )(name)
        for name in ("RegisterLayout", "TriangularLatticeLayout",
                     "SquareLatticeLayout", "RectangularLatticeLayout")
    },
    "register_from_layout": _register_from_layout,
    "detuning_map": lambda ns: _round_trip(
        ns,
        lambda ns: ns.pkg.register.weight_maps.DetuningMap(
            [[0, 0], [1, 1], [1, 0], [0, 1]], [0.1, 0.2, 0.3, 0.4]
        ),
    ),
    "numbered_keys-2d": lambda ns: _round_trip(
        ns, lambda ns: ns.pkg.Register(dict(enumerate([(2, 3), (5, 1), (10, 0)])))
    ),
    "numbered_keys-3d": lambda ns: _round_trip(
        ns,
        lambda ns: ns.pkg.Register3D({3: (2, 3, 4), 4: (3, 4, 5), 2: (4, 5, 7)}),
    ),
    "mappable_register": _mappable_legacy,
    "rare-call_of_parametrized": lambda ns: _encode(
        ns, ns.pkg.BlackmanWaveform(
            ns.pkg.Sequence(
                ns.pkg.Register.square(1, prefix="q"), ns.pkg.MockDevice
            ).declare_variable("var") * 10,
            1.0,
        )()
    ),
    "rare-not_a_string": lambda ns: ns.pkg.Sequence._deserialize(
        json.loads(_encode(ns, ns.pkg.BlackmanWaveform(100, 1.0)))
    ),
    "rare-not_a_sequence": lambda ns: ns.pkg.Sequence._deserialize(
        _encode(ns, ns.pkg.BlackmanWaveform(100, 1.0))
    ),
    "rare-build": _rare_cases,
    "rare-rotated_register": lambda ns: _encode(
        ns,
        ns.pkg.parametrized.decorators.parametrize(ns.pkg.Register.rotated)(
            ns.pkg.Register.square(2, prefix="q"),
            ns.pkg.Sequence(
                ns.pkg.Register.square(1, prefix="q"), ns.pkg.MockDevice
            ).declare_variable("var"),
        ),
    ),
    **{f"support-{step}": (lambda step: lambda ns: _support(ns, step))(step)
       for step in range(4)},
    "sequence_module": lambda ns: json.loads(
        ns.pkg.Sequence(
            ns.pkg.Register.square(2, prefix="q"), ns.pkg.DigitalAnalogDevice
        )._serialize()
    )["__module__"].replace("pulser_tpu_torch", "pulser_tpu"),
    "numpy-int": lambda ns: _decode(ns, _encode(ns, np.array([12])[0])),
    "numpy-float": lambda ns: _decode(ns, _encode(ns, np.array([np.pi])[0])),
    "numpy-str": lambda ns: _decode(ns, _encode(ns, np.array(["abc"])[0])),
    "make_json_compatible-int8": lambda ns: _json(ns).utils.make_json_compatible(
        np.arange(3, dtype=np.int8)
    ),
    "make_json_compatible-float16": lambda ns: _json(
        ns
    ).utils.make_json_compatible(np.linspace(0, 1, num=3, dtype=np.float16)),
    "make_json_compatible-complex": lambda ns: _json(
        ns
    ).utils.make_json_compatible(1j),
    **{
        f"kwargs_only_paramobj-{i}": (
            lambda kw: lambda ns: _normalized(
                _encode(
                    ns,
                    _decode(
                        ns,
                        _encode(ns, _kwargs_paramobj(ns, kw)),
                    ),
                )
            )
        )(kw)
        for i, kw in enumerate((False, True))
    },
}


def _kwargs_paramobj(ns, keywords: bool):
    P = ns.pkg
    dt = P.Sequence(
        P.Register.square(4, prefix="q"), P.DigitalAnalogDevice
    ).declare_variable("dt")
    if keywords:
        return P.BlackmanWaveform(duration=dt, area=2)
    return P.BlackmanWaveform(dt, 2)


@pytest.mark.parametrize("name", list(CODERS))
def test_legacy_coders_parity(name):
    """The cases of ``tests/test_json_coders.py``: the same normalized
    output, or the same exception type and message."""
    assert_parity(CODERS[name])


def _observable_payload(ns, make, with_uuid: bool):
    obs = make(ns)
    payload = json.loads(_encoded(ns, obs))
    if not with_uuid:
        payload.pop("uuid")
    back = _json(ns).abstract_repr.backend._deserialize_observable(
        payload, ns.backend.StateRepr, ns.backend.OperatorRepr
    )
    assert (back._uuid == obs._uuid) is with_uuid
    payload.pop("uuid", None)
    out = json.loads(_encoded(ns, back))
    out.pop("uuid")
    return [payload, out]


OBSERVABLES = {
    "bitstrings": lambda ns: ns.obs.BitStrings(
        evaluation_times=[i * 0.05 for i in range(10)], num_shots=211,
        one_state="r", tag_suffix="7",
    ),
    "bitstrings-default": lambda ns: ns.obs.BitStrings(),
    "correlation_matrix": lambda ns: ns.obs.CorrelationMatrix(one_state="r"),
    "occupation": lambda ns: ns.obs.Occupation(one_state="g"),
    "energy": lambda ns: ns.obs.Energy(
        evaluation_times=[i * 0.05 for i in range(10)]
    ),
    "energy_variance": lambda ns: ns.obs.EnergyVariance(
        evaluation_times=np.linspace(0, 1, 13)
    ),
    "energy_second_moment": lambda ns: ns.obs.EnergySecondMoment(
        evaluation_times=[i * 0.1 for i in range(5)]
    ),
    "fidelity": lambda ns: ns.obs.Fidelity(
        _state(ns, ("0", "1"), {"11": 0.1}),
        evaluation_times=[i / 7.2 for i in range(5)],
    ),
    "expectation": lambda ns: ns.obs.Expectation(
        _operator(ns), tag_suffix="my_op"
    ),
}


def _backend_errors(ns):
    backend = _json(ns).abstract_repr.backend
    return {
        "state_result": lambda: _encoded(ns, ns.obs.StateResult()),
        "unknown_observable": lambda: backend._deserialize_observable(
            dict(json.loads(_encoded(ns, ns.obs.BitStrings())),
                 observable="I'm not valid"),
            ns.backend.StateRepr, ns.backend.OperatorRepr,
        ),
        "config_not_from_str": lambda: ns.config.EmulationConfig.from_abstract_repr(
            1.0
        ),
        "config_schema": lambda: ns.config.EmulationConfig.from_abstract_repr(
            '{"observables": []}'
        ),
        "state_not_from_amplitudes": lambda: ns.backend.StateRepr(
            eigenstates=("r", "g")
        )._to_abstract_repr(),
        "state_invalid_eigenstates": lambda: ns.backend.StateRepr(
            eigenstates=("av", "b", "c")
        ),
        "state_invalid_amplitudes": lambda: _state(
            ns, ("0", "1"), {"00000": 1.0j, "rrrrr": 1.0}
        ),
        "legacy_interaction_matrix": lambda: _legacy_config(ns, "matrix"),
        "legacy_aggregation_method": lambda: _legacy_config(ns, "aggregation"),
        "results_atom_order": lambda: _results_load(
            ns,
            ns.results.Results(
                atom_order=(0, 1, 2), total_duration=1000
            ).to_abstract_repr(),
        ),
        "results_collision": lambda: ns.results.Results(
            atom_order=(0, "0"), total_duration=10
        ).to_abstract_repr(),
        "results_schema": lambda: ns.results.Results.from_abstract_repr("{}"),
    }


def _legacy_config(ns, which: str):
    """pulser <= 1.8's configs: a 2-D interaction matrix, observables
    without ``default_aggregation_method``."""
    config = ns.config.EmulationConfig(
        observables=[ns.obs.Energy()],
        interaction_matrix=[[0.0, 0.5], [0.5, 0.0]],
    )
    ser = json.loads(config.to_abstract_repr())
    if which == "matrix":
        ser["interaction_matrix"] = [[0.0, 0.5], [0.5, 0.0]]
    else:
        ser["observables"][0].pop("default_aggregation_method")
    back = ns.config.EmulationConfig.from_abstract_repr(json.dumps(ser))
    return [
        np.asarray(back.interaction_matrix).tolist(),
        int(back.observables[0].default_aggregation_method),
    ]


@pytest.mark.parametrize("with_uuid", [True, False])
@pytest.mark.parametrize("name", list(OBSERVABLES))
def test_observable_repr_parity(name, with_uuid):
    """The observables of ``tests/test_backend_abstract_repr.py``: the
    same payload, read back with or without its tag."""
    assert_parity(
        lambda ns: _observable_payload(ns, OBSERVABLES[name], with_uuid)
    )


@pytest.mark.parametrize("name", list(_backend_errors(TORCH)))
def test_backend_abstract_repr_error_parity(name):
    """The error and legacy cases of ``tests/test_backend_abstract_repr.py``."""
    assert_parity(lambda ns: _backend_errors(ns)[name]())


# -- tensors ---------------------------------------------------------------


def _live_build(P, amp):
    """A sequence whose pulses and EOM set-point take ``amp`` (a live
    value where it is a tensor that requires grad or a JAX tracer)."""
    reg = P.Register.rectangle(1, 2, spacing=7.0, prefix="q")
    seq = P.Sequence(reg, P.AnalogDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(
        P.Pulse.ConstantDetuning(P.BlackmanWaveform(200, amp), 0.0, 0.0),
        "ryd",
    )
    seq.enable_eom_mode("ryd", amp, 0.5, -10.0)
    seq.add_eom_pulse("ryd", 100, 0.3)
    seq.disable_eom_mode("ryd", correct_phase_drift=True)
    return seq


@pytest.fixture
def float64():
    """torch in float64, the counterpart of the tests' ``jax_enable_x64``
    (as ``tests/test_torch_sequence_diff.py``)."""
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(torch.float32)


def test_live_tensors_refuse_and_detached_tensors_serialize(float64):
    """Serializing a live value refuses in both packages (under
    ``jax.grad`` and with a tensor that requires grad), with the
    ``AbstractArray`` message in the port; after ``.detach()`` the port
    writes the string of the build with plain floats, as the JAX package
    does with a concrete array."""

    def under_grad(a):
        _live_build(tpu, a).to_abstract_repr()
        return a

    with pytest.raises(Exception):
        jax.grad(under_grad)(1.0)
    live = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    msg = (
        "A tensor that requires grad can't be serialized without losing"
        " the computational graph information."
    )
    with pytest.raises(NotImplementedError, match=re.escape(msg)):
        _live_build(ptt, live).to_abstract_repr()
    with pytest.raises(NotImplementedError, match=re.escape(msg)):
        json.dumps(live * 2, cls=_ser(TORCH).AbstractReprEncoder)
    with pytest.raises(NotImplementedError, match=re.escape(msg)):
        _encode(TORCH, ptt.BlackmanWaveform(200, live))
    want = _live_build(tpu, 1.0).to_abstract_repr()
    assert _live_build(tpu, jnp.asarray(1.0)).to_abstract_repr() == want
    assert _live_build(ptt, live.detach()).to_abstract_repr() == want
    assert _live_build(ptt, 1.0).to_abstract_repr() == want


# -- validation and the pinned payloads ------------------------------------


def _validators() -> dict:
    """The port's two validators of each object type: the one this host
    uses (fastjsonschema) and the one the card's machine uses
    (jsonschema)."""
    val = ptt.json.abstract_repr.validation
    return {
        "fastjsonschema": lambda obj, name: val._get_validator(name)(obj),
        "jsonschema": lambda obj, name: val._jsonschema_validator(
            val._load_schema_copy(f"{name}-schema.json")
        )(obj),
    }


def _valid_payloads() -> dict:
    with _quiet():
        payloads = {
            "sequence": [s for s in chip_smoke.wire_payloads().values()]
            + [SEQUENCES["eom_mode"](ptt).to_abstract_repr(),
               _parametrized(ptt).to_abstract_repr()],
            "device": [getattr(ptt.devices, n).to_abstract_repr()
                       for n in DEVICE_NAMES],
            "layout": [l.to_abstract_repr() for l in _layouts(ptt).values()],
            "register": [r.to_abstract_repr()
                         for r in _registers(ptt).values()],
            "noise": [n.to_abstract_repr()
                      for n in _noise_models(ptt).values()],
            "config": [c.to_abstract_repr()
                       for c in _configs(TORCH).values()],
            "results": [_stored_results(TORCH, False).to_abstract_repr()],
        }
    return payloads


INVALID = {
    "sequence": lambda s: {**s, "register": "nope"},
    "device": lambda s: {**s, "dimensions": 4},
    "layout": lambda s: {**s, "coordinates": "nope"},
    "register": lambda s: {**s, "register": [{"x": 1.0}]},
    "noise": lambda s: {**s, "noise_types": ["bogus"]},
    "config": lambda s: {**s, "with_modulation": "yes"},
    "results": lambda s: {**s, "atom_order": 3},
}


@pytest.mark.parametrize("name", list(INVALID))
def test_both_validators_agree(name):
    """Every valid payload of an object type passes both validators, and a
    broken one fails both."""
    payloads = _valid_payloads()[name]
    for validate in _validators().values():
        for s in payloads:
            validate(json.loads(s), name)
        with pytest.raises(Exception):
            validate(INVALID[name](json.loads(payloads[0])), name)


def test_validation_needs_a_validator():
    """With neither validator importable, validating raises an
    ``ImportError`` that names both; nothing is skipped."""
    val = ptt.json.abstract_repr.validation
    val._get_validator.cache_clear()
    try:
        with patch.dict(
            "sys.modules", {"fastjsonschema": None, "jsonschema": None}
        ):
            with pytest.raises(ImportError, match="'fastjsonschema'.*'jsonschema'"):
                ptt.Register.square(1, prefix="q").to_abstract_repr()
    finally:
        val._get_validator.cache_clear()


@pytest.mark.parametrize("name", list(chip_smoke.WIRE_PAYLOAD_SHA256))
def test_wire_payloads_are_pinned_and_valid(name):
    """The payloads ``chip_smoke.py`` sends: their sha256 is the one the
    card checks, and both validators accept them; NOISY10's config too."""
    import hashlib

    payload = chip_smoke.wire_payloads()[name]
    assert hashlib.sha256(payload.encode()).hexdigest() == (
        chip_smoke.WIRE_PAYLOAD_SHA256[name]
    )
    for validate in _validators().values():
        validate(json.loads(payload), "sequence")
    if name == "WIRE_NOISY10":
        noise = chip_smoke.noisy10_sequence()[1]
        config = chip_smoke.wire_noisy10_config(noise).to_abstract_repr()
        for validate in _validators().values():
            validate(json.loads(config), "config")
