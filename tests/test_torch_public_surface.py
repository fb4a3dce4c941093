"""The port's public names against the JAX package's, module by module.

For every module of ``pulser_tpu`` that the port mirrors, each public
name (``dir()`` without a leading ``_``; type variables and names that
JAX, numpy or the standard library define are not the package's
surface) exists in the port's module under ``Tpu`` → ``Torch``, and each
public member of a class exists on the port's class. A name the port
keeps out on purpose is on :data:`ALLOWLIST` with its reason, and the
reason is a "Not to port" bullet of ``ROADMAP.md``. Then the repaired
names are held against the JAX package on the same inputs.
"""

from __future__ import annotations

import importlib
import inspect
import os
import pkgutil
import re
import types
import warnings
from typing import TypeVar

import numpy as np
import pytest
import torch

import pulser_tpu as tpu
import pulser_tpu.math as jm
from pulser_tpu.hamiltonian_data import HamiltonianData as JaxData

import pulser_tpu_torch as ptt
import pulser_tpu_torch.math as tm
from pulser_tpu_torch.hamiltonian_data import HamiltonianData as TorchData

from test_torch_sampler import samples_facts
from test_torch_sequence import SCENARIOS, UNMODULATED, assert_same, both

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: JAX modules the port has no counterpart of, with the "Not to port"
#: bullet (or the kernels' home) that says why.
NOT_PORTED_MODULES = {
    "pulser_tpu.aot_cache": "`aot_cache.py`",
    "pulser_tpu.caching": "`caching.py`",
    "pulser_tpu.ops.pallas_kernels": "pallas_kernels.py",
}

#: (JAX module or class, name) → the phrase of the "Not to port" bullet
#: of ROADMAP.md that leaves the name out.
ALLOWLIST = {
    ("pulser_tpu", "enable_compilation_cache"): "`caching.py`",
    ("pulser_tpu.math.multinomial", "multinomial_jax"): "`multinomial_jax`",
    **{
        (module, name): "`c2r`, `r2c` and `apply_axis_r`"
        for module in ("pulser_tpu.ops", "pulser_tpu.ops.apply")
        for name in ("c2r", "r2c", "apply_axis_r")
    },
    ("pulser_tpu.parallel.capacity", "V5E_HBM_BYTES"): "`V5E_HBM_BYTES`",
    ("pulser_tpu.parallel.capacity", "HBM_BUDGET_FRACTION"): "`V5E_HBM_BYTES`",
    ("pulser_tpu.parallel.capacity", "measured_hbm_bytes"): "`V5E_HBM_BYTES`",
    **{
        ("pulser_tpu.ops.solver.RankFactors", name): (
            "`RankFactors.tree_flatten`"
        )
        for name in ("tree_flatten", "tree_unflatten")
    },
    **{
        ("pulser_tpu.emulator.simulation", name): "`_timed` solver aliases"
        for name in (
            "mcsolve_rk4",
            "mesolve_rk4",
            "sesolve_rk4",
            "sesolve_rk4_batched",
        )
    },
}


def _not_to_port_section() -> str:
    with open(os.path.join(ROOT, "ROADMAP.md")) as f:
        text = f.read()
    start = text.index("**Not to port.")
    return text[start : text.index("\n### ", start)]


def _port_name(name: str) -> str:
    return name.replace("Tpu", "Torch").replace("tpu", "torch")


def _port_module_name(name: str) -> str:
    parts = name.split(".")
    return ".".join(["pulser_tpu_torch"] + [_port_name(p) for p in parts[1:]])


def _jax_modules() -> list[str]:
    names = ["pulser_tpu"] + [
        m.name
        for m in pkgutil.walk_packages(tpu.__path__, "pulser_tpu.")
        if not m.name.split(".")[-1].startswith("_plan_builder_")
    ]
    return sorted(names)


JAX_MODULES = _jax_modules()


def _foreign(obj) -> bool:
    """A type variable, or a class or function defined outside the JAX
    package (JAX's ``Mesh``, numpy's ``norm``, ``typing`` helpers)."""
    if isinstance(obj, TypeVar):
        return True
    if inspect.isclass(obj) or (
        callable(obj) and not isinstance(obj, types.GenericAlias)
    ):
        module = getattr(obj, "__module__", None) or ""
        return module.split(".")[0] != "pulser_tpu"
    return False


def _missing_names(name: str) -> list[str]:
    """The public names of JAX module ``name`` the port's module lacks.

    A plain module's name imported from another module of the package
    counts where the port's counterpart of its defining module has it;
    a package's exports count only in the package itself."""
    jax_mod = importlib.import_module(name)
    port_mod = importlib.import_module(_port_module_name(name))
    is_package = hasattr(jax_mod, "__path__")
    missing = []
    for attr in dir(jax_mod):
        if attr.startswith("_"):
            continue
        obj = getattr(jax_mod, attr)
        if inspect.ismodule(obj) or _foreign(obj):
            continue
        if hasattr(port_mod, _port_name(attr)):
            continue
        home = getattr(obj, "__module__", None)
        if (
            not is_package
            and inspect.isclass(obj) | inspect.isroutine(obj)
            and home not in (None, name)
        ):
            if (home, attr) in ALLOWLIST:
                continue
            home_port = importlib.import_module(_port_module_name(home))
            if hasattr(home_port, _port_name(attr)):
                continue
        missing.append(attr)
    return missing


def _missing_members(name: str) -> list[tuple[str, str]]:
    """(class, member) pairs of the classes JAX module ``name`` defines
    whose port counterpart lacks the public member."""
    jax_mod = importlib.import_module(name)
    port_mod = importlib.import_module(_port_module_name(name))
    missing = []
    for attr in dir(jax_mod):
        cls = getattr(jax_mod, attr)
        if not inspect.isclass(cls) or cls.__module__ != name:
            continue
        port_cls = getattr(port_mod, _port_name(attr), None)
        if port_cls is None:
            continue
        have = set(dir(port_cls))
        missing += [
            (attr, member)
            for member in dir(cls)
            if not member.startswith("_")
            and _port_name(member) not in have
        ]
    return missing


@pytest.mark.parametrize(
    "name", [m for m in JAX_MODULES if m not in NOT_PORTED_MODULES]
)
def test_public_names_exist_in_the_port(name):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        names = _missing_names(name)
        members = _missing_members(name)
    unlisted = [n for n in names if (name, n) not in ALLOWLIST]
    unlisted += [
        f"{cls}.{member}"
        for cls, member in members
        if (f"{name}.{cls}", member) not in ALLOWLIST
    ]
    assert unlisted == [], f"{_port_module_name(name)} lacks {unlisted}"


def test_unported_modules_have_no_counterpart():
    section = _not_to_port_section()
    for name, phrase in NOT_PORTED_MODULES.items():
        assert name in JAX_MODULES
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(_port_module_name(name))
        assert phrase in section or phrase in _queue_2(), (name, phrase)


def _queue_2() -> str:
    with open(os.path.join(ROOT, "ROADMAP.md")) as f:
        text = f.read()
    start = text.index("### Queue 2")
    return text[start : text.index("\n### ", start + 1)]


@pytest.mark.parametrize("key", list(ALLOWLIST), ids="::".join)
def test_allowlist_entries_are_not_to_port_bullets(key):
    """Each allowlisted name is still absent from the port, and its
    reason is a bullet of ROADMAP.md's "Not to port" list."""
    owner, name = key
    phrase = ALLOWLIST[key]
    bullets = re.split(r"\n- ", _not_to_port_section())
    assert any(phrase in b for b in bullets), phrase
    module, _, cls = owner.rpartition(".")
    if owner in JAX_MODULES:
        jax_owner = importlib.import_module(owner)
        port_owner = importlib.import_module(_port_module_name(owner))
    else:
        jax_owner = getattr(importlib.import_module(module), cls)
        port_owner = getattr(
            importlib.import_module(_port_module_name(module)), _port_name(cls)
        )
    assert hasattr(jax_owner, name)
    assert not hasattr(port_owner, _port_name(name))


# --- the repaired names ---------------------------------------------------


def test_weighted_analog_device_at_the_top_level():
    assert ptt.WeightedAnalogDevice is ptt.devices.WeightedAnalogDevice
    assert "WeightedAnalogDevice" in ptt.__all__
    assert ptt.WeightedAnalogDevice.name == tpu.WeightedAnalogDevice.name


def test_ops_exports_and_loads_no_cuda_library():
    import pulser_tpu.ops as jax_ops
    import pulser_tpu_torch.ops as port_ops

    kept = set(jax_ops.__all__) - {"c2r", "r2c", "apply_axis_r"}
    assert set(port_ops.__all__) == kept
    assert port_ops.sesolve_rk4 is port_ops.solver.sesolve_rk4
    assert port_ops.neg_i is port_ops.apply.neg_i


@pytest.mark.parametrize(
    "value",
    [np.array([3.0, -4.0]), np.arange(6.0).reshape(2, 3), np.array(2.5)],
    ids=["vector", "matrix", "scalar"],
)
def test_math_norm_and_zeros_like_match(value):
    for fn in ("norm", "zeros_like"):
        want = np.asarray(getattr(jm, fn)(value))
        got = getattr(tm, fn)(value)
        assert not got.is_tensor
        assert got.as_array().dtype == want.dtype
        assert np.array_equal(got.as_array(), want), fn


def test_math_norm_and_zeros_like_carry_gradients():
    x = torch.tensor([3.0, -4.0], dtype=torch.float64, requires_grad=True)
    n = tm.norm(x)
    assert n.is_tensor and n.requires_grad
    (grad,) = torch.autograd.grad(n.as_tensor(), x)
    assert torch.allclose(grad, x.detach() / 5.0)
    z = tm.zeros_like(x)
    assert z.is_tensor and z.as_tensor().dtype == torch.float64
    (grad,) = torch.autograd.grad((z + x).as_tensor().sum(), x)
    assert torch.equal(grad, torch.ones(2, dtype=torch.float64))
    assert tm.TensorLike is not None


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_hamiltonian_data_from_sequence_samples_bit_equal(name):
    jax_seq, port_seq = both(name, 21)
    kwargs = [{}] if name in UNMODULATED else [{}, {"with_modulation": True}]
    for kw in kwargs:
        if kw and jax_seq._slm_mask_targets:
            continue  # refused in both packages (the refusal test)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jax_data = JaxData.from_sequence(jax_seq, **kw)
            port_data = TorchData.from_sequence(port_seq, **kw)
        assert type(port_data) is TorchData
        assert_same(
            samples_facts(jax_data.samples),
            samples_facts(port_data.samples),
            f"{name}{kw}",
        )
        assert port_data.n_qudits == jax_data.n_qudits


def _refusals(P, Data) -> list:
    reg = P.Register.square(2, spacing=6.0, prefix="q")

    def parametrized():
        seq = P.Sequence(reg, P.MockDevice)
        seq.declare_channel("ryd", "rydberg_global")
        v = seq.declare_variable("v", dtype=float)
        seq.add(P.Pulse.ConstantPulse(100, v, 0.0, 0.0), "ryd")
        return seq

    def no_channel():
        return P.Sequence(reg, P.MockDevice)

    def no_instruction():
        seq = P.Sequence(reg, P.MockDevice)
        seq.declare_channel("ryd", "rydberg_global")
        return seq

    def masked():
        seq = P.Sequence(reg, P.DigitalAnalogDevice)
        seq.config_slm_mask(["q0"], "dmm_0")
        seq.declare_channel("ryd", "rydberg_global")
        seq.add(P.Pulse.ConstantPulse(100, 1.0, 0.0, 0.0), "ryd")
        return seq

    calls = [
        lambda: Data.from_sequence("sequence"),
        lambda: Data.from_sequence(parametrized()),
        lambda: Data.from_sequence(no_channel()),
        lambda: Data.from_sequence(no_instruction()),
        lambda: Data.from_sequence(masked(), with_modulation=True),
    ]
    out = []
    for call in calls:
        with pytest.raises(Exception) as err:
            call()
        out.append((err.type.__name__, str(err.value)))
    return out


def test_hamiltonian_data_from_sequence_refusals_match():
    """Not a sequence, parametrized, no channel, no instruction (an
    unmeasured, empty sequence), SLM mask with modulation: the JAX
    package's errors, in its order."""
    jax_errs = _refusals(tpu, JaxData)
    assert _refusals(ptt, TorchData) == jax_errs
    assert [kind for kind, _ in jax_errs] == [
        "TypeError",
        "ValueError",
        "ValueError",
        "ValueError",
        "NotImplementedError",
    ]


def test_hamiltonian_data_from_sequence_draws_the_noise():
    """With a noise model the classmethod draws the trajectories as the
    JAX package's does, from the same numpy seed."""
    noise = dict(amp_sigma=0.05, temperature=30.0, runs=3, samples_per_run=1)
    trajs = []
    seqs = both("global_local", 4)
    for P, Data, seq in zip((tpu, ptt), (JaxData, TorchData), seqs):
        np.random.seed(9)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            data = Data.from_sequence(
                seq, noise_model=P.NoiseModel(**noise), n_trajectories=3
            )
        trajs.append(
            [
                (
                    t.reps,
                    dict(t.trajectory.amp_fluctuations),
                    dict(t.trajectory.doppler_detune),
                )
                for t in data.noise_trajectories
            ]
        )
    assert_same(*trajs)


def test_result_from_final_bitstrings_raises_the_same():
    import pulser_tpu.result as jax_result
    import pulser_tpu_torch.result as port_result

    msgs = []
    for mod in (jax_result, port_result):
        with pytest.raises(NotImplementedError) as err:
            mod.SampledResult.from_final_bitstrings(("q0",), 100, {"0": 1})
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] == (
        "'SampledResult.from_final_bitstrings()' is not implemented."
    )


@pytest.mark.parametrize(
    "old, new", [("Results", "ResultsSequence"), ("ResultType", "ResultsType")]
)
def test_result_moved_names_warn_and_resolve(old, new):
    import pulser_tpu.result as jax_result
    import pulser_tpu_torch.backend.results as port_results
    import pulser_tpu_torch.result as port_result

    warned = []
    for mod in (jax_result, port_result):
        with pytest.warns(DeprecationWarning) as rec:
            obj = getattr(mod, old)
        warned.append(str(rec[0].message))
    assert obj is getattr(port_results, new)
    assert warned[0] == warned[1]
    with pytest.raises(AttributeError, match="has no attribute 'Nope'"):
        port_result.Nope


def test_state_aliases_and_backend_imports():
    import pulser_tpu.emulator.tpu_state as jax_state
    import pulser_tpu_torch.emulator.torch_backend as port_backend
    import pulser_tpu_torch.emulator.torch_state as port_state

    for alias in ("QuditOp", "TensorOp", "FullOp"):
        assert repr(getattr(port_state, alias)) == repr(
            getattr(jax_state, alias)
        )
    assert port_backend.TorchState is port_state.TorchState
    assert port_backend.TorchOperator is ptt.TorchOperator


def test_device_state_batch_sync_on_the_cpu():
    from pulser_tpu_torch.ops.solver import DeviceStateBatch

    batch = DeviceStateBatch(torch.zeros(2, 4), np.arange(2), lambda v: v)
    batch.sync()
    assert len(batch) == 2
