"""The remote backends and the backend registry: the port against
pulser_tpu.

The cases of ``tests/test_remote_backend.py`` and
``tests/test_backends_registry.py``, each written once as a function of a
package namespace (``tests/torch_parity.py``) and run through both
packages by ``assert_parity``: the same values, or the same exception
type and message, and the same warnings. The in-process connection is
the JAX package's test's ``FakeConn``, built on each package's
``RemoteConnection``. The last tests submit through ``QPUBackend`` to
``chip_smoke.chip_connection`` (the connection ``chip_smoke.py`` runs on
the card) on the CPU.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import sys
import warnings
from collections import Counter

import numpy as np
import pytest
import torch

import pulser_tpu as tpu

import pulser_tpu_torch as ptt

import chip_smoke
from torch_parity import TORCH, assert_parity

torch.set_num_threads(1)

for _root in ("pulser_tpu", "pulser_tpu_torch"):
    for _module in ("backend.remote", "backends"):
        importlib.import_module(f"{_root}.{_module}")


def _remote(ns):
    return ns.pkg.backend.remote


def _fake_conn(ns, kind: str = "fake"):
    """The JAX package's test connection (``FakeConn``, and its
    ``FlakyConn`` and ``PendingConn`` variants) on ``ns``'s classes."""
    R = _remote(ns)
    Results = ns.results.Results

    class FakeConn(R.RemoteConnection):
        def __init__(self):
            self.batches: dict = {}
            self.fetch_attempts = 0

        def submit(self, sequence, wait=False, open=False, batch_id=None,
                   **kwargs):
            bid = batch_id or f"b{len(self.batches)}"
            jp = kwargs.get("job_params") or [{}]
            res = [
                Results(
                    atom_order=tuple(sequence.register.qubit_ids),
                    total_duration=sequence.get_duration(),
                )
                for _ in jp
            ]
            self.batches.setdefault(bid, []).extend(res)
            return R.RemoteResults(bid, self)

        def _fetch_result(self, batch_id, job_ids):
            if kind == "flaky":
                self.fetch_attempts += 1
                if self.fetch_attempts == 1:
                    raise R.RemoteResultsError("results not ready")
            return tuple(self.batches[batch_id])

        def _query_job_progress(self, batch_id):
            return {
                f"j{i}": (
                    (R.JobStatus.RUNNING, None)
                    if kind == "pending" and i == 0
                    else (R.JobStatus.DONE, r)
                )
                for i, r in enumerate(self.batches[batch_id])
            }

        def _get_batch_status(self, batch_id):
            if kind == "pending":
                return R.BatchStatus.RUNNING
            return R.BatchStatus.DONE

        def _get_job_ids(self, batch_id):
            return [f"j{i}" for i in range(len(self.batches[batch_id]))]

        def supports_open_batch(self):
            return kind != "closed"

        def _close_batch(self, batch_id):
            pass

        def fetch_available_devices(self):
            if kind == "no_devices":
                return super().fetch_available_devices()
            return {"AnalogDevice": ns.pkg.AnalogDevice}

    return FakeConn()


def _qpu_seq(ns, measure: bool = True):
    P = ns.pkg
    layout = P.AnalogDevice.pre_calibrated_layouts[0]
    reg = layout.define_register(0, 1, qubit_ids=["q0", "q1"])
    seq = P.Sequence(reg, P.AnalogDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(P.Pulse.ConstantPulse(100, 2.0, 0.0, 0.0), "ryd")
    if measure:
        seq.measure("ground-rydberg")
    return seq


def _qpu_run(ns):
    rr = ns.pkg.QPUBackend(
        _qpu_seq(ns),
        _fake_conn(ns),
        config=ns.backend.BackendConfig(default_num_shots=100),
    ).run()
    return [
        rr.get_batch_status().name, rr.job_ids, len(rr.results),
        list(rr.get_available_results()), rr.batch_id,
    ]


def _open_batch(ns):
    backend = _remote(ns).RemoteBackend(_qpu_seq(ns), _fake_conn(ns))
    with backend.open_batch():
        inside = backend._batch_id
    return [inside, backend._batch_id]


def _lazy_retry(ns):
    conn = _fake_conn(ns, "flaky")
    rr = conn.submit(_qpu_seq(ns), job_params=[{"runs": 10}])
    try:
        rr.results
    except _remote(ns).RemoteResultsError as e:
        first = str(e)
    return [first, len(rr.results), conn.fetch_attempts]


def _partial(ns):
    conn = _fake_conn(ns, "pending")
    rr = conn.submit(_qpu_seq(ns), job_params=[{"runs": 10}, {"runs": 10}])
    return [rr.get_batch_status().name, list(rr.get_available_results())]


def _job_ids(ns):
    conn = _fake_conn(ns)
    rr = conn.submit(_qpu_seq(ns), job_params=[{"runs": 5}, {"runs": 5}])
    subset = _remote(ns).RemoteResults(rr.batch_id, conn, job_ids=["j1"])
    return [rr.batch_id, rr.job_ids, rr.get_batch_status().name,
            len(rr.results), subset.job_ids,
            list(subset.get_available_results())]


def _retarget(ns):
    conn = _fake_conn(ns)
    stale = _qpu_seq(ns).with_new_device(
        dataclasses.replace(ns.pkg.AnalogDevice, max_runs=123)
    )
    updated = conn.update_sequence_device(stale)
    same = conn.update_sequence_device(_qpu_seq(ns))
    return [updated.device is ns.pkg.AnalogDevice,
            same.device is ns.pkg.AnalogDevice,
            updated.to_abstract_repr() == _qpu_seq(ns).to_abstract_repr()]


def _unknown_device(ns):
    P = ns.pkg
    seq = P.Sequence(P.Register.square(2, spacing=6.0, prefix="q"),
                     P.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    return _fake_conn(ns).update_sequence_device(seq)


def _incompatible_device(ns):
    seq = _qpu_seq(ns)
    smaller = dataclasses.replace(
        ns.pkg.AnalogDevice, max_sequence_duration=50
    )
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        seq = seq.with_new_device(
            dataclasses.replace(ns.pkg.AnalogDevice, max_runs=7)
        )

    class Conn(type(_fake_conn(ns))):
        def fetch_available_devices(self):
            return {"AnalogDevice": smaller}

    return Conn().update_sequence_device(seq)


def _measurement_added(ns):
    R = _remote(ns).RemoteConnection
    seq = _qpu_seq(ns, measure=False)
    fixed = R._add_measurement_to_sequence(seq)
    again = R._add_measurement_to_sequence(fixed)
    return [seq.is_measured(), fixed.is_measured(), again is fixed,
            fixed.get_measurement_basis(), fixed.to_abstract_repr()]


def _two_bases(ns):
    P = ns.pkg
    seq = P.Sequence(P.Register.square(2, spacing=6.0, prefix="q"),
                     P.DigitalAnalogDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.declare_channel("ram", "raman_local", initial_target="q0")
    seq.add(P.Pulse.ConstantPulse(100, 1.0, 0.0, 0.0), "ryd")
    seq.add(P.Pulse.ConstantPulse(100, 1.0, 0.0, 0.0), "ram")
    return _remote(ns).RemoteConnection._add_measurement_to_sequence(seq)


CASES = {
    "qpu_backend_run": _qpu_run,
    "qpu_backend_requires_runs": lambda ns: ns.pkg.QPUBackend(
        _qpu_seq(ns), _fake_conn(ns)
    ).run(job_params=[{"variables": {}}]),
    "qpu_backend_needs_job_params": lambda ns: ns.pkg.QPUBackend(
        _qpu_seq(ns), _fake_conn(ns)
    ).run(),
    "qpu_backend_runs_over_max": lambda ns: ns.pkg.QPUBackend(
        _qpu_seq(ns), _fake_conn(ns)
    ).run(job_params=[{"runs": 10**6}]),
    "qpu_backend_default_shots_merge": lambda ns: ns.pkg.QPUBackend(
        _qpu_seq(ns),
        _fake_conn(ns),
        config=ns.backend.BackendConfig(default_num_shots=7),
    ).run(job_params=[{}, {"runs": 3}]).job_ids,
    "qpu_backend_job_params_not_a_list": lambda ns: ns.pkg.QPUBackend(
        _qpu_seq(ns),
        _fake_conn(ns),
        config=ns.backend.BackendConfig(default_num_shots=7),
    ).run(job_params={"runs": 3}),
    "qpu_rejects_layoutless_register": lambda ns: ns.pkg.QPUBackend(
        _unknown_device_seq(ns), _fake_conn(ns)
    ),
    "qpu_rejects_virtual_device": lambda ns: ns.pkg.QPUBackend(
        _virtual_seq(ns), _fake_conn(ns)
    ),
    "qpu_rejects_empty_sequence": lambda ns: ns.pkg.QPUBackend(
        ns.pkg.Sequence(
            ns.pkg.AnalogDevice.pre_calibrated_layouts[0].define_register(
                0, 1
            ),
            ns.pkg.AnalogDevice,
        ),
        _fake_conn(ns),
    ),
    "remote_backend_bad_connection": lambda ns: _remote(ns).RemoteBackend(
        _qpu_seq(ns), object()
    ),
    "remote_backend_bad_config": lambda ns: _remote(ns).RemoteBackend(
        _qpu_seq(ns), _fake_conn(ns), config={"default_num_shots": 1}
    ),
    "remote_backend_run": lambda ns: _remote(ns).RemoteBackend(
        _qpu_seq(ns), _fake_conn(ns)
    ).run(job_params=[{"runs": 3}]).job_ids,
    "remote_backend_run_bad_params": lambda ns: _remote(ns).RemoteBackend(
        _qpu_seq(ns), _fake_conn(ns)
    ).run(job_params=["runs"]),
    "open_batch_context": _open_batch,
    "open_batch_unsupported": lambda ns: _remote(ns).RemoteBackend(
        _qpu_seq(ns), _fake_conn(ns, "closed")
    ).open_batch(),
    "remote_results_lazy_retry": _lazy_retry,
    "partial_results_while_running": _partial,
    "job_ids_and_batch_id": _job_ids,
    "unknown_job_ids": lambda ns: _remote(ns).RemoteResults(
        _fake_conn(ns).submit(_qpu_seq(ns)).batch_id,
        _fake_conn(ns),
        job_ids=["j9"],
    ),
    "job_ids_unsupported": lambda ns: _remote(ns).RemoteConnection._get_job_ids(
        _fake_conn(ns), "b0"
    ),
    "results_missing_attribute": lambda ns: _fake_conn(ns).submit(
        _qpu_seq(ns)
    ).not_an_attribute,
    "update_sequence_device_retargets": _retarget,
    "update_sequence_device_unknown_device": _unknown_device,
    "update_sequence_device_incompatible": _incompatible_device,
    "update_sequence_device_without_devices": lambda ns: _fake_conn(
        ns, "no_devices"
    ).update_sequence_device(_qpu_seq(ns)).to_abstract_repr(),
    "measurement_added_automatically": _measurement_added,
    "measurement_basis_ambiguous": _two_bases,
    "validate_job_params-not_a_list": lambda ns: _remote(
        ns
    ).RemoteBackend.validate_job_params({"runs": 1}, None),
    "validate_job_params-not_dicts": lambda ns: _remote(
        ns
    ).RemoteBackend.validate_job_params(["runs"], None),
    "validate_job_params-empty": lambda ns: _remote(
        ns
    ).RemoteBackend.validate_job_params([], None),
    "validate_job_params-ok": lambda ns: _remote(
        ns
    ).RemoteBackend.validate_job_params([{"runs": 5}], 10),
}


def _unknown_device_seq(ns):
    P = ns.pkg
    seq = P.Sequence(P.Register.square(2, spacing=6.0, prefix="q"),
                     P.AnalogDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(P.Pulse.ConstantPulse(100, 2.0, 0.0, 0.0), "ryd")
    return seq


def _virtual_seq(ns):
    P = ns.pkg
    seq = P.Sequence(P.Register.square(2, spacing=6.0, prefix="q"),
                     P.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(P.Pulse.ConstantPulse(100, 2.0, 0.0, 0.0), "ryd")
    return seq


@pytest.mark.parametrize("name", list(CASES))
def test_remote_backend_parity(name):
    """The cases of ``tests/test_remote_backend.py`` and the protocol's
    other refusals: the same values, or the same exception and
    message."""
    assert_parity(CASES[name])


# -- the backend registry --------------------------------------------------


def _registry(ns):
    return ns.pkg.backends


#: The local names of each package's registry, by their shared role.
LOCAL = {
    "QPUBackend": ("QPUBackend", "QPUBackend"),
    "QutipBackend": ("QutipBackend", "QutipBackend"),
    "QutipBackendV2": ("QutipBackendV2", "QutipBackendV2"),
    "Backend": ("TpuBackend", "TorchBackend"),
    "BackendV2": ("TpuBackendV2", "TorchBackendV2"),
}


def _local(ns, role: str) -> str:
    return LOCAL[role][ns is TORCH]


@pytest.mark.parametrize("role", list(LOCAL))
def test_registry_resolves_local_backends(role):
    """Each local name resolves to the package's own class."""

    def case(ns):
        cls = getattr(_registry(ns), _local(ns, role))
        return [issubclass(cls, ns.pkg.backend.abc.Backend), cls.__module__]

    assert_parity(case)
    assert ptt.backends.QPUBackend is ptt.QPUBackend
    assert ptt.backends.QutipBackendV2 is ptt.emulator.TorchBackendV2
    assert ptt.backends.TorchBackendV2 is ptt.emulator.TorchBackendV2
    assert ptt.backends.QutipBackend is ptt.emulator.TorchBackend
    assert "pulser_tpu_torch" in ptt.backends.QPUBackend.__module__


EXTERNAL = [
    name
    for name, entry in ptt.backends._REGISTRY.items()
    if entry.module is not None
    and not entry.module.startswith("pulser_tpu_torch")
]


def test_registry_names_match_the_jax_package():
    """The same names, with ``Tpu`` written ``Torch``."""
    assert sorted(ptt.backends._REGISTRY) == sorted(
        name.replace("Tpu", "Torch") for name in tpu.backends._REGISTRY
    )
    assert EXTERNAL == [
        name
        for name, entry in tpu.backends._REGISTRY.items()
        if entry.module is not None
        and not entry.module.startswith("pulser_tpu")
    ]


@pytest.mark.parametrize("name", EXTERNAL)
def test_registry_missing_package(monkeypatch, name):
    package = ptt.backends._REGISTRY[name].module
    monkeypatch.setitem(sys.modules, package, None)
    assert_parity(lambda ns: getattr(_registry(ns), name))


@pytest.mark.parametrize(
    "name",
    ["SpecialBackend", "EmuFreeBackend", "EmuTNBackend", "EmuFreeBackendV2",
     "EmuMPSBackend", "EmuSVBackend"],
)
def test_registry_refusals(name):
    """Unknown, removed and renamed names (the renames warn, then need
    the cloud package this image does not have)."""
    assert_parity(lambda ns: getattr(_registry(ns), name))


# -- a QPU job emulated behind the connection ------------------------------


def _small_tri(P, direct: bool = False):
    """Three atoms of ``AnalogDevice``'s calibrated layout under a short
    sweep, built on ``MockDevice`` and moved (``direct``: built on
    ``AnalogDevice``)."""
    reg = P.AnalogDevice.pre_calibrated_layouts[0].define_register(
        0, 1, 4, qubit_ids=["a", "b", "c"]
    )
    sweep = (2 * np.pi, -2 * np.pi, 2 * np.pi, 100, 300, 100)
    if direct:
        return chip_smoke._sweep_sequence(reg, *sweep, P=P,
                                          device=P.AnalogDevice)
    seq = chip_smoke._sweep_sequence(reg, *sweep, P=P)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return seq.with_new_device(P.AnalogDevice)


def test_qpu_job_through_the_chip_connection():
    """``QPUBackend.run`` through ``chip_smoke.chip_connection`` on the
    CPU: the submitted payload is the measured sequence's abstract repr,
    the job's counts equal sampling the direct build's final state with
    the same seed, and the results crossed the wire as JSON."""
    conn = chip_smoke.chip_connection(torch_device="cpu")
    remote = ptt.QPUBackend(_small_tri(ptt), connection=conn).run(
        job_params=[{"runs": 200}, {"runs": 50}]
    )
    assert remote.job_ids == ["job0", "job1"]
    assert remote.get_batch_status().name == "PENDING"
    counts = [dict(r.final_bitstrings) for r in remote.results]
    (payload,) = conn.sent
    measured = ptt.backend.RemoteConnection._add_measurement_to_sequence(
        _small_tri(ptt)
    )
    assert payload == measured.to_abstract_repr()
    assert json.loads(payload)["measurement"] == "ground-rydberg"
    final = ptt.emulator.TorchEmulator.from_sequence(
        _small_tri(ptt, direct=True),
        evaluation_times="Minimal",
        torch_device="cpu",
    ).run()
    for runs, got in zip((200, 50), counts):
        np.random.seed(chip_smoke.TRI16_SEED)
        assert got == dict(final.sample_final_state(runs))
        assert sum(got.values()) == runs


def test_qpu_job_counts_match_the_jax_package():
    """The same QPU job's state emulated by each package (float64):
    the final-state counts drawn with the same seed are equal."""

    def case(ns):
        final = ns.Emulator.from_sequence(
            _small_tri(ns.pkg, direct=True),
            evaluation_times="Minimal",
            **ns.kw,
        ).run()
        np.random.seed(chip_smoke.TRI16_SEED)
        return Counter(final.sample_final_state(200))

    assert_parity(case)
