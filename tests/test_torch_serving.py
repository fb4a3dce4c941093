"""The port's resident solve daemon against the JAX package's.

``pulser_tpu_torch/serving.py`` speaks the JAX daemon's wire protocol:
the eight tests of ``tests/test_serving.py`` run here against the port's
daemon on the CPU (in a thread, as there), then each package's client
talks to the other package's daemon and the answers are held against
each other: states at 1 − F ≤ 1e-6, seeded counts equal, backend
occupations within 1e-6. Last, the thin client loaded by file path with
``torch`` and ``jax`` blocked, the refusal to start without a card, and
a failing request that leaves the daemon serving.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import threading

import numpy as np
import pytest
import torch

import pulser_tpu
import pulser_tpu.emulator
import pulser_tpu.serving
import pulser_tpu_torch as P
from pulser_tpu_torch import serving
from pulser_tpu_torch.emulator import TorchEmulator

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _small_seq(pkg=P):
    reg = pkg.Register.rectangle(1, 3, spacing=8.0, prefix="q")
    seq = pkg.Sequence(reg, pkg.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(
        pkg.Pulse.ConstantDetuning(
            pkg.BlackmanWaveform(500, np.pi), -2.0, 0.0
        ),
        "ryd",
    )
    return seq


def _start(module, **kwargs):
    """A daemon of ``module`` in a thread; returns (client, thread)."""
    path = os.path.join(tempfile.mkdtemp(), "serve_test.sock")
    ready = threading.Event()
    th = threading.Thread(
        target=module.serve,
        args=(path,),
        kwargs={"ready_event": ready, **kwargs},
        daemon=True,
    )
    th.start()
    assert ready.wait(60), "daemon did not come up"
    return path, th


def _stop(path, th):
    serving.SolveClient(path).shutdown()
    th.join(timeout=10)
    assert not th.is_alive()
    assert not os.path.exists(path)


@pytest.fixture()
def daemon():
    path, th = _start(serving, device="cpu")
    yield serving.SolveClient(path)
    _stop(path, th)


@pytest.fixture()
def jax_daemon(monkeypatch):
    # The JAX package's trajectory batch without its mesh, as the port's
    # parity tests run it
    monkeypatch.setenv("PULSER_TPU_DISABLE_SHARDING", "1")
    path, th = _start(pulser_tpu.serving)
    yield path
    _stop(path, th)


# -- the eight tests of tests/test_serving.py, on the port's daemon ------


def test_ping_and_unknown_kind(daemon):
    assert daemon.ping()
    resp = daemon._request({"kind": "nonsense"})
    assert not resp["ok"]
    assert "unknown kind" in resp["error"]


def test_run_sequence_matches_direct(daemon):
    seq = _small_seq()
    out = daemon.run(seq, evaluation_times="Full")
    direct = TorchEmulator.from_sequence(
        seq, evaluation_times="Full", torch_device="cpu"
    ).run()
    ref = np.stack([s.full()[:, 0] for s in direct.states])
    assert out["states"].shape == ref.shape
    assert out["states"].dtype == np.complex64
    np.testing.assert_allclose(out["states"], ref, atol=1e-7)
    assert len(out["eval_times"]) == ref.shape[0]


def test_run_accepts_preserialized_and_eval_list(daemon):
    seq = _small_seq()
    times = [0.0, 0.25, 0.5]
    out = daemon.run(seq.to_abstract_repr(), evaluation_times=times)
    assert out["states"].shape[0] == 3
    norms = np.linalg.norm(out["states"], axis=1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-6)


def test_run_noisy_sampling(daemon):
    seq = _small_seq()
    noise = P.NoiseModel(
        dephasing_rate=0.02,
        amp_sigma=0.01,
        runs=5,
        samples_per_run=2,
    )
    out = daemon.run(
        seq,
        noise_model=noise,
        evaluation_times="Minimal",
        seed=11,
        n_samples=200,
    )
    counts = out["counts"]
    assert sum(counts.values()) == 200
    assert all(len(k) == 3 for k in counts)


def test_bad_sequence_returns_error(daemon):
    with pytest.raises(RuntimeError, match="daemon error"):
        daemon.run("{not json")


def test_client_ping_without_server():
    client = serving.SolveClient("/tmp/definitely_absent.sock")
    assert not client.ping()


def test_run_backend_observables_roundtrip(daemon):
    """The backend-v2 pipeline — expectation values, correlation
    matrix, occupation, bitstrings — flows through the daemon and
    round-trips via the Results abstract repr."""
    from pulser_tpu_torch.backend import (
        BitStrings,
        CorrelationMatrix,
        Expectation,
        Occupation,
    )
    from pulser_tpu_torch.emulator import TorchBackendV2
    from pulser_tpu_torch.emulator.torch_config import TorchConfig
    from pulser_tpu_torch.emulator.torch_op import TorchOperator

    seq = _small_seq()
    n = len(seq.register.qubit_ids)
    zop = TorchOperator.from_operator_repr(
        eigenstates=("r", "g"),
        n_qudits=n,
        operations=[(1.0, [({"rr": 1.0}, [0])])],
    )
    config = TorchConfig(
        observables=[
            Occupation(evaluation_times=[1.0]),
            CorrelationMatrix(evaluation_times=[1.0]),
            Expectation(zop, evaluation_times=[1.0]),
            BitStrings(evaluation_times=[1.0], num_shots=111),
        ],
        torch_device="cpu",
    )
    results = daemon.run_backend(seq, config=config, seed=5)
    occ = results.occupation[-1]
    assert np.asarray(occ).shape == (n,)
    corr = np.asarray(results.correlation_matrix[-1])
    assert corr.shape == (n, n)
    exp = results.expectation[-1]
    assert np.isfinite(complex(np.asarray(exp)).real)
    shots = results.bitstrings[-1]
    assert sum(shots.values()) == 111

    # Direct (in-process) reference: identical seeded pipeline
    np.random.seed(5)
    direct = TorchBackendV2(seq, config=config).run()
    np.testing.assert_allclose(
        np.asarray(occ), np.asarray(direct.occupation[-1]), atol=1e-7
    )
    np.testing.assert_allclose(
        corr, np.asarray(direct.correlation_matrix[-1]), atol=1e-7
    )
    assert dict(shots) == dict(direct.bitstrings[-1])

    # Raw-string mode needs no deserialization support client-side
    raw = daemon.run_backend(seq, config=config, deserialize=False)
    assert isinstance(raw, str) and '"occupation"' in raw


def test_concurrent_clients_no_interleaving(daemon):
    """Two clients hammering one daemon concurrently each get their
    own correct, uncorrupted responses (requests serialize at
    connection granularity)."""
    seq_a = _small_seq()
    reg_b = P.Register.rectangle(1, 2, spacing=8.0, prefix="q")
    seq_b = P.Sequence(reg_b, P.MockDevice)
    seq_b.declare_channel("ryd", "rydberg_global")
    seq_b.add(P.Pulse.ConstantPulse(300, 1.0, 0.0, 0.0), "ryd")
    results: dict[str, list] = {"a": [], "b": []}
    errors: list = []

    def worker(tag, seq, dim):
        client = serving.SolveClient(daemon.socket_path)
        try:
            for _ in range(4):
                out = client.run(
                    seq, evaluation_times="Minimal", final_only=True
                )
                assert out["states"].shape == (1, dim)
                np.testing.assert_allclose(
                    np.linalg.norm(out["states"][0]), 1.0, atol=1e-6
                )
                results[tag].append(out["states"][0])
        except Exception as err:  # noqa: BLE001
            errors.append((tag, err))

    threads = [
        threading.Thread(target=worker, args=("a", seq_a, 8)),
        threading.Thread(target=worker, args=("b", seq_b, 4)),
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    assert len(results["a"]) == len(results["b"]) == 4
    # Every repeat of the same request returns the same state
    for tag in ("a", "b"):
        for st in results[tag][1:]:
            np.testing.assert_allclose(st, results[tag][0], atol=1e-7)


# -- across packages ------------------------------------------------------


def _one_minus_f(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return 1 - np.abs(np.sum(np.conj(a) * b, axis=-1)) ** 2 / (
        np.sum(np.abs(a) ** 2, axis=-1) * np.sum(np.abs(b) ** 2, axis=-1)
    )


#: One request of each kind, sent as the same JSON to both daemons:
#: (name, the client method, its keyword arguments).
NOISE = pulser_tpu.NoiseModel(
    amp_sigma=0.02, p_false_pos=0.01, runs=5, samples_per_run=2
)
DEPHASING = pulser_tpu.NoiseModel(
    dephasing_rate=0.05, amp_sigma=0.02, runs=5, samples_per_run=2
)
REQUESTS = [
    ("states", "run", dict(evaluation_times="Full")),
    ("final_only", "run", dict(final_only=True)),
    ("noiseless_counts", "run", dict(seed=3, n_samples=300)),
    (
        "batch_counts",
        "run",
        dict(
            noise_model=NOISE.to_abstract_repr(),
            evaluation_times="Minimal",
            seed=11,
            n_samples=300,
        ),
    ),
    (
        "jump_counts",
        "run",
        dict(
            noise_model=DEPHASING.to_abstract_repr(),
            evaluation_times="Minimal",
            seed=12,
            n_samples=300,
        ),
    ),
    ("backend", "run_backend", dict(seed=5)),
]


def _backend_config() -> str:
    from pulser_tpu.backend import BitStrings, Occupation
    from pulser_tpu.emulator.tpu_config import TpuConfig

    return TpuConfig(
        observables=[
            Occupation(evaluation_times=[0.5, 1.0]),
            BitStrings(evaluation_times=[1.0], num_shots=200),
        ]
    ).to_abstract_repr()


def _ask(client, method: str, kwargs: dict):
    seq = _small_seq(pulser_tpu).to_abstract_repr()
    if method == "run_backend":
        return client.run_backend(
            seq, config=_backend_config(), deserialize=False, **kwargs
        )
    return client.run(seq, **kwargs)


def _assert_same_answer(name: str, got, want) -> None:
    if name == "backend":
        got_r = P.backend.results.Results.from_abstract_repr(got)
        want_r = P.backend.results.Results.from_abstract_repr(want)
        for t in (0.5, 1.0):
            np.testing.assert_allclose(
                np.asarray(got_r.get_result("occupation", t)),
                np.asarray(want_r.get_result("occupation", t)),
                atol=1e-6,
            )
        assert dict(got_r.final_bitstrings) == dict(
            want_r.final_bitstrings
        )
    elif "counts" in want:
        assert got["counts"] == want["counts"]
    else:
        assert got["states"].shape == want["states"].shape
        assert (_one_minus_f(got["states"], want["states"]) <= 1e-6).all()
        np.testing.assert_allclose(got["eval_times"], want["eval_times"])


@pytest.fixture()
def float64():
    """The port in complex128, as the JAX package under the test
    configuration's ``jax_enable_x64``."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


@pytest.mark.parametrize(
    "name,method,kwargs", REQUESTS, ids=[r[0] for r in REQUESTS]
)
def test_jax_client_to_torch_daemon(
    daemon, jax_daemon, float64, name, method, kwargs
):
    """The JAX package's client, unchanged, gets the port's daemon to
    answer as the JAX daemon does."""
    got = _ask(pulser_tpu.serving.SolveClient(daemon.socket_path), method,
               kwargs)
    want = _ask(pulser_tpu.serving.SolveClient(jax_daemon), method, kwargs)
    _assert_same_answer(name, got, want)


@pytest.mark.parametrize(
    "name,method,kwargs", REQUESTS, ids=[r[0] for r in REQUESTS]
)
def test_torch_client_to_jax_daemon(
    daemon, jax_daemon, float64, name, method, kwargs
):
    """The port's client gets the JAX daemon to answer as the port's
    daemon does; its ``run_backend`` decodes into the port's Results."""
    got = _ask(serving.SolveClient(jax_daemon), method, kwargs)
    want = _ask(daemon, method, kwargs)
    _assert_same_answer(name, got, want)
    if method == "run_backend":
        decoded = serving.SolveClient(jax_daemon).run_backend(
            _small_seq(pulser_tpu), config=_backend_config(), seed=5
        )
        assert isinstance(decoded, P.backend.results.Results)


# -- the thin client, the refusal, a failing request ----------------------

_PATH_CLIENT = """
import importlib.util, json, sys
sys.modules["torch"] = None
sys.modules["jax"] = None
spec = importlib.util.spec_from_file_location("thin_serving", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
out = mod.SolveClient(sys.argv[2]).run(
    open(sys.argv[3]).read(), evaluation_times="Minimal", final_only=True
)
print(json.dumps({
    "re": out["states"].real.tolist(), "im": out["states"].imag.tolist(),
    "modules": sorted(m for m in sys.modules
                      if m.split(".")[0] in ("torch", "jax", "pulser_tpu",
                                             "pulser_tpu_torch")
                      and sys.modules[m] is not None),
}))
"""


def test_path_loaded_client_needs_no_torch(daemon, tmp_path):
    """A fresh interpreter with ``torch`` and ``jax`` blocked loads
    ``serving.py`` by its file path and gets a solve from the daemon."""
    import json

    seq = _small_seq()
    payload = tmp_path / "seq.json"
    payload.write_text(seq.to_abstract_repr())
    out = subprocess.run(
        [
            sys.executable,
            "-c",
            _PATH_CLIENT,
            os.path.join(REPO, "pulser_tpu_torch", "serving.py"),
            daemon.socket_path,
            str(payload),
        ],
        capture_output=True,
        text=True,
        timeout=120,
        cwd=str(tmp_path),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout)
    assert got["modules"] == []
    state = np.asarray(got["re"]) + 1j * np.asarray(got["im"])
    direct = TorchEmulator.from_sequence(
        seq, evaluation_times="Minimal", torch_device="cpu"
    ).run()
    assert _one_minus_f(state[0], direct.states[-1].full()[:, 0]) <= 1e-6


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_serve_without_a_card_refuses_before_binding(tmp_path):
    path = str(tmp_path / "refused.sock")
    with pytest.raises(RuntimeError, match="No CUDA device is visible"):
        serving.serve(path)
    assert not os.path.exists(path)
    out = subprocess.run(
        [sys.executable, "-m", "pulser_tpu_torch.serving", "--socket", path],
        capture_output=True,
        text=True,
        timeout=120,
        cwd=REPO,
    )
    assert out.returncode != 0
    assert "No CUDA device is visible" in out.stderr
    assert not os.path.exists(path)
    client = serving.SolveClient(path)
    assert not client.ensure_server(spawn_timeout=60)
    assert client.process.wait(timeout=60) != 0


def test_failing_request_leaves_the_daemon_serving(daemon):
    bad = daemon._request({"kind": "run_sequence", "sequence": "{}"})
    assert bad["ok"] is False and bad["error"]
    bad = daemon._request(
        {"kind": "run_backend", "sequence": _small_seq().to_abstract_repr(),
         "config": "not json"}
    )
    assert bad["ok"] is False and bad["error"]
    assert daemon.ping()
    out = daemon.run(_small_seq(), final_only=True)
    assert out["states"].shape == (1, 8)


def test_module_entry_on_the_cpu(tmp_path):
    """``ensure_server(device="cpu")`` spawns ``python -m
    pulser_tpu_torch.serving --device cpu``, which answers and exits 0
    on shutdown."""
    client = serving.SolveClient(str(tmp_path / "spawned.sock"))
    env = dict(os.environ, PYTHONPATH=REPO)
    try:
        assert client.ensure_server(spawn_timeout=120, env=env, device="cpu")
        out = client.run(_small_seq(), final_only=True)
        assert out["states"].shape == (1, 8)
    finally:
        client.shutdown()
    assert client.process.wait(timeout=60) == 0
