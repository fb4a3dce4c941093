"""Resident solve server: warm emulation on the card for fresh processes.

Port of ``pulser_tpu/serving.py``. A fresh process that emulates one
sequence pays, before its solve, for the torch import, the CUDA context,
loading the kernel libraries and planning. The cost is per process, so
the answer is the same as every serving stack's: keep ONE process
resident with the card initialised and the kernels loaded, and let fresh
client processes submit work to it.

The daemon listens on a unix socket and solves sequences shipped in the
package's own abstract representation (the wire format the reference
uses for its cloud backends, ``pulser-core/pulser/backend/remote.py``);
results return as compressed npz payloads. A thin client —
:class:`SolveClient` — needs no torch at all (this module imports only
the standard library at module level, so a client can load the file by
path), and a fresh process pays only the solve plus the socket.

Protocol: length-prefixed JSON frames over ``AF_UNIX`` (local,
same-user trust domain; no pickle anywhere), byte-compatible with the
JAX package's daemon: a client of either package talks to a daemon of
either package. Requests::

    {"kind": "ping"}
    {"kind": "run_sequence", "sequence": <abstract-repr str>,
     "noise_model": <abstract-repr str | null>,
     "evaluation_times": [..] | str | null,
     "with_modulation": bool, "seed": int | null,
     "n_samples": int | null,   # sample instead of returning states
     "final_only": bool}
    {"kind": "run_backend", "sequence": <abstract-repr str>,
     "config": <EmulationConfig abstract-repr str | null>,
     "mimic_qpu": bool, "seed": int | null}
    {"kind": "shutdown"}

Responses carry ``ok`` and, as asked, ``states_npz`` (base64 of an npz
with ``states``, complex64 ``(n_eval, dim)``, and ``eval_times``),
``counts``, ``results_repr`` (the backend's
:class:`~pulser_tpu_torch.backend.Results` in its abstract
representation), ``warnings`` or ``error``.

The daemon marks its own host phases in :mod:`pulser_tpu_torch.profiling`
beside the emulator's: ``serving.decode`` (the abstract repr into
objects), ``serving.solve`` (the emulator or backend built and run, the
states or counts fetched), ``serving.encode`` (the npz or the results'
JSON), so ``profiling.phase_report()`` in the daemon's process splits a
served request's host time (the rest is the response's JSON and the
socket).

Every request runs on the daemon's torch device, which :func:`serve`
resolves before it binds the socket: the card by default (without one
it raises), the CPU only when asked (``device="cpu"``). Connections are
served one request at a time; clients open one connection per request
(:meth:`SolveClient._request`), so concurrent clients interleave at
request granularity with no shared mutable state between them.

Start a daemon with ``python -m pulser_tpu_torch.serving --socket PATH``
(``--device cpu`` without a card) or programmatically via :func:`serve`;
or let :meth:`SolveClient.ensure_server` spawn one on demand (the
spawned daemon pays the cold start once; every later process is warm).
"""

from __future__ import annotations

import base64
import io
import json
import os
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any

__all__ = ["serve", "SolveClient", "default_socket_path"]

_LEN = struct.Struct(">Q")
_MAX_FRAME = 1 << 31  # 2 GiB: above any sane states payload


def default_socket_path() -> str:
    """The default daemon socket (per-user, in the temp dir; apart from
    the JAX package's, so that both daemons can run side by side)."""
    return os.environ.get(
        "PULSER_TPU_TORCH_SERVE_SOCKET",
        os.path.join(
            tempfile.gettempdir(),
            f"pulser_tpu_torch_serve_{os.getuid()}.sock",
        ),
    )


def _send_frame(conn: socket.socket, payload: bytes) -> None:
    conn.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(conn: socket.socket, count: int) -> bytes:
    parts = []
    while count:
        chunk = conn.recv(min(count, 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        parts.append(chunk)
        count -= len(chunk)
    return b"".join(parts)


def _recv_frame(conn: socket.socket) -> bytes:
    (length,) = _LEN.unpack(_recv_exact(conn, _LEN.size))
    if length > _MAX_FRAME:
        raise ValueError(f"frame too large: {length}")
    return _recv_exact(conn, length)


def _npz_b64(**arrays: Any) -> str:
    import numpy as np

    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return base64.b64encode(buf.getvalue()).decode("ascii")


def _b64_npz(blob: str) -> dict[str, Any]:
    import numpy as np

    data = np.load(io.BytesIO(base64.b64decode(blob)))
    return {k: data[k] for k in data.files}


def _handle_run(req: dict[str, Any], device: Any) -> dict[str, Any]:
    """Executes one run_sequence request in the resident process.

    Warnings raised by the solve are captured and shipped to the
    client in the response (a daemon's stderr is nobody's console).
    """
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = _run_inner(req, device)
    if caught:
        out["warnings"] = [str(w.message) for w in caught]
    return out


def _run_inner(req: dict[str, Any], device: Any) -> dict[str, Any]:
    import numpy as np

    from pulser_tpu_torch import NoiseModel, Sequence, profiling
    from pulser_tpu_torch.emulator import TorchEmulator

    with profiling.phase("serving.decode"):
        seq = Sequence.from_abstract_repr(req["sequence"])
        noise = (
            NoiseModel.from_abstract_repr(req["noise_model"])
            if req.get("noise_model")
            else None
        )
    eval_times = req.get("evaluation_times")
    if isinstance(eval_times, list):
        eval_times = np.asarray(eval_times)
    kwargs: dict[str, Any] = {}
    if eval_times is not None:
        kwargs["evaluation_times"] = eval_times
    if noise is not None:
        kwargs["noise_model"] = noise
    out: dict[str, Any] = {"ok": True}
    n_samples = req.get("n_samples")
    final_only = bool(req.get("final_only"))
    with profiling.phase("serving.solve"):
        # The emulator draws from numpy's global generator, as the JAX
        # package's does: the same seed gives the same counts
        if req.get("seed") is not None:
            np.random.seed(int(req["seed"]))
        sim = TorchEmulator.from_sequence(
            seq,
            with_modulation=bool(req.get("with_modulation", False)),
            torch_device=device,
            **kwargs,
        )
        res = sim.run()
        if n_samples:
            out["counts"] = dict(res.sample_final_state(int(n_samples)))
        else:
            wanted = res.states[-1:] if final_only else res.states
            states = np.stack(
                [
                    np.asarray(s.full()[:, 0], dtype=np.complex64)
                    for s in wanted
                ]
            )  # (n_eval, dim)
    if not n_samples:
        with profiling.phase("serving.encode"):
            out["states_npz"] = _npz_b64(
                states=states,
                eval_times=np.asarray(sim.evaluation_times)[
                    -1 if final_only else 0 :
                ],
            )
    return out


def _handle_backend(req: dict[str, Any], device: Any) -> dict[str, Any]:
    """Executes one backend-v2 run in the resident process.

    The full Observable/Callback pipeline runs daemon-side — the
    shipped ``EmulationConfig`` carries the observables (expectation
    values, correlation matrices, occupation, energies, bitstrings,
    fidelities) — and the resulting
    :class:`~pulser_tpu_torch.backend.Results` returns in its abstract
    representation, the same wire format the reference's cloud
    backends exchange (``pulser-core/pulser/backend/results.py``
    round trip). The torch device is not part of a config's wire form:
    the daemon sets its own.
    """
    import warnings

    import numpy as np

    from pulser_tpu_torch import Sequence, profiling
    from pulser_tpu_torch.emulator import TorchBackendV2
    from pulser_tpu_torch.emulator.torch_config import TorchConfig

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with profiling.phase("serving.decode"):
            seq = Sequence.from_abstract_repr(req["sequence"])
            config = (
                TorchConfig.from_abstract_repr(req["config"])
                if req.get("config")
                else TorchBackendV2.default_config
            )
    with warnings.catch_warnings():
        # Rebuilding the config repeats the warnings its load gave
        warnings.simplefilter("ignore")
        config = config.with_changes(torch_device=device)
    with warnings.catch_warnings(record=True) as caught_run:
        warnings.simplefilter("always")
        with profiling.phase("serving.solve"):
            if req.get("seed") is not None:
                np.random.seed(int(req["seed"]))
            results = TorchBackendV2(
                seq,
                config=config,
                mimic_qpu=bool(req.get("mimic_qpu", False)),
            ).run()
        with profiling.phase("serving.encode"):
            results_repr = results.to_abstract_repr()
    out: dict[str, Any] = {"ok": True, "results_repr": results_repr}
    if caught or caught_run:
        out["warnings"] = [str(w.message) for w in [*caught, *caught_run]]
    return out


def _handle(
    req: dict[str, Any], device: Any
) -> tuple[dict[str, Any], bool]:
    """Returns (response, keep_serving)."""
    kind = req.get("kind")
    if kind == "ping":
        return {"ok": True, "pid": os.getpid()}, True
    if kind == "shutdown":
        return {"ok": True}, False
    if kind in ("run_sequence", "run_backend"):
        handler = (
            _handle_run if kind == "run_sequence" else _handle_backend
        )
        try:
            return handler(req, device), True
        except Exception as err:  # noqa: BLE001 — shipped to client
            return (
                {"ok": False, "error": f"{type(err).__name__}: {err}"},
                True,
            )
    return {"ok": False, "error": f"unknown kind: {kind!r}"}, True


def serve(
    socket_path: str | None = None,
    *,
    warm_request: dict[str, Any] | None = None,
    ready_event: threading.Event | None = None,
    device: Any = None,
) -> None:
    """Runs the solve daemon until a shutdown request arrives.

    Args:
        socket_path: Unix-socket path (default
            :func:`default_socket_path`). A stale socket file is
            replaced.
        warm_request: Optional ``run_sequence`` request executed
            before accepting clients, so the first client gets a warm
            solve (the daemon pays the CUDA context, the kernel
            libraries' load and the first plan here). If it fails, the
            daemon stops with a ``RuntimeError`` instead of serving.
        ready_event: Set once the socket is listening (and the warm
            request, if any, has completed) — for in-process servers
            in tests and benchmarks.
        device: The torch device every request runs on (default: the
            first CUDA device; ``"cpu"`` must be asked for).

    Raises:
        RuntimeError: ``device`` is None and no CUDA device is visible;
            raised before the socket is bound.
    """
    from pulser_tpu_torch.ops.solver import _resolve_device

    torch_device = _resolve_device(device)
    path = socket_path or default_socket_path()
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        srv.bind(path)
        srv.listen(4)
        if warm_request is not None:
            warm, _ = _handle(
                dict(warm_request, kind="run_sequence"), torch_device
            )
            if not warm["ok"]:
                raise RuntimeError(f"warm request failed: {warm['error']}")
        if ready_event is not None:
            ready_event.set()
        serving = True
        while serving:
            conn, _ = srv.accept()
            with conn:
                try:
                    while True:
                        req = json.loads(_recv_frame(conn).decode())
                        resp, serving = _handle(req, torch_device)
                        _send_frame(conn, json.dumps(resp).encode())
                        if not serving:
                            break
                except (ConnectionError, json.JSONDecodeError):
                    continue
    finally:
        srv.close()
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass


class SolveClient:
    """Thin client for the resident solve daemon (no torch imports).

    Attributes:
        process: The daemon :meth:`ensure_server` spawned, if it spawned
            one (a ``subprocess.Popen``), else None.
    """

    def __init__(self, socket_path: str | None = None):
        self.socket_path = socket_path or default_socket_path()
        self.process: subprocess.Popen | None = None

    def _request(
        self, req: dict[str, Any], timeout: float = 600.0
    ) -> dict[str, Any]:
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as conn:
            conn.settimeout(timeout)
            conn.connect(self.socket_path)
            _send_frame(conn, json.dumps(req).encode())
            return json.loads(_recv_frame(conn).decode())

    def ping(self, timeout: float = 5.0) -> bool:
        try:
            return bool(self._request({"kind": "ping"}, timeout)["ok"])
        except OSError:
            return False

    def shutdown(self) -> None:
        try:
            self._request({"kind": "shutdown"}, timeout=10.0)
        except OSError:
            pass

    def run(
        self,
        sequence: Any,
        *,
        noise_model: Any = None,
        evaluation_times: Any = None,
        with_modulation: bool = False,
        seed: int | None = None,
        n_samples: int | None = None,
        final_only: bool = False,
        timeout: float = 600.0,
    ) -> dict[str, Any]:
        """Solves a sequence on the daemon.

        ``sequence``/``noise_model`` may be objects (serialized via
        their ``to_abstract_repr``) or already-serialized strings, so
        thin clients never import torch.

        Returns ``{"states": (n_eval, dim) complex64, "eval_times":
        (n_eval,)}``, or ``{"counts": {bitstring: n}}`` when
        ``n_samples`` is given.
        """
        if hasattr(sequence, "to_abstract_repr"):
            sequence = sequence.to_abstract_repr()
        if noise_model is not None and hasattr(
            noise_model, "to_abstract_repr"
        ):
            noise_model = noise_model.to_abstract_repr()
        if hasattr(evaluation_times, "tolist"):
            evaluation_times = evaluation_times.tolist()
        resp = self._request(
            {
                "kind": "run_sequence",
                "sequence": sequence,
                "noise_model": noise_model,
                "evaluation_times": evaluation_times,
                "with_modulation": with_modulation,
                "seed": seed,
                "n_samples": n_samples,
                "final_only": final_only,
            },
            timeout,
        )
        if not resp.get("ok"):
            raise RuntimeError(
                f"daemon error: {resp.get('error', 'unknown')}"
            )
        if "counts" in resp:
            return {"counts": resp["counts"]}
        arrays = _b64_npz(resp["states_npz"])
        return {
            "states": arrays["states"],
            "eval_times": arrays["eval_times"],
        }

    def run_backend(
        self,
        sequence: Any,
        *,
        config: Any = None,
        mimic_qpu: bool = False,
        seed: int | None = None,
        deserialize: bool = True,
        timeout: float = 600.0,
    ) -> Any:
        """Runs the backend-v2 Observable/Results pipeline on the
        daemon.

        ``sequence``/``config`` may be objects (serialized via their
        ``to_abstract_repr``) or already-serialized strings.

        Returns a :class:`pulser_tpu_torch.backend.Results` (expectation
        values, correlation matrices, bitstrings, ... keyed by
        observable tag), or — with ``deserialize=False`` — its raw
        abstract-repr JSON string, which needs no package import on
        the client side.
        """
        if hasattr(sequence, "to_abstract_repr"):
            sequence = sequence.to_abstract_repr()
        if config is not None and hasattr(config, "to_abstract_repr"):
            config = config.to_abstract_repr()
        resp = self._request(
            {
                "kind": "run_backend",
                "sequence": sequence,
                "config": config,
                "mimic_qpu": mimic_qpu,
                "seed": seed,
            },
            timeout,
        )
        if not resp.get("ok"):
            raise RuntimeError(
                f"daemon error: {resp.get('error', 'unknown')}"
            )
        if not deserialize:
            return resp["results_repr"]
        from pulser_tpu_torch.backend.results import Results

        return Results.from_abstract_repr(resp["results_repr"])

    def ensure_server(
        self,
        spawn_timeout: float = 1800.0,
        env: dict[str, str] | None = None,
        device: str | None = None,
    ) -> bool:
        """Pings the daemon, spawning ``python -m
        pulser_tpu_torch.serving`` if absent.

        The spawned daemon pays the cold start once and runs on
        ``device`` (default: the card; without one it exits non-zero).
        It is detached (it survives this process) and kept in
        :attr:`process`. Returns True when a server is reachable, False
        if the spawned daemon exited or did not answer in time.
        """
        if self.ping():
            return True
        command = [
            sys.executable,
            "-m",
            "pulser_tpu_torch.serving",
            "--socket",
            self.socket_path,
        ]
        if device is not None:
            command += ["--device", str(device)]
        self.process = subprocess.Popen(
            command,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
            start_new_session=True,
            env=env or os.environ.copy(),
        )
        deadline = time.monotonic() + spawn_timeout
        while time.monotonic() < deadline:
            if self.ping():
                return True
            if self.process.poll() is not None:
                return False
            time.sleep(0.05)
        return False


def _main() -> None:
    import argparse

    parser = argparse.ArgumentParser(
        description="pulser_tpu_torch resident solve daemon"
    )
    parser.add_argument("--socket", default=None)
    parser.add_argument(
        "--device",
        default=None,
        help="torch device to run on (default: the CUDA card; 'cpu' to"
        " run without one)",
    )
    args = parser.parse_args()
    try:
        serve(args.socket, device=args.device)
    except RuntimeError as err:
        sys.exit(f"pulser_tpu_torch.serving: {err}")


if __name__ == "__main__":
    _main()
