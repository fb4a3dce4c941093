"""Runs one scenario through pulser_tpu and through pulser_tpu_torch.

A scenario is a function of a package namespace (:data:`JAX` or
:data:`TORCH`) that returns what it observed, or raises. :func:`outcome`
runs it with the numpy global RNG seeded, the warnings recorded and, for
the port, torch's default dtype at float64 (the counterpart of the test
configuration's ``jax_enable_x64``) and the CPU asked for; :func:`assert_parity`
requires both packages to return equal values (numbers within a stated
tolerance, counters and strings exactly), or to raise the same exception
type with the same message, and to warn alike. Messages are compared with
the package and class names (``Tpu``/``Torch``) blanked.
"""

from __future__ import annotations

import re
import types
import uuid
import warnings
from collections import Counter
from typing import Any, Callable

import numpy as np
import torch

import pulser_tpu
import pulser_tpu.backend
import pulser_tpu.backend.aggregators
import pulser_tpu.backend.config
import pulser_tpu.backend.default_observables
import pulser_tpu.backend.results
import pulser_tpu.emulator
import pulser_tpu.emulator.qobj
import pulser_tpu.exceptions.serialization
import pulser_tpu.sampler
import pulser_tpu_torch
import pulser_tpu_torch.backend
import pulser_tpu_torch.backend.aggregators
import pulser_tpu_torch.backend.config
import pulser_tpu_torch.backend.default_observables
import pulser_tpu_torch.backend.results
import pulser_tpu_torch.emulator
import pulser_tpu_torch.emulator.qobj
import pulser_tpu_torch.exceptions.serialization
import pulser_tpu_torch.sampler


def _namespace(root: Any, tag: str, prefix: str, kw: dict) -> Any:
    emu = root.emulator
    return types.SimpleNamespace(
        name=tag,
        pkg=root,
        backend=root.backend,
        obs=root.backend.default_observables,
        results=root.backend.results,
        config=root.backend.config,
        aggregators=root.backend.aggregators,
        errors=root.exceptions.serialization,
        emulator=emu,
        State=getattr(emu, f"{prefix}State"),
        Operator=getattr(emu, f"{prefix}Operator"),
        Config=getattr(emu, f"{prefix}Config"),
        Backend=getattr(emu, f"{prefix}Backend"),
        BackendV2=getattr(emu, f"{prefix}BackendV2"),
        Emulator=getattr(emu, f"{prefix}Emulator"),
        Solver=emu.Solver,
        Qobj=emu.Qobj,
        basis=emu.basis,
        qeye=emu.qeye,
        tensor=emu.tensor,
        sample=root.sampler.sample,
        #: Keyword arguments that put a config, emulator or v1 backend on
        #: the test's device.
        kw=kw,
    )


JAX = _namespace(pulser_tpu, "jax", "Tpu", {})
TORCH = _namespace(pulser_tpu_torch, "torch", "Torch", {"torch_device": "cpu"})

_NAMES = re.compile(r"pulser_tpu_torch|pulser_tpu|Torch|Tpu|torch|tpu|jax")


def _normalize(msg: str) -> str:
    msg = _NAMES.sub("#", msg)
    # Object reprs carry their address, observable reprs their UUID
    msg = re.sub(r"[0-9a-f]{8}(-[0-9a-f]{4}){3}-[0-9a-f]{12}", "<uuid>", msg)
    return re.sub(r" at 0x[0-9a-f]+", "", msg)


def plain(value: Any) -> Any:
    """A package-independent form of a returned value."""
    if isinstance(value, (JAX.State, TORCH.State)):
        return ("state", value.eigenstates, value.to_qobj().full())
    if isinstance(value, (JAX.Operator, TORCH.Operator)):
        return ("operator", value.eigenstates, value.to_qobj().full())
    if isinstance(value, (JAX.Qobj, TORCH.Qobj)):
        return value.full()
    if isinstance(value, (JAX.results.Results, TORCH.results.Results)):
        return (
            "results",
            value.atom_order,
            value.total_duration,
            {
                tag: (value.get_result_times(tag), plain(getattr(value, tag)))
                for tag in value.get_result_tags()
            },
        )
    if isinstance(value, Counter):
        return ("counter", dict(value))
    if isinstance(value, dict):
        return {k: plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [plain(v) for v in value]
    if isinstance(value, (set, frozenset)):
        return ("set", sorted(value))
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if hasattr(value, "__array__") and not isinstance(value, np.ndarray):
        return np.asarray(value)
    if isinstance(value, (np.bool_, bool)):
        return bool(value)
    if isinstance(value, uuid.UUID):
        return "uuid"
    if isinstance(value, types.SimpleNamespace):
        return plain(vars(value))
    if isinstance(value, type):
        return _normalize(value.__name__)
    if isinstance(value, str):
        return _normalize(value)
    return value


def outcome(
    case: Callable[[Any], Any], ns: Any, seed: int = 1234, double: bool = True
) -> tuple:
    """``("ok", value, warnings)`` or ``("raise", type, message,
    warnings)`` of one scenario in one package (the port in float64
    unless ``double`` is False)."""
    old = torch.get_default_dtype()
    np.random.seed(seed)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if ns is TORCH and double:
            torch.set_default_dtype(torch.float64)
        try:
            value = case(ns)
            result: tuple = ("ok", plain(value))
        except Exception as err:  # the raise is part of the outcome
            result = ("raise", type(err).__name__, _normalize(str(err)))
        finally:
            torch.set_default_dtype(old)
    seen = sorted(
        {(w.category.__name__, _normalize(str(w.message))) for w in caught}
    )
    return result + (seen,)


def _assert_close(a: Any, b: Any, tol: float, where: str) -> None:
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), where
        for k in a:
            _assert_close(a[k], b[k], tol, f"{where}[{k!r}]")
        return
    if isinstance(a, (list, tuple)) and not (
        a and isinstance(a[0], (int, float, complex, np.number))
        and all(isinstance(x, (int, float, complex, np.number)) for x in a)
    ):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_close(x, y, tol, f"{where}[{i}]")
        return
    if isinstance(a, (str, bool, type(None))) or isinstance(b, str):
        assert a == b, f"{where}: {a!r} != {b!r}"
        return
    xa, xb = np.asarray(a), np.asarray(b)
    assert xa.shape == xb.shape, f"{where}: shapes {xa.shape} {xb.shape}"
    if xa.dtype.kind in "iub" and xb.dtype.kind in "iub":
        assert np.array_equal(xa, xb), where
        return
    err = np.max(np.abs(xa.astype(complex) - xb.astype(complex)), initial=0)
    assert err <= tol, f"{where}: max |Δ| = {err} > {tol}"


def assert_parity(
    case: Callable[[Any], Any],
    tol: float = 1e-6,
    seed: int = 1234,
    message: str | None = None,
    double: bool = True,
) -> tuple:
    """Runs ``case`` in both packages and requires the same outcome;
    returns the port's. Where the port words an error differently (it
    accepts torch tensors too), ``message`` is a pattern both messages
    must match instead of being equal."""
    ours = outcome(case, TORCH, seed, double)
    ref = outcome(case, JAX, seed)
    assert ours[0] == ref[0], f"JAX: {ref}\nport: {ours}"
    assert ours[-1] == ref[-1], f"warnings: JAX {ref[-1]}, port {ours[-1]}"
    if ref[0] == "raise" and message is not None:
        assert ours[1] == ref[1], f"JAX: {ref}\nport: {ours}"
        assert re.search(message, ours[2]) and re.search(message, ref[2])
    elif ref[0] == "raise":
        assert ours[1:3] == ref[1:3], f"JAX: {ref}\nport: {ours}"
    else:
        _assert_close(ref[1], ours[1], tol, "value")
    return ours


class StubMesh:
    """A mesh of ``size`` ranks, for the refusals of a malformed mesh,
    which read only its size (no process group is needed to be refused)."""

    def __init__(self, size: int):
        self._size = size

    def size(self) -> int:
        return self._size


def assert_lindblad_policy_matches(temu: Any, jemu: Any, tb: Any, jb: Any):
    """The batched dissipative run's step policy on a factored batch: the
    port's one home (``TorchEmulator._step_policy``, fed the rank factors'
    stiffness and marks) against the JAX package's
    ``_lindblad_batch_prep`` written out from its own methods. The same
    sticky steps, the same coarsening from the noiseless Hamiltonian and
    the same breakpoints, bit for bit."""
    knots = np.asarray(jb.template.sampling_times)
    amp_j, det_j, marks_j = jemu._factored_policy(jb, knots)
    reps = len(jb.reps)
    diag = np.max(np.abs(np.asarray(jb.diags).reshape(reps, -1)), axis=1)
    lam = float(np.max(np.asarray(amp_j) + diag + np.asarray(det_j)))
    opts_t: dict = {}
    opts_j: dict = {}
    temu._validate_options(opts_t)
    jemu._validate_options(opts_j)
    base = min(float(np.median(np.diff(knots))), 1e-3)
    fine = jemu._sticky_quantized_step(
        "lindblad_batch", base, 0.8 / max(1.3 * lam, 1e-9)
    )
    if opts_j.get("max_step"):
        fine = min(fine, float(opts_j["max_step"]))
    ham0 = jemu._noiseless_hamiltonian
    lam0 = float(np.sum(2 * np.max(np.abs(ham0.amp_coeffs), axis=(1, 2))))
    want = jemu._coarse_ip_step(
        "mcwf_coarse", fine, lam0, [ham0], opts_j, margin=1.3
    )
    marks_t = temu._factored_policy(tb, knots)[2]
    got = temu._step_policy(
        tb.template, lam, "lindblad_batch", 1.3, marks_t, opts_t
    )
    assert (got.max_step, got.coarsen) == want and got.coarsen
    assert got.mcwf_ip and not got.mesolve_ip
    assert temu._sticky_steps == jemu._sticky_steps
    marks = got.breakpoints()
    assert (marks is None) == (marks_j is None)
    if marks_j is not None:
        assert np.array_equal(marks, np.asarray(marks_j))
