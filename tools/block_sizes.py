"""Times K1, its trajectory-batched mode, K2 and K3 at several
thread-block sizes and register policies, in turns, on one CUDA card.

K1 (``csrc/ip_sesolve.cu``) runs the AFM16 sweep, the batched K1
(``csrc/ip_sesolve_batched.cu``, ``kThreads``) the SPD10 batch and, like
K2 below, 100 random trajectories of 254 steps at n = 11, 12 and 13, K2
(``csrc/mcwf_rows.cu``) the NOISY10 quantum-jump batch, K3
(``csrc/mcwf.cu``) the PAULI10 batch, each on its main path's own inputs
at 256, 512 and 1024 threads per block (``kMaxThreads``). K2 also runs
100 random trajectories of 254 steps at n = 11, 12 and 13, where a
thread owns 2 to 16 amplitudes: 512 or 1024 threads, and from how many
amplitudes per thread on the stage input and the diagonal leave the
registers (``kLeanFromAmps``) and the RK4 accumulator moves to shared
memory (``kSharedAccFromAmps``).

Each variant is the kernel's source with those constants changed, built
with nvcc for ``sm_90a`` into ``pulser_tpu_torch/build/`` and called
through the package's wrapper; every result is checked against the
shipped kernel's.

The group ``ip_sesolve_batched_cluster`` times the batched K1 for n = 14
to 17, one thread-block cluster a trajectory, in the block shapes
``ip_sesolve_batched.cu`` ships (``kernels.IP_BATCHED_SHAPES``) and, for
n = 14 to 16, in the other block size (blocks of 2^13 amplitudes and
1024 threads, or of 2^12 and 512 threads, two an SM), on the inputs of
SPD16 with 100 trajectories and on 100 random trajectories of 254 steps
at each n. With ``--cooperative-from DIR``, a checkout of an earlier
tree whose ``ip_sesolve.cu`` still has the cooperative batched entry
``ip_sesolve_run_batched`` (commit 226f313's: ``git archive 226f313 |
tar -x -C DIR``), that kernel, which runs the trajectories one after
another, is timed on the same inputs in the same turns.

Run from the repository root on a machine with the card::

    python3 tools/block_sizes.py [group ...] [--cooperative-from DIR]

With no group every group of :data:`GROUPS` runs (a few minutes).
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import chip_smoke  # noqa: E402
import pulser_tpu_torch.ops.kernels as K  # noqa: E402
from pulser_tpu_torch.emulator import TorchEmulator  # noqa: E402
from pulser_tpu_torch.ops import solver as S  # noqa: E402

#: Every register-resident policy: no thread owns this many amplitudes.
_NEVER = 64
#: Per group: the kernel, the qubit counts whose instantiations the
#: variants keep (None: all) and the variants, ``label -> constants
#: changed`` (the first is the shipped source).
GROUPS = {
    "ip_sesolve": (
        "ip_sesolve",
        None,
        {
            "512 threads": {},
            "256 threads": {"kMaxThreads": 256},
            "1024 threads": {"kMaxThreads": 1024},
        },
    ),
    "ip_sesolve_batched": (
        "ip_sesolve_batched",
        (10,),
        {
            "1024 threads": {},
            "512 threads": {
                "kThreads": 512,
                "kLeanFromAmps": _NEVER,
                "kSharedAccFromAmps": _NEVER,
            },
            "256 threads": {
                "kThreads": 256,
                "kLeanFromAmps": _NEVER,
                "kSharedAccFromAmps": _NEVER,
            },
        },
    ),
    "ip_sesolve_batched_big": (
        "ip_sesolve_batched",
        (11, 12, 13),
        {
            "1024 threads, lean from 4, shared accumulator from 8": {},
            "1024 threads, all in registers": {
                "kLeanFromAmps": _NEVER,
                "kSharedAccFromAmps": _NEVER,
            },
            "512 threads, all in registers": {
                "kThreads": 512,
                "kLeanFromAmps": _NEVER,
                "kSharedAccFromAmps": _NEVER,
            },
        },
    ),
    "mcwf_rows": (
        "mcwf_rows",
        (10,),
        {
            "1024 threads": {},
            "512 threads": {
                "kMaxThreads": 512,
                "kLeanFromAmps": _NEVER,
                "kSharedAccFromAmps": _NEVER,
            },
            "256 threads": {
                "kMaxThreads": 256,
                "kLeanFromAmps": _NEVER,
                "kSharedAccFromAmps": _NEVER,
            },
        },
    ),
    "mcwf_rows_big": (
        "mcwf_rows",
        (11, 12, 13),
        {
            "1024 threads, lean from 4, shared accumulator from 8": {},
            "1024 threads, all in registers": {
                "kLeanFromAmps": _NEVER,
                "kSharedAccFromAmps": _NEVER,
            },
            "1024 threads, lean from 2, shared accumulator from 4": {
                "kLeanFromAmps": 2,
                "kSharedAccFromAmps": 4,
            },
            "512 threads, all in registers": {
                "kMaxThreads": 512,
                "kLeanFromAmps": _NEVER,
                "kSharedAccFromAmps": _NEVER,
            },
            "512 threads, lean from 8, shared accumulator from 16": {
                "kMaxThreads": 512,
                "kLeanFromAmps": 8,
                "kSharedAccFromAmps": 16,
            },
        },
    ),
    "mcwf": (
        "mcwf",
        (10,),
        {
            "1024 threads": {},
            "512 threads": {"kMaxThreads": 512},
            "256 threads": {"kMaxThreads": 256},
        },
    ),
    # The batched K1 on clusters: each of n = 14, 15 and 16 in the other
    # block size (n = 17 has no other: a cluster holds at most 16 blocks)
    "ip_sesolve_batched_cluster": (
        "ip_sesolve_batched",
        (14, 15, 16, 17),
        {
            "shipped block shapes": {},
            "the other block shapes": {
                "replace": (
                    ("CASE(14, 13, kThreads)", "CASE(14, 12, kThreads / 2)"),
                    ("CASE(15, 12, kThreads / 2)", "CASE(15, 13, kThreads)"),
                    ("CASE(16, 13, kThreads)", "CASE(16, 12, kThreads / 2)"),
                ),
            },
        },
    ),
}


def _variant_source(name: str, keep: tuple | None, consts: dict) -> str:
    """The source of kernel ``name`` with ``consts`` changed (and the
    ``(old, new)`` text pairs under ``"replace"`` replaced) and only the
    instantiations for the qubit counts ``keep``."""
    src_path = K.SOURCES[name]
    with open(src_path) as f:
        src = f.read()
    common = os.path.join(os.path.dirname(src_path), "common.cuh")
    src = src.replace('#include "common.cuh"', f'#include "{common}"')
    consts = dict(consts)
    for old, new in consts.pop("replace", ()):
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    for const, value in consts.items():
        src, n = re.subn(
            rf"(constexpr int {const} = )\d+;", rf"\g<1>{value};", src
        )
        assert n == 1, const
    if keep is not None:
        src = re.sub(
            r"(?:PT_\w+_)?CASE\((\d+)(?:, [^()]*)?\)",
            lambda m: m.group(0) if int(m.group(1)) in keep else "",
            src,
        )
    return src


def _build(group: str) -> dict[str, ctypes.CDLL]:
    """The shipped library and one library per other variant."""
    name, keep, variants = GROUPS[group]
    build_dir = os.path.join(_ROOT, "pulser_tpu_torch", "build")
    os.makedirs(build_dir, exist_ok=True)
    shipped = K._load(name)
    labels = list(variants)
    libs = {labels[0]: shipped}
    procs = []
    for i, label in enumerate(labels[1:], 1):
        cu = os.path.join(build_dir, f"{group}_v{i}.cu")
        with open(cu, "w") as f:
            f.write(_variant_source(name, keep, variants[label]))
        so = os.path.join(build_dir, f"lib{group}_v{i}.so")
        cmd = [
            K._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", so, cu,
        ]
        procs.append((label, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    for label, so, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {group}, {label}:\n{log}")
        shown = [
            line
            for line in chip_smoke.ptxas_summary(log)
            if keep is None
            and "<16,1>" in line
            or keep is not None
            and any(re.search(rf"<{n}[,>]", line) for n in keep)
        ]
        print(f"{group}, {label}: {shown}")
        lib = ctypes.CDLL(so)
        for entry in (f"{name}_run", f"{name}_config"):
            if hasattr(shipped, entry):
                mine, theirs = getattr(lib, entry), getattr(shipped, entry)
                mine.restype, mine.argtypes = theirs.restype, theirs.argtypes
        libs[label] = lib
    return libs


def _afm16_call():
    seq = chip_smoke.afm16_sequence()
    emu = TorchEmulator.from_sequence(
        seq,
        evaluation_times=np.linspace(0, seq.get_duration() * 1e-3, 101),
    )
    emu.run()
    psi0 = emu._initial_ket().astype(np.complex64)
    args, kw = S.ip_kernel_inputs(
        psi0, emu._plan_cache[1], emu._current_hamiltonian.int_diag, 16,
        "cuda",
    )
    return lambda: K.ip_sesolve(*args, **kw)


def _spd10_call():
    with open(chip_smoke._SPD10_GOLDEN) as f:
        seed = json.load(f)["seed"]
    *_, captured = chip_smoke._run_noisy(
        K, chip_smoke.spd10_sequence(), seed, "sesolve_rk4_batched", S
    )
    psi0, plans, diags, _, _, n = captured["args"][:6]
    args, kw = S.ip_batched_kernel_inputs(psi0, plans, diags, n, "cuda")
    return lambda: K.ip_sesolve(*args, **kw)


def _random_batched_call(n: int):
    """100 random trajectories of 254 steps."""
    args, kw = chip_smoke.random_batched_kernel_inputs(
        n, n, "cuda", n_traj=100, seg_len=128
    )
    return lambda: K.ip_sesolve(*args, **kw)


def _noisy10_call():
    *_, captured = chip_smoke._run_noisy(
        K, chip_smoke.noisy10_sequence(), chip_smoke.NOISY10_REFERENCE["seed"],
        "mcsolve_rows_codes", S,
    )
    psi0, plans, diags, _, _, _, cops, seeds, _ = captured["args"]
    args = S.rows_kernel_inputs(psi0, plans, diags, seeds, "cuda")
    spec = S._diag_cops_spec(cops)
    return lambda: K.mcwf_rows(*args, cops=spec)[0]


def _random_rows_call(n: int):
    """100 random trajectories of 254 steps under a weak dephasing
    channel (about one jump per trajectory)."""
    args = chip_smoke.random_mcwf_inputs(
        n, n, "cuda", n_traj=100, seg_len=128, threshold=0.0
    )
    return lambda: K.mcwf_rows(*args, cops=chip_smoke.RANDOM_COPS[:1])[0]


def _pauli10_call():
    with open(chip_smoke._PAULI10_GOLDEN) as f:
        seed = json.load(f)["seed"]
    *_, captured = chip_smoke._run_noisy(
        K, chip_smoke.pauli10_sequence(), seed, "mcsolve_rk4_batched", S
    )
    psi0, plans, diags, _, _, _, cops, seeds = captured["args"]
    args, kw = S.mcwf_kernel_inputs(psi0, plans, diags, cops, seeds, "cuda")
    return lambda: K.mcwf(*args, **kw)[0]


def _time(group: str, calls: dict) -> None:
    """Times every variant of ``group`` on each of ``calls`` (``what ->
    call``), in turns: median of 6 solves each."""
    name = GROUPS[group][0]
    libs = _build(group)
    shipped = next(iter(libs))
    card = torch.cuda.get_device_name(0)
    for what, call in calls.items():
        want = call()
        torch.cuda.synchronize()

        def solve_ms(label: str) -> float:
            K._libs[name] = libs[label]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            got = call()
            end.record()
            torch.cuda.synchronize()
            K._libs[name] = libs[shipped]
            # Per trajectory for K2 and K3: another block size sums
            # |psi|^2 in another order, which may move one threshold
            # crossing by a step
            diff = (got - want).abs().reshape(got.shape[0], -1).amax(1)
            n_far = int((diff > chip_smoke.MCWF_TOL).sum())
            if n_far > (not name.startswith("ip_sesolve")):
                raise RuntimeError(f"{group}, {label} disagrees on {what}")
            return start.elapsed_time(end)

        for label in libs:
            solve_ms(label)  # warm-up
        times: dict[str, list[float]] = {label: [] for label in libs}
        for _ in range(3):
            for label in list(libs) + list(libs)[::-1]:
                times[label].append(solve_ms(label))
        for label, v in times.items():
            print(
                f"{name} on {what}, {label}: median"
                f" {statistics.median(v):.3f} ms of {len(v)} solves on {card}"
            )


def _spd16_inputs() -> tuple:
    """The batched K1's inputs on SPD16's run with 100 trajectories, from
    seed 1234 (the seed of every golden): ``(args, kwargs, n)``."""
    *_, captured = chip_smoke._run_noisy(
        K, chip_smoke.spd16_sequence(runs=100), 1234, "sesolve_rk4_batched",
        S,
    )
    psi0, plans, diags, _, _, n = captured["args"][:6]
    args, kw = S.ip_batched_kernel_inputs(psi0, plans, diags, n, "cuda")
    return args, kw, n


def _cooperative_run(tree: str):
    """The cooperative batched entry ``ip_sesolve_run_batched`` of the
    ``ip_sesolve.cu`` in checkout ``tree``, built with nvcc, as a function
    of the wrapper's ``(args, kwargs)``."""
    src = os.path.join(tree, "pulser_tpu_torch", "csrc", "ip_sesolve.cu")
    so = os.path.join(_ROOT, "pulser_tpu_torch", "build", "libip_cooperative.so")
    os.makedirs(os.path.dirname(so), exist_ok=True)
    subprocess.run(
        [
            K._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", so,
            src,
        ],
        check=True,
    )
    run = ctypes.CDLL(so).ip_sesolve_run_batched
    p, i = ctypes.c_void_p, ctypes.c_int
    run.restype, run.argtypes = i, [p] * 12 + [i] * 4 + [p]

    def call(args, kw):
        n = kw["n_row"] + kw["n_col"]
        out = torch.empty(
            (args[0].shape[0], 2, 1 << n), dtype=torch.float32, device="cuda"
        )
        wbuf = torch.empty((2, 1 << n, 2), dtype=torch.float32, device="cuda")
        err = run(
            *(t.data_ptr() for t in args), out.data_ptr(), wbuf.data_ptr(),
            args[0].shape[0], kw["segs_per_traj"], kw["seg_len"], n,
            torch.cuda.current_stream().cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"ip_sesolve_run_batched: CUDA error {err}")
        return out.reshape(-1, 2, 1 << kw["n_row"], 1 << kw["n_col"])

    return call


def _time_clusters(cooperative_from: str | None) -> None:
    """The batched K1 at n = 14 to 17 in the shipped block shapes and the
    other ones (and the cooperative kernel of ``cooperative_from``), in
    turns: median of 6 solves each, every result within BATCHED_TOL of
    the shipped kernel's."""
    group = "ip_sesolve_batched_cluster"
    libs = _build(group)
    shipped = next(iter(libs))
    coop = _cooperative_run(cooperative_from) if cooperative_from else None
    card = torch.cuda.get_device_name(0)
    cases = {"SPD16, 100 trajectories": _spd16_inputs()}
    for n in range(14, 18):
        args, kw = chip_smoke.random_batched_kernel_inputs(
            n, n, "cuda", n_traj=100, seg_len=128
        )
        cases[f"100 random trajectories of 254 steps, n={n}"] = (args, kw, n)

    def with_lib(label: str, fn):
        K._libs["ip_sesolve_batched"] = libs[label]
        try:
            return fn()
        finally:
            K._libs["ip_sesolve_batched"] = libs[shipped]

    for what, (args, kw, n) in cases.items():
        variants = {}
        for label in libs:
            shape = with_lib(label, lambda: K.ip_sesolve_batched_config(n))
            variants[
                f"{label}: {shape['blocks']} blocks of {shape['threads']}"
                f" threads a trajectory, {shape['active']} at once"
            ] = lambda label=label: with_lib(
                label, lambda: K.ip_sesolve(*args, **kw)
            )
        if coop is not None:
            variants["cooperative kernel, one trajectory after another"] = (
                lambda: coop(args, kw)
            )
        want = K.ip_sesolve(*args, **kw)
        torch.cuda.synchronize()

        def solve_ms(call) -> float:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            got = call()
            end.record()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if err > chip_smoke.BATCHED_TOL:
                raise RuntimeError(f"{what}: a variant differs by {err:.3e}")
            return start.elapsed_time(end)

        for call in variants.values():
            solve_ms(call)  # warm-up
        times: dict[str, list[float]] = {label: [] for label in variants}
        for _ in range(3):
            for label in list(variants) + list(variants)[::-1]:
                times[label].append(solve_ms(variants[label]))
        for label, v in times.items():
            print(
                f"ip_sesolve batched on {what}, {label}: median"
                f" {statistics.median(v):.3f} ms of {len(v)} solves on {card}"
            )


def main() -> int:
    if not torch.cuda.is_available():
        print("block_sizes: no CUDA device", file=sys.stderr)
        return 1
    argv = sys.argv[1:]
    cooperative_from = None
    if "--cooperative-from" in argv:
        at = argv.index("--cooperative-from")
        cooperative_from = argv[at + 1]
        del argv[at : at + 2]
    big = (11, 12, 13)
    calls = {
        "ip_sesolve": lambda: {"AFM16": _afm16_call()},
        "ip_sesolve_batched": lambda: {"SPD10": _spd10_call()},
        "ip_sesolve_batched_big": lambda: {
            f"random n={n}": _random_batched_call(n) for n in big
        },
        "mcwf_rows": lambda: {"NOISY10": _noisy10_call()},
        "mcwf_rows_big": lambda: {
            f"random n={n}": _random_rows_call(n) for n in big
        },
        "mcwf": lambda: {"PAULI10": _pauli10_call()},
    }
    for group in argv or list(GROUPS):
        if group == "ip_sesolve_batched_cluster":
            _time_clusters(cooperative_from)
        else:
            _time(group, calls[group]())
    return 0


if __name__ == "__main__":
    sys.exit(main())
