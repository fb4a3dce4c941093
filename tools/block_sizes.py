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
shipped kernel's. Run from the repository root on a machine with the
card::

    python3 tools/block_sizes.py [group ...]

With no argument every group of :data:`GROUPS` runs (a few minutes).
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
}


def _variant_source(name: str, keep: tuple | None, consts: dict) -> str:
    """The source of kernel ``name`` with ``consts`` changed and only the
    instantiations for the qubit counts ``keep``."""
    src_path = K.SOURCES[name]
    with open(src_path) as f:
        src = f.read()
    common = os.path.join(os.path.dirname(src_path), "common.cuh")
    src = src.replace('#include "common.cuh"', f'#include "{common}"')
    for const, value in consts.items():
        src, n = re.subn(
            rf"(constexpr int {const} = )\d+;", rf"\g<1>{value};", src
        )
        assert n == 1, const
    if keep is not None:
        src = re.sub(
            r"PT_\w+_CASE\((\d+)\)",
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
            and "<16,1,0>" in line
            or keep is not None
            and any(f"<{n}>" in line for n in keep)
        ]
        print(f"{group}, {label}: {shown}")
        lib = ctypes.CDLL(so)
        run = getattr(lib, f"{name}_run")
        shipped_run = getattr(shipped, f"{name}_run")
        run.restype, run.argtypes = shipped_run.restype, shipped_run.argtypes
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


def main() -> int:
    if not torch.cuda.is_available():
        print("block_sizes: no CUDA device", file=sys.stderr)
        return 1
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
    for group in sys.argv[1:] or list(calls):
        _time(group, calls[group]())
    return 0


if __name__ == "__main__":
    sys.exit(main())
