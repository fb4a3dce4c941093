"""Hand-written CUDA kernels and their plain PyTorch versions.

- ``ip_sesolve`` replaces the TPU kernel ``_ip_sesolve_kernel`` of
  ``pulser_tpu/ops/pallas_kernels.py``: a fused interaction-picture RK4
  sesolve over the evaluation segments of a plan (d=2, one
  ground-rydberg basis). Source: ``pulser_tpu_torch/csrc/ip_sesolve.cu``.
  Its trajectory-batched mode (``segs_per_traj``) runs the trajectories
  side by side in ``pulser_tpu_torch/csrc/ip_sesolve_batched.cu``: a
  thread block each for n ≤ 13, a thread-block cluster each for n ≥ 14
  (:data:`IP_BATCHED_SHAPES`).
- ``mcwf_rows`` replaces the TPU kernel ``_mcwf_rows_kernel`` of the same
  file: the row-batched interaction-picture quantum-jump solve with
  diagonal collapse operators. Source:
  ``pulser_tpu_torch/csrc/mcwf_rows.cu``.
- ``mcwf`` replaces the TPU kernel ``_mcwf_kernel`` of the same file: the
  lab-frame quantum-jump solve with general 2×2 collapse operators.
  Source: ``pulser_tpu_torch/csrc/mcwf.cu``.
- ``sample_states`` has no TPU kernel (the JAX package draws these shots
  on the host): the measurement outcomes of the trajectory-batched
  ``ip_sesolve``'s kets, drawn where the solve left them from uniforms
  the host drew. Source: ``pulser_tpu_torch/csrc/sample_states.cu``.

Each source says what bounds its kernel on the card and how the design
answers that. Each is compiled with ``nvcc`` for ``sm_90a`` on first use
into the package's ``build/`` directory (keyed by a hash of the source
and the shared header ``csrc/common.cuh``) and loaded with ctypes. A
wrapper given CPU tensors runs the plain PyTorch version of the same
function; given CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess

import numpy as np
import torch

from pulser_tpu_torch import profiling
from pulser_tpu_torch.ops.apply import apply_axis_c, neg_i

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BUILD_DIR = os.path.join(_PKG_DIR, "build")
#: The CUDA sources, by kernel name.
SOURCES = {
    name: os.path.join(_PKG_DIR, "csrc", f"{name}.cu")
    for name in (
        "ip_sesolve", "ip_sesolve_batched", "mcwf_rows", "mcwf",
        "sample_states",
    )
}

#: The wrappers count their launches in :mod:`pulser_tpu_torch.profiling`
#: under ``kernels.<kernel>.launches`` (:func:`launches`): one
#: cooperative ``ip_sesolve_kernel`` per whole solve; one
#: ``ip_sesolve_batched_kernel`` per whole trajectory batch (a thread
#: block per trajectory for n ≤ 13, a thread-block cluster per trajectory
#: above); one ``mcwf_rows_kernel`` and one ``mcwf_kernel`` per whole
#: trajectory batch; one ``sample_states_kernel`` per batch of draws.
LAUNCH_COUNTER = "kernels.{}.launches"
#: Of the last ``mcwf_rows_kernel`` launch: the ``(B,)`` int32 device
#: tensor of the steps of each trajectory whose first rotor the kernel
#: carried over from the step before (``None`` before the first launch).
MCWF_ROWS_CARRIED: torch.Tensor | None = None

#: The qubit counts ``ip_sesolve_kernel`` is instantiated for.
IP_MIN_QUBITS, IP_MAX_QUBITS = 10, 17
#: The cluster gate of the trajectory-batched mode: up to this n each
#: trajectory runs in one thread block of ``ip_sesolve_batched_kernel``
#: (at most 2^13 amplitudes); above it, in one thread-block cluster of
#: blocks of the same kernel (:data:`IP_BATCHED_SHAPES`).
IP_BLOCK_MAX_QUBITS = 13
#: The trajectory-batched mode's block shape by n, a fixed table that
#: ``ip_sesolve_batched.cu``'s ``PT_IPB_SHAPES`` instantiates:
#: ``(block_qubits, threads)``, a block of 2^block_qubits amplitudes, so a
#: trajectory runs on ``2^(n - block_qubits)`` blocks, one cluster. For
#: n = 14–16 both block sizes were timed in turns (``tools/block_sizes.py
#: ip_sesolve_batched_cluster``, NVIDIA H100 80GB HBM3 at 700 W, 100
#: random trajectories of 254 steps): 2^13 amplitudes and 1024 threads
#: won at n = 14 (25.653 against 26.254 ms) and n = 16 (101.542 against
#: 117.740; SPD16's 100 trajectories 1197.385 against 1401.732), 2^12 and
#: 512 threads at n = 15 (50.306 against 53.534). n = 17 has one shape,
#: 16 blocks of 2^13, which beat the cooperative kernel that ran the
#: trajectories one after another (241.863 against 392.273 ms).
IP_BATCHED_SHAPES = {
    10: (10, 1024), 11: (11, 1024), 12: (12, 1024), 13: (13, 1024),
    14: (13, 1024), 15: (12, 512), 16: (13, 1024), 17: (13, 1024),
}

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc`` or the one on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or PATH.")
    return found


def _lib_path(name: str) -> str:
    """Where the library of kernel ``name`` is built: keyed by a hash of
    its source and the shared headers, so an edited file builds anew."""
    csrc = os.path.dirname(SOURCES[name])
    paths = [SOURCES[name]] + sorted(
        os.path.join(csrc, f) for f in os.listdir(csrc) if f.endswith(".cuh")
    )
    digest = hashlib.sha256()
    for path in paths:
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(_BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build(
    names: tuple[str, ...] | None = None, verbose: bool = False
) -> dict[str, tuple[str, str]]:
    """Compiles the kernels' sources whose libraries do not exist yet.

    One ``nvcc`` process per source, all started together.

    Args:
        names: Kernels to build (default: all of :data:`SOURCES`).
        verbose: Ask ``ptxas`` for each kernel's registers and spills.

    Returns:
        ``{name: (library path, compiler output)}``; the output is empty
        for a library that was already built.
    """
    names = tuple(SOURCES) if names is None else tuple(names)
    os.makedirs(_BUILD_DIR, exist_ok=True)
    out: dict[str, tuple[str, str]] = {}
    running = []
    for name in names:
        lib_path = _lib_path(name)
        if os.path.exists(lib_path):
            out[name] = (lib_path, "")
            continue
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [
            _nvcc(),
            "-gencode",
            "arch=compute_90a,code=sm_90a",
            "-std=c++17",
            "-O3",
            "-shared",
            "-Xcompiler",
            "-fPIC",
            "-o",
            tmp,
            SOURCES[name],
        ]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )
        running.append((name, lib_path, tmp, proc))
    failed = []
    for name, lib_path, tmp, proc in running:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc failed ({proc.returncode}):\n{stderr}")
            continue
        os.replace(tmp, lib_path)
        out[name] = (lib_path, stdout + stderr)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def _load(name: str) -> ctypes.CDLL:
    """Builds (on first use) and loads the library of kernel ``name``."""
    lib = _libs.get(name)
    if lib is None:
        with profiling.phase("kernels.build"):
            (path, _), = build((name,)).values()
            lib = ctypes.CDLL(path)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == "ip_sesolve":
            lib.ip_sesolve_run.restype = i
            lib.ip_sesolve_run.argtypes = [p] * 12 + [i] * 3 + [p]
            lib.ip_sesolve_config.restype = i
            lib.ip_sesolve_config.argtypes = [i, p]
            lib.ip_sesolve_barrier_probe.restype = i
            lib.ip_sesolve_barrier_probe.argtypes = [i] * 3 + [p]
        elif name == "ip_sesolve_batched":
            lib.ip_sesolve_batched_run.restype = i
            lib.ip_sesolve_batched_run.argtypes = [p] * 11 + [i] * 4 + [p]
            lib.ip_sesolve_batched_config.restype = i
            lib.ip_sesolve_batched_config.argtypes = [i, p]
        elif name == "sample_states":
            lib.sample_states_run.restype = i
            lib.sample_states_run.argtypes = [p] * 5 + [i] * 6 + [p]
        elif name == "mcwf_rows":
            lib.mcwf_rows_run.restype = i
            lib.mcwf_rows_run.argtypes = [p] * 16 + [i] * 5 + [f, f, p]
        else:
            lib.mcwf_run.restype = i
            lib.mcwf_run.argtypes = [p] * 12 + [i] * 5 + [f] * 4 + [p]
        getattr(lib, f"{name}_device_launches").restype = ctypes.c_ulonglong
        _libs[name] = lib
    return lib


def launches(name: str) -> int:
    """The launches the wrapper of kernel ``name`` (a key of
    :data:`SOURCES`) has counted so far (since the last
    :func:`~pulser_tpu_torch.profiling.reset_phases`): the launches of
    one call are the difference across it."""
    if name not in SOURCES:
        raise ValueError(f"{name} is no kernel of {tuple(SOURCES)}.")
    return profiling.counter_report().get(LAUNCH_COUNTER.format(name), 0)


def device_launches(name: str) -> int:
    """The device kernels the library of kernel ``name`` (a key of
    :data:`SOURCES`) has launched so far, as its C entries count them:
    the launches of one call are the difference across it."""
    if name not in SOURCES:
        raise ValueError(f"{name} is no kernel of {tuple(SOURCES)}.")
    return int(getattr(_load(name), f"{name}_device_launches")())


def _check_inputs(
    tensors: dict[str, torch.Tensor],
    shapes: dict[str, tuple[int, ...]],
) -> None:
    """Raises unless every tensor is f32, contiguous, of the given shape
    and on the same device as the first."""
    device = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, not {t.dtype}.")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, not {device}.")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous.")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(
                f"{name} has shape {tuple(t.shape)}, expected"
                f" {shapes[name]}."
            )


def _host_steps(
    seg_dts: torch.Tensor, seg_dts_host: np.ndarray | None
) -> np.ndarray:
    """The ``(n_seg, L)`` f32 step sizes on the host."""
    host = seg_dts.cpu().numpy() if seg_dts_host is None else seg_dts_host
    return np.ascontiguousarray(host, dtype=np.float32).reshape(
        seg_dts.shape[0], -1
    )


def ip_sesolve(
    a_re: torch.Tensor,
    a_im: torch.Tensor,
    cum_mod: torch.Tensor,
    t_stage: torch.Tensor,
    seg_dts: torch.Tensor,
    eval_t: torch.Tensor,
    eval_cum_mod: torch.Tensor,
    diag2d: torch.Tensor,
    psi0_re: torch.Tensor,
    psi0_im: torch.Tensor,
    *,
    n_row: int,
    n_col: int,
    seg_len: int,
    segs_per_traj: int | None = None,
    seg_dts_host: np.ndarray | None = None,
) -> torch.Tensor:
    """Fused interaction-picture RK4 sesolve (d=2, one basis, f32).

    Inputs and output follow the JAX package's ``_ip_sesolve_jit``. With
    ``segs_per_traj`` the ``n_seg = T·segs_per_traj`` rows are T
    trajectories, trajectory-major: the state starts from ``psi0`` at
    each trajectory's first segment, and segment ``s`` reads the diagonal
    of trajectory ``s // segs_per_traj``. One device launch per call in
    either mode.

    Args:
        a_re/a_im: ``(n_seg, L, 3, n)`` drive coefficient stages.
        cum_mod: ``(n_seg, L, 3, n)`` range-reduced ``−∫det`` stages.
        t_stage: ``(n_seg, L, 3)`` stage times (relative to the grid
            start).
        seg_dts: ``(n_seg, L, 1)`` step sizes (0 = padding).
        eval_t: ``(n_seg, 1, 1)`` evaluation times.
        eval_cum_mod: ``(n_seg, 1, n)`` range-reduced ``−∫det`` at the
            evaluation times.
        diag2d: ``(T, R, C)`` interaction diagonals (``(R, C)`` for one
            trajectory).
        psi0_re/psi0_im: ``(R, C)`` initial state, shared.
        n_row/n_col: Qubits on the row/column axis (``R = 2^n_row``).
        seg_len: Steps per segment (``L``).
        segs_per_traj: Segments per trajectory (default: one trajectory
            of ``n_seg`` segments).
        seg_dts_host: Host copy of ``seg_dts``, read by the plain
            version's step loop (without it the step sizes are copied
            back from the device once). The kernel reads ``seg_dts``
            on the device.

    Returns:
        ``(n_seg, 2, R, C)`` float32 lab-frame states after each
        segment (real and imaginary planes).
    """
    if a_re.device.type == "cpu":
        return ip_sesolve_reference(
            a_re, a_im, cum_mod, t_stage, seg_dts, eval_t, eval_cum_mod,
            diag2d, psi0_re, psi0_im,
            n_row=n_row, n_col=n_col, seg_len=seg_len,
            segs_per_traj=segs_per_traj, seg_dts_host=seg_dts_host,
        )
    if a_re.device.type != "cuda":
        raise ValueError(f"Unsupported device {a_re.device}.")
    n = n_row + n_col
    n_seg = a_re.shape[0]
    rows, cols = 1 << n_row, 1 << n_col
    if diag2d.ndim == 2:
        diag2d = diag2d[None]
    n_traj = _n_trajectories(n_seg, segs_per_traj)
    stage = (n_seg, seg_len, 3, n)
    _check_inputs(
        dict(
            a_re=a_re, a_im=a_im, cum_mod=cum_mod, t_stage=t_stage,
            seg_dts=seg_dts, eval_t=eval_t, eval_cum_mod=eval_cum_mod,
            diag2d=diag2d, psi0_re=psi0_re, psi0_im=psi0_im,
        ),
        dict(
            a_re=stage, a_im=stage, cum_mod=stage,
            t_stage=(n_seg, seg_len, 3), seg_dts=(n_seg, seg_len, 1),
            eval_t=(n_seg, 1, 1), eval_cum_mod=(n_seg, 1, n),
            diag2d=(n_traj, rows, cols), psi0_re=(rows, cols),
            psi0_im=(rows, cols),
        ),
    )
    if not IP_MIN_QUBITS <= n <= IP_MAX_QUBITS:
        raise ValueError(
            f"ip_sesolve takes {IP_MIN_QUBITS} <= n <= {IP_MAX_QUBITS},"
            f" not n={n}."
        )
    dim = rows * cols
    dev = a_re.device
    out = torch.empty((n_seg, 2, rows, cols), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [
        t.data_ptr()
        for t in (
            a_re, a_im, cum_mod, t_stage, seg_dts, eval_t, eval_cum_mod,
            diag2d, psi0_re, psi0_im, out,
        )
    ]
    if segs_per_traj is not None:
        entry = "ip_sesolve_batched_run"
        err = _load("ip_sesolve_batched").ip_sesolve_batched_run(
            *ptrs, n_traj, segs_per_traj, seg_len, n, stream
        )
        profiling.count(LAUNCH_COUNTER.format("ip_sesolve_batched"))
    else:
        entry = "ip_sesolve_run"
        # The double-buffered rotated stage input, interleaved (re, im)
        wbuf = torch.empty((2, dim, 2), dtype=torch.float32, device=dev)
        err = _load("ip_sesolve").ip_sesolve_run(
            *ptrs, wbuf.data_ptr(), n_seg, seg_len, n, stream
        )
        profiling.count(LAUNCH_COUNTER.format("ip_sesolve"))
    if err != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {err}.")
    return out


def _n_trajectories(n_seg: int, segs_per_traj: int | None) -> int:
    """The trajectories of ``n_seg`` segment rows (one without
    ``segs_per_traj``)."""
    if segs_per_traj is None:
        return 1
    if segs_per_traj < 1 or n_seg % segs_per_traj:
        raise ValueError(
            f"{n_seg} segment rows are not a whole number of trajectories"
            f" of {segs_per_traj} segments."
        )
    return n_seg // segs_per_traj


def ip_sesolve_batched_library(n: int) -> str:
    """The kernel of :data:`SOURCES` whose library runs the
    trajectory-batched mode of :func:`ip_sesolve` for n qubits (its
    device launches are ``device_launches`` of that name): one library
    for every n, a block or a cluster per trajectory."""
    if n not in IP_BATCHED_SHAPES:
        raise ValueError(f"The batched mode takes 10 <= n <= 17, not n={n}.")
    return "ip_sesolve_batched"


def ip_sesolve_batched_shape(n: int) -> dict[str, int]:
    """The block shape of the trajectory-batched mode for n qubits
    (:data:`IP_BATCHED_SHAPES`), as ``ip_sesolve_batched.cu`` lays it out:
    ``block_qubits``, ``blocks`` per trajectory (the cluster), ``threads``
    per block, ``amps`` per thread and dynamic ``smem_bytes`` per block
    (two complex planes of the stage input, a third for the RK4
    accumulator from 8 amplitudes a thread)."""
    nb, threads = IP_BATCHED_SHAPES[n]
    amps = (1 << nb) // threads
    return dict(
        block_qubits=nb,
        blocks=1 << (n - nb),
        threads=threads,
        amps=amps,
        smem_bytes=(3 if amps >= 8 else 2) * (1 << nb) * 8,
    )


def ip_sesolve_batched_config(n: int) -> dict[str, int]:
    """The shape the C library launches for n qubits on the current card
    (the keys of :func:`ip_sesolve_batched_shape`), with the trajectories
    it runs at once (``active``: the occupancy API's clusters, or blocks
    for one block a trajectory)."""
    config = (ctypes.c_int * 6)()
    err = _load("ip_sesolve_batched").ip_sesolve_batched_config(n, config)
    if err != 0:
        raise RuntimeError(
            f"ip_sesolve_batched_config failed: CUDA error {err}."
        )
    keys = ("block_qubits", "blocks", "threads", "amps", "smem_bytes", "active")
    return dict(zip(keys, config))


def ip_sesolve_grid(n: int) -> tuple[int, int, int]:
    """The grid :func:`ip_sesolve` launches for n qubits on the current
    card: ``(blocks, threads per block, amplitudes per thread)``."""
    config = (ctypes.c_int * 3)()
    err = _load("ip_sesolve").ip_sesolve_config(n, config)
    if err != 0:
        raise RuntimeError(f"ip_sesolve_config failed: CUDA error {err}.")
    return tuple(config)


def ip_sesolve_reference(
    a_re: torch.Tensor,
    a_im: torch.Tensor,
    cum_mod: torch.Tensor,
    t_stage: torch.Tensor,
    seg_dts: torch.Tensor,
    eval_t: torch.Tensor,
    eval_cum_mod: torch.Tensor,
    diag2d: torch.Tensor,
    psi0_re: torch.Tensor,
    psi0_im: torch.Tensor,
    *,
    n_row: int,
    n_col: int,
    seg_len: int,
    segs_per_traj: int | None = None,
    seg_dts_host: np.ndarray | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`ip_sesolve` (same arguments).

    Runs on the inputs' device in complex64. The trajectories ride a
    leading tensor axis, so the Python loop runs over the segments and
    steps of ONE trajectory whatever the batch; each RK4 stage gathers
    the ``n`` single-flip partners of every amplitude at once. A step
    that is padding (h = 0) for every trajectory is skipped; one that is
    padding for some leaves their state as it is.
    """
    n = n_row + n_col
    dim = 1 << n
    n_seg = a_re.shape[0]
    n_traj = _n_trajectories(n_seg, segs_per_traj)
    spt = n_seg // n_traj
    dev = a_re.device
    a = torch.complex(a_re, a_im).reshape(n_traj, spt, seg_len * 3, n)
    cum = cum_mod.reshape(n_traj, spt, seg_len * 3, n)
    t_st = t_stage.reshape(n_traj, spt, seg_len * 3)
    h_dev = seg_dts.reshape(n_traj, spt, seg_len)
    h_host = _host_steps(seg_dts, seg_dts_host).reshape(n_traj, spt, seg_len)
    ev_t = eval_t.reshape(n_traj, spt)
    ev_cum = eval_cum_mod.reshape(n_traj, spt, n)
    diag = diag2d.reshape(n_traj, dim)
    idx = torch.arange(dim, device=dev)
    shifts = torch.arange(n - 1, -1, -1, device=dev)  # qubit q: bit n-1-q
    bits = (idx[None, :] >> shifts[:, None]) & 1  # (n, dim)
    partners = idx[None, :] ^ (1 << shifts)[:, None]  # (n, dim)
    bits_f = bits.to(torch.float32)
    # +a_im where the output index has the qubit's bit set, -a_im else
    im_sign = 2.0 * bits_f - 1.0

    def rotor(t: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """``e^{-iΦ}`` with Φ = (diag·t mod 2π) + Σc − Σ_q c_q bit_q, for
        the ``(T,)`` times and ``(T, n)`` phase integrals."""
        ph = torch.remainder(diag * t[:, None], 2 * math.pi)
        ph = ph + c.sum(1, keepdim=True) - c @ bits_f
        return torch.complex(torch.cos(ph), -torch.sin(ph))

    phi = torch.complex(psi0_re, psi0_im).reshape(1, dim).repeat(n_traj, 1)
    out = torch.empty((n_traj, spt, 2, dim), dtype=torch.float32, device=dev)
    for s in range(spt):
        for i in range(seg_len):
            if not h_host[:, s, i].any():
                continue
            h = h_dev[:, s, i, None]  # (T, 1)
            k = torch.zeros_like(phi)
            acc = torch.zeros_like(phi)
            for j in range(4):
                sidx = (j + 1) >> 1
                row = i * 3 + sidx
                rot = rotor(t_st[:, s, row], cum[:, s, row])
                w = rot * (phi + (h * (0.5 * sidx)) * k)
                amp = a[:, s, row]  # (T, n)
                coef = torch.complex(
                    amp.real[:, :, None].expand(-1, -1, dim),
                    amp.imag[:, :, None] * im_sign,
                )
                y = (coef * w[:, partners]).sum(1)
                k = -1j * (rot.conj() * y)
                acc = acc + (1 / 3 if j in (1, 2) else 1 / 6) * k
            phi = phi + h * acc
        lab = rotor(ev_t[:, s], ev_cum[:, s]) * phi
        out[:, s, 0] = lab.real
        out[:, s, 1] = lab.imag
    return out.reshape(n_seg, 2, 1 << n_row, 1 << n_col)


#: The fixed-point unit of the sampler's cumulative weights, 2^-62.
_SAMPLE_SCALE = float(1 << 62)


def sample_states(
    planes: torch.Tensor,
    seg_of: torch.Tensor,
    offs: torch.Tensor,
    u: torch.Tensor,
    *,
    renormalize: bool,
    reverse: bool,
) -> torch.Tensor:
    """Measurement outcomes drawn from a trajectory batch's qubit kets.

    Entry ``e = t·n_times + i`` reads trajectory ``t``'s state after
    segment ``seg_of[i]`` and draws one outcome for each of its uniforms
    ``u[offs[e]:offs[e + 1]]``, as the host pass
    ``emulator.simulation._sample_ket_states`` draws them from the
    fetched states: where ``renormalize``, the state times the float32
    reciprocal of its float32 norm; the weights ``|a|²`` in float64, in
    bitstring order (reversed where ``reverse``); divided by their total;
    the first outcome whose cumulative weight reaches the uniform, capped
    at the last outcome of positive weight. The cumulative weights are
    sums of the normalized weights each rounded to a multiple of 2^-62,
    exact in any order (see ``csrc/sample_states.cu``); they differ from
    the host's float64 sums by rounding alone. One device launch per
    call.

    Args:
        planes: ``(T, S, 2, 2^n)`` float32 real and imaginary planes of
            each trajectory's state after each segment (the batched
            :func:`ip_sesolve`'s output, reshaped).
        seg_of: ``(n_times,)`` int64 segment of each evaluation time.
        offs: ``(T·n_times + 1,)`` int64 offsets of the entries' uniforms.
        u: ``(offs[-1],)`` float64 uniforms in [0, 1).
        renormalize: Divide each state by its norm first.
        reverse: Bitstring order is the state's reversed (the
            ground-rydberg basis lists the Rydberg level first).

    Returns:
        ``(offs[-1],)`` int32 outcome indices in bitstring order.
    """
    kw = dict(renormalize=renormalize, reverse=reverse)
    if planes.device.type == "cpu":
        return sample_states_reference(planes, seg_of, offs, u, **kw)
    if planes.device.type != "cuda":
        raise ValueError(f"Unsupported device {planes.device}.")
    n_traj, spt, two, dim = planes.shape
    n = dim.bit_length() - 1
    if two != 2 or dim != 1 << n:
        raise ValueError(f"planes has shape {tuple(planes.shape)}.")
    if not IP_MIN_QUBITS <= n <= IP_MAX_QUBITS:
        # The qubit counts of the batched ip_sesolve whose output it reads
        raise ValueError(
            f"sample_states takes {IP_MIN_QUBITS} <= n <= {IP_MAX_QUBITS},"
            f" not n={n}."
        )
    n_times = seg_of.numel()
    expected = dict(
        planes=(torch.float32, (n_traj, spt, 2, dim)),
        seg_of=(torch.int64, (n_times,)),
        offs=(torch.int64, (n_traj * n_times + 1,)),
        u=(torch.float64, (u.numel(),)),
    )
    tensors = dict(planes=planes, seg_of=seg_of, offs=offs, u=u)
    for name, (dtype, shape) in expected.items():
        t = tensors[name]
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name} must be {dtype} of shape {shape}, not {t.dtype}"
                f" of shape {tuple(t.shape)}."
            )
        if t.device != planes.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {planes.device}.")
    out = torch.empty(u.shape, dtype=torch.int32, device=planes.device)
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    err = _load("sample_states").sample_states_run(
        *(t.data_ptr() for t in (planes, seg_of, offs, u, out)),
        n_traj, spt, n_times, n, int(renormalize), int(reverse), stream,
    )
    profiling.count(LAUNCH_COUNTER.format("sample_states"))
    if err != 0:
        raise RuntimeError(f"sample_states_run failed: CUDA error {err}.")
    return out


def sample_states_reference(
    planes: torch.Tensor,
    seg_of: torch.Tensor,
    offs: torch.Tensor,
    u: torch.Tensor,
    *,
    renormalize: bool,
    reverse: bool,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`sample_states` (same arguments).

    Runs on the inputs' device, a trajectory at a time over all its
    evaluation times: the norm a float64 sum of the float32 squares
    rounded to float32, the fixed-point cumulative weights an int64
    ``cumsum``, each draw a ``searchsorted``.
    """
    n_traj = planes.shape[0]
    n_times = seg_of.numel()
    bounds = offs.tolist()
    out = torch.empty(u.shape, dtype=torch.int32, device=u.device)
    for t in range(n_traj):
        states = planes[t, seg_of]  # (n_times, 2, dim)
        re, im = states[:, 0], states[:, 1]
        if renormalize:
            sq = (re * re + im * im).double().sum(1, keepdim=True)
            norm = torch.sqrt(sq.float())
            inv = 1.0 / torch.where(norm != 0, norm, torch.ones_like(norm))
            re, im = re * inv, im * inv
        h = torch.hypot(re.double(), im.double())
        w = h * h
        if reverse:
            w = w.flip(-1)
        total = w.sum(1, keepdim=True)
        scaled = torch.where(total > 0, w / total, torch.zeros_like(w))
        cum = torch.cumsum(torch.round(scaled * _SAMPLE_SCALE).long(), 1)
        for i in range(n_times):
            e = t * n_times + i
            sl = slice(bounds[e], bounds[e + 1])
            target = torch.ceil(u[sl] * _SAMPLE_SCALE).long()
            target = torch.minimum(target, cum[i, -1])
            out[sl] = torch.searchsorted(cum[i], target).int()
    return out


def _f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float."""
    return float(np.float32(x))


def _cop_table(cops: tuple) -> tuple[np.ndarray, float, float]:
    """Per-operator rows ``(l00_re, l00_im, l11_re, l11_im, |l00|², |l11|²)``
    and the two diagonal entries ``g00, g11`` of ``Σ_k L_k†L_k``, formed
    in float64 as the JAX kernel forms them, then cast to float32."""
    rows = [
        (l00r, l00i, l11r, l11i, l00r * l00r + l00i * l00i,
         l11r * l11r + l11i * l11i)
        for l00r, l00i, l11r, l11i in cops
    ]
    g00 = sum(r[4] for r in rows)
    g11 = sum(r[5] for r in rows)
    return np.asarray(rows, dtype=np.float32).reshape(-1, 6), g00, g11


def _mcwf_rows_shapes(
    n_traj: int, n_seg: int, seg_len: int, n: int
) -> dict[str, tuple[int, ...]]:
    stage = (n_traj, n_seg, seg_len, 3, 1, n)
    dim = 1 << n
    return dict(
        a_re=stage, a_im=stage, cum_mod=stage,
        t_stage=(n_seg, seg_len, 3), seg_dts=(n_seg, seg_len),
        us=(n_traj, n_seg, seg_len, 2), eval_t=(n_seg,),
        eval_cum_mod=(n_traj, n_seg, 1, n), r0=(n_traj,),
        diags=(n_traj, dim), psi0_re=(dim,), psi0_im=(dim,),
    )


def mcwf_rows(
    a_re: torch.Tensor,
    a_im: torch.Tensor,
    cum_mod: torch.Tensor,
    t_stage: torch.Tensor,
    seg_dts: torch.Tensor,
    us: torch.Tensor,
    eval_t: torch.Tensor,
    eval_cum_mod: torch.Tensor,
    r0: torch.Tensor,
    diags: torch.Tensor,
    psi0_re: torch.Tensor,
    psi0_im: torch.Tensor,
    *,
    cops: tuple,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-batched interaction-picture MCWF solve (d=2, one basis, f32).

    The inputs are those of the JAX package's ``mcwf_rows_program``
    (B trajectories, S segments of L steps, n qubits, dim = 2^n).

    Args:
        a_re/a_im: ``(B, S, L, 3, 1, n)`` per-trajectory drive stages.
        cum_mod: ``(B, S, L, 3, 1, n)`` pre-negated ``∫det mod 2π``.
        t_stage: ``(S, L, 3)`` stage times (shared).
        seg_dts: ``(S, L)`` step sizes (shared; 0 = padding).
        us: ``(B, S, L, 2)`` per-step uniforms (channel selector, next
            threshold).
        eval_t: ``(S,)`` evaluation times.
        eval_cum_mod: ``(B, S, 1, n)`` eval-time phase integrals.
        r0: ``(B,)`` initial jump thresholds.
        diags: ``(B, dim)`` interaction diagonals.
        psi0_re/psi0_im: ``(dim,)`` shared initial state.
        cops: Diagonal collapse operators, ``(l00_re, l00_im, l11_re,
            l11_im)`` each (at most 8).

    Returns:
        ``(states, jumps)``: ``(B, S, 2, dim)`` float32 normalized
        lab-frame states after each segment (real and imaginary
        planes), and the ``(B,)`` int32 number of jumps of each
        trajectory.
    """
    if a_re.device.type == "cpu":
        return mcwf_rows_reference(
            a_re, a_im, cum_mod, t_stage, seg_dts, us, eval_t,
            eval_cum_mod, r0, diags, psi0_re, psi0_im, cops=cops,
        )
    if a_re.device.type != "cuda":
        raise ValueError(f"Unsupported device {a_re.device}.")
    n_traj, n_seg, seg_len = a_re.shape[:3]
    n = a_re.shape[-1]
    if not 1 <= n <= 13 or not 1 <= len(cops) <= 8:
        raise ValueError(
            f"mcwf_rows takes 1 <= n <= 13 and 1 to 8 collapse operators,"
            f" not n={n} and {len(cops)}."
        )
    tensors = dict(
        a_re=a_re, a_im=a_im, cum_mod=cum_mod, t_stage=t_stage,
        seg_dts=seg_dts, us=us, eval_t=eval_t, eval_cum_mod=eval_cum_mod,
        r0=r0, diags=diags, psi0_re=psi0_re, psi0_im=psi0_im,
    )
    _check_inputs(tensors, _mcwf_rows_shapes(n_traj, n_seg, seg_len, n))
    lib = _load("mcwf_rows")
    dev = a_re.device
    dim = 1 << n
    table, g00, g11 = _cop_table(cops)
    cop_t = torch.from_numpy(table).to(dev)
    out = torch.empty((n_traj, n_seg, 2, dim), dtype=torch.float32, device=dev)
    jumps = torch.empty((n_traj,), dtype=torch.int32, device=dev)
    carried = torch.empty((n_traj,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.mcwf_rows_run(
        *(t.data_ptr() for t in tensors.values()),
        cop_t.data_ptr(), out.data_ptr(), jumps.data_ptr(),
        carried.data_ptr(),
        n_traj, n_seg, seg_len, n, len(cops), g00, g11, stream,
    )
    global MCWF_ROWS_CARRIED
    profiling.count(LAUNCH_COUNTER.format("mcwf_rows"))
    MCWF_ROWS_CARRIED = carried
    if err != 0:
        raise RuntimeError(f"mcwf_rows_run failed: CUDA error {err}.")
    return out, jumps


def mcwf_rows_carried_steps(
    cum_mod: torch.Tensor, t_stage: torch.Tensor, seg_dts: torch.Tensor
) -> tuple[torch.Tensor, int]:
    """The steps whose first rotor ``mcwf_rows_kernel`` carries over.

    The kernel keeps a step's end-of-step rotor for the next non-padding
    step when that step's first plan row equals the end row bit for bit:
    the shared stage time and the trajectory's n phase integrals.

    Args:
        cum_mod/t_stage/seg_dts: As :func:`mcwf_rows` takes them.

    Returns:
        ``(carried, n_real)``: the ``(B,)`` int64 number of such steps of
        each trajectory, and the number of non-padding steps (the first
        has no step before it, so at most ``n_real - 1`` are carried).
    """
    n_traj, n = cum_mod.shape[0], cum_mod.shape[-1]
    real = seg_dts.reshape(-1) != 0
    t = t_stage.reshape(-1, 3)[real].view(torch.int32)
    c = cum_mod.reshape(n_traj, -1, 3, n)[:, real].view(torch.int32)
    same = (t[1:, 0] == t[:-1, 2])[None] & (
        c[:, 1:, 0] == c[:, :-1, 2]
    ).all(-1)
    return same.sum(1), int(real.sum())


def mcwf_rows_reference(
    a_re: torch.Tensor,
    a_im: torch.Tensor,
    cum_mod: torch.Tensor,
    t_stage: torch.Tensor,
    seg_dts: torch.Tensor,
    us: torch.Tensor,
    eval_t: torch.Tensor,
    eval_cum_mod: torch.Tensor,
    r0: torch.Tensor,
    diags: torch.Tensor,
    psi0_re: torch.Tensor,
    psi0_im: torch.Tensor,
    *,
    cops: tuple,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`mcwf_rows` (same arguments).

    Runs on the inputs' device in float32 real/imaginary pairs, with the
    JAX kernel's operation order, vectorized over the trajectories. The
    step loop runs in Python on the host copy of ``seg_dts`` and skips
    the padding steps; jumps are applied with masks, so the loop never
    waits for the device.
    """
    n_traj, n_seg, seg_len = a_re.shape[:3]
    n = a_re.shape[-1]
    dim = 1 << n
    dev = a_re.device
    f32 = torch.float32
    h_host = seg_dts.cpu().numpy().astype(np.float32)
    idx = torch.arange(dim, device=dev)
    shifts = torch.arange(n - 1, -1, -1, device=dev)  # qubit q: bit n-1-q
    bits = ((idx[None, :] >> shifts[:, None]) & 1).to(f32)  # (n, dim)
    partners = idx[None, :] ^ (1 << shifts)[:, None]  # (n, dim)
    sign = 2.0 * bits - 1.0
    pop = bits.sum(0)
    table, g00, g11 = _cop_table(cops)
    g_d = _f32(g00) * (float(n) - pop) + _f32(g11) * pop
    cop = torch.from_numpy(table).to(dev)  # (K, 6)
    a_w = (0.0, 0.5, 0.5, 1.0)
    b_w = tuple(_f32(w) for w in (1 / 6, 1 / 3, 1 / 3, 1 / 6))
    two_pi = 2 * math.pi

    def phase(t: torch.Tensor, cum_row: torch.Tensor) -> torch.Tensor:
        """Φ = (diag·t mod 2π) + Σ_q cum_q·(1 − bit_q), summed in order."""
        ph = torch.remainder(diags * t, two_pi)
        for q in range(n):
            ph = ph + cum_row[:, q : q + 1] * (1.0 - bits[q])
        return ph

    pr = psi0_re.expand(n_traj, dim).clone()
    pi = psi0_im.expand(n_traj, dim).clone()
    r = r0.clone()
    jumps = torch.zeros((n_traj,), dtype=torch.int32, device=dev)
    out = torch.empty((n_traj, n_seg, 2, dim), dtype=f32, device=dev)
    sel_ids = torch.arange(len(cops) * n, device=dev)
    for s in range(n_seg):
        for i in range(seg_len):
            h = float(h_host[s, i])
            if h == 0.0:
                continue  # start padding of a short segment
            k_r = k_i = acc_r = acc_i = None
            for j in range(4):
                sidx = (j + 1) >> 1
                ha = h * a_w[j]
                xr = pr if j == 0 else pr + ha * k_r
                xi = pi if j == 0 else pi + ha * k_i
                ph = phase(t_stage[s, i, sidx], cum_mod[:, s, i, sidx, 0])
                c, sn = torch.cos(ph), torch.sin(ph)
                wr = c * xr + sn * xi  # w = e^{-iΦ} x
                wi = c * xi - sn * xr
                ar = a_re[:, s, i, sidx, 0]
                ai = a_im[:, s, i, sidx, 0]
                yr = torch.zeros_like(pr)
                yi = torch.zeros_like(pi)
                for q in range(n):
                    fr = wr[:, partners[q]]
                    fi = wi[:, partners[q]]
                    arq = ar[:, q : q + 1]
                    aiq = ai[:, q : q + 1] * sign[q]
                    yr = yr + arq * fr - aiq * fi
                    yi = yi + arq * fi + aiq * fr
                # k = -i e^{+iΦ} y − ½ g ⊙ x
                k_r = c * yi + sn * yr - 0.5 * g_d * xr
                k_i = sn * yi - c * yr - 0.5 * g_d * xi
                acc_r = b_w[j] * k_r if j == 0 else acc_r + b_w[j] * k_r
                acc_i = b_w[j] * k_i if j == 0 else acc_i + b_w[j] * k_i
            pr = pr + h * acc_r
            pi = pi + h * acc_i

            # Quantum jumps: channel (k outer, q inner) searchsorted-left
            p2 = pr * pr + pi * pi
            norm2 = p2.sum(1)
            p1 = p2 @ bits.T  # (B, n)
            p0 = p2 @ (1.0 - bits).T
            weights = (
                cop[None, :, 4:5] * p0[:, None] + cop[None, :, 5:6] * p1[:, None]
            ).reshape(n_traj, -1)
            cum_w = torch.cumsum(weights, 1)
            prev = torch.cat([torch.zeros_like(cum_w[:, :1]), cum_w[:, :-1]], 1)
            u = us[:, s, i, 0:1] * cum_w[:, -1:]
            hit = (u <= cum_w) & ((sel_ids == 0) | (u > prev))
            has_hit = hit.any(1)
            sel = torch.argmax(hit.to(torch.int8), 1)
            w_sel = torch.where(
                has_hit, weights.gather(1, sel[:, None])[:, 0], 0.0
            )
            inv = torch.rsqrt(torch.clamp(w_sel, min=1e-30))[:, None]
            one = bits[sel % n]  # (B, dim) bits of the chosen qubit
            row = cop[sel // n]
            c_re = row[:, 0:1] * (1.0 - one) + row[:, 2:3] * one
            c_im = row[:, 1:2] * (1.0 - one) + row[:, 3:4] * one
            hit_f = has_hit.to(f32)[:, None]
            jr = hit_f * (c_re * pr - c_im * pi) * inv
            ji = hit_f * (c_re * pi + c_im * pr) * inv
            jump = norm2 <= r
            pr = torch.where(jump[:, None], jr, pr)
            pi = torch.where(jump[:, None], ji, pi)
            r = torch.where(jump, us[:, s, i, 1], r)
            jumps += jump.to(torch.int32)
        # Emit normalized, rotated to the lab frame
        inv_n = torch.rsqrt(
            torch.clamp((pr * pr + pi * pi).sum(1, keepdim=True), min=1e-30)
        )
        pr_n = pr * inv_n
        pi_n = pi * inv_n
        ph = phase(eval_t[s], eval_cum_mod[:, s, 0])
        c, sn = torch.cos(ph), torch.sin(ph)
        out[:, s, 0] = c * pr_n + sn * pi_n
        out[:, s, 1] = c * pi_n - sn * pr_n
    return out, jumps


#: Static collapse algebra of :func:`mcwf`: per operator, its local 2×2 as
#: 8 floats ``(l00r, l00i, l01r, l01i, l10r, l10i, l11r, l11i)``.
CopTuple = tuple[float, float, float, float, float, float, float, float]


def _mcwf_shapes(
    n_seg: int, n_traj: int, seg_len: int, n_row: int, n_col: int
) -> dict[str, tuple[int, ...]]:
    rows, cols = 1 << n_row, 1 << n_col
    stage = (n_seg, seg_len, 3, n_row + n_col)
    return dict(
        a_re=stage, a_im=stage, det=stage, seg_dts=(n_seg, seg_len, 1),
        us=(n_seg, seg_len, 2), r0=(n_traj, 1), diag2d=(n_traj, rows, cols),
        psi0_re=(rows, cols), psi0_im=(rows, cols),
    )


def mcwf(
    a_re: torch.Tensor,
    a_im: torch.Tensor,
    det: torch.Tensor,
    seg_dts: torch.Tensor,
    us: torch.Tensor,
    r0: torch.Tensor,
    diag2d: torch.Tensor,
    psi0_re: torch.Tensor,
    psi0_im: torch.Tensor,
    *,
    n_row: int,
    n_col: int,
    seg_len: int,
    segs_per_traj: int,
    cops: tuple[CopTuple, ...],
    g_diag: tuple[float, float],
    g_lo: tuple[float, float],
) -> tuple[torch.Tensor, torch.Tensor]:
    """Lab-frame quantum-jump (MCWF) solve with general 2×2 collapse
    operators (d=2, one basis, f32).

    Inputs follow the JAX package's ``_mcwf_jit``: the ``n_seg = B·S``
    rows are B trajectories of ``S = segs_per_traj`` segments of
    ``L = seg_len`` steps, trajectory-major; n = n_row + n_col qubits
    (``R = 2^n_row``, ``C = 2^n_col``, the flat index is row·C + col).

    Args:
        a_re/a_im: ``(n_seg, L, 3, n)`` drive stages (0.5·Ω·e^{-iφ}).
        det: ``(n_seg, L, 3, n)`` detuning stages.
        seg_dts: ``(n_seg, L, 1)`` step sizes (0 = padding).
        us: ``(n_seg, L, 2)`` per-step uniforms (channel selector, next
            threshold).
        r0: ``(B, 1)`` initial jump thresholds.
        diag2d: ``(B, R, C)`` interaction diagonals.
        psi0_re/psi0_im: ``(R, C)`` shared initial state.
        cops: Per collapse operator, its local 2×2 as 8 floats
            (:data:`CopTuple`; at most 8 operators).
        g_diag: ``(G00, G11)``, the diagonal of ``G = Σ_k L_k†L_k``.
        g_lo: ``(re, im)`` of ``G[1, 0]``.

    Returns:
        ``(states, jumps)``: ``(B, S, 2, 2^n)`` float32 normalized states
        after each segment (real and imaginary planes; ``_mcwf_jit``'s
        ``(n_seg, 2, R, C)`` output reshaped) and the ``(B,)`` int32
        number of jumps of each trajectory.
    """
    kw = dict(
        n_row=n_row, n_col=n_col, seg_len=seg_len,
        segs_per_traj=segs_per_traj, cops=cops, g_diag=g_diag, g_lo=g_lo,
    )
    tensors = dict(
        a_re=a_re, a_im=a_im, det=det, seg_dts=seg_dts, us=us, r0=r0,
        diag2d=diag2d, psi0_re=psi0_re, psi0_im=psi0_im,
    )
    if a_re.device.type == "cpu":
        return mcwf_reference(*tensors.values(), **kw)
    if a_re.device.type != "cuda":
        raise ValueError(f"Unsupported device {a_re.device}.")
    n = n_row + n_col
    n_seg = a_re.shape[0]
    if not 1 <= n <= 13 or not 1 <= len(cops) <= 8:
        raise ValueError(
            f"mcwf takes 1 <= n <= 13 and 1 to 8 collapse operators, not"
            f" n={n} and {len(cops)}."
        )
    if n_seg % segs_per_traj:
        raise ValueError(
            f"{n_seg} segment rows are not a whole number of trajectories"
            f" of {segs_per_traj} segments."
        )
    n_traj = n_seg // segs_per_traj
    _check_inputs(tensors, _mcwf_shapes(n_seg, n_traj, seg_len, n_row, n_col))
    lib = _load("mcwf")
    dev = a_re.device
    dim = 1 << n
    cop_t = torch.tensor(cops, dtype=torch.float32).reshape(-1, 8).to(dev)
    out = torch.empty(
        (n_traj, segs_per_traj, 2, dim), dtype=torch.float32, device=dev
    )
    jumps = torch.empty((n_traj,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.mcwf_run(
        *(t.data_ptr() for t in tensors.values()),
        cop_t.data_ptr(), out.data_ptr(), jumps.data_ptr(),
        n_traj, segs_per_traj, seg_len, n, len(cops),
        g_diag[0], g_diag[1], g_lo[0], g_lo[1], stream,
    )
    profiling.count(LAUNCH_COUNTER.format("mcwf"))
    if err != 0:
        raise RuntimeError(f"mcwf_run failed: CUDA error {err}.")
    return out, jumps


def mcwf_reference(
    a_re: torch.Tensor,
    a_im: torch.Tensor,
    det: torch.Tensor,
    seg_dts: torch.Tensor,
    us: torch.Tensor,
    r0: torch.Tensor,
    diag2d: torch.Tensor,
    psi0_re: torch.Tensor,
    psi0_im: torch.Tensor,
    *,
    n_row: int,
    n_col: int,
    seg_len: int,
    segs_per_traj: int,
    cops: tuple[CopTuple, ...],
    g_diag: tuple[float, float],
    g_lo: tuple[float, float],
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`mcwf` (same arguments).

    The lab-frame branch of the JAX package's ``_mcwf_traj_states`` with
    the trajectory axis written out, in complex64 on the inputs' device,
    in the TPU kernel's formulation: ``H_eff`` as a real diagonal, the
    constant imaginary diagonal ``−½G`` and G's off-diagonal folded into
    the flip entries; jumps chosen by running comparisons (``u > prev``
    and ``u <= cum``, the last candidate also taking ``u <= 0``) rather
    than a searchsorted, so that it agrees with the kernel jump for jump.
    The step loop runs in Python over the host copy of ``seg_dts`` and
    skips steps that are padding for every trajectory; the candidates
    are formed only on steps where some trajectory jumps.
    """
    n = n_row + n_col
    dim = 1 << n
    n_seg = a_re.shape[0]
    n_s = segs_per_traj
    n_traj = n_seg // n_s
    dev = a_re.device
    f32 = torch.float32
    stage = (n_traj, n_s, seg_len, 3, n)
    a = torch.complex(a_re, a_im).reshape(stage)
    dt = det.reshape(stage)
    hs = seg_dts.reshape(n_traj, n_s, seg_len)
    h_host = hs.cpu().numpy()
    u_all = us.reshape(n_traj, n_s, seg_len, 2)
    diag = diag2d.reshape(n_traj, dim)
    idx = torch.arange(dim, device=dev)
    shifts = torch.arange(n - 1, -1, -1, device=dev)  # qubit q: bit n-1-q
    bits = ((idx[None, :] >> shifts[:, None]) & 1).bool()  # (n, dim)
    bits_f = bits.to(f32)
    partners = idx[None, :] ^ (1 << shifts)[:, None]  # (n, dim)
    pop = bits_f.sum(0)
    g00, g11 = _f32(g_diag[0]), _f32(g_diag[1])
    d_im = (-0.5 * (g00 * (float(n) - pop) + g11 * pop)).expand(n_traj, dim)
    # -(i/2) G[1,0] on the |1><0| entries, -(i/2) conj(G[1,0]) on |0><1|
    k_lo = complex(0.5 * _f32(g_lo[1]), -0.5 * _f32(g_lo[0]))
    k_up = complex(-0.5 * _f32(g_lo[1]), -0.5 * _f32(g_lo[0]))
    ops = torch.tensor(
        [[complex(c[2 * e], c[2 * e + 1]) for e in range(4)] for c in cops],
        dtype=torch.complex64,
    ).reshape(-1, 2, 2).to(dev)
    n_cand = len(cops) * n
    a_w = (0.0, 0.5, 0.5, 1.0)
    b_w = tuple(_f32(w) for w in (1 / 6, 1 / 3, 1 / 3, 1 / 6))

    def deriv(x: torch.Tensor, s: int, i: int, sidx: int) -> torch.Tensor:
        """``−i H_eff x`` for the stage sample ``sidx`` of step i."""
        amp = a[:, s, i, sidx]  # (B, n)
        dets = dt[:, s, i, sidx]
        coef = torch.where(
            bits[None], (amp + k_lo)[:, :, None], (amp.conj() + k_up)[:, :, None]
        )  # (B, n, dim): the entry into each output amplitude
        flips = (coef * x[:, partners]).sum(1)
        dr = diag - dets.sum(1, keepdim=True) + dets @ bits_f
        return neg_i(torch.complex(dr, d_im) * x + flips)

    psi = torch.complex(psi0_re, psi0_im).reshape(1, dim).repeat(n_traj, 1)
    r = r0.reshape(n_traj).clone()
    jumps = torch.zeros((n_traj,), dtype=torch.int32, device=dev)
    out = torch.empty((n_traj, n_s, 2, dim), dtype=f32, device=dev)
    rows = torch.arange(n_traj, device=dev)
    for s in range(n_s):
        for i in range(seg_len):
            if not h_host[:, s, i].any():
                continue  # start padding of a short segment
            h = hs[:, s, i, None]  # (B, 1)
            k = acc = None
            for j in range(4):
                x = psi if j == 0 else psi + (h * a_w[j]) * k
                k = deriv(x, s, i, (j + 1) >> 1)
                acc = b_w[j] * k if j == 0 else acc + b_w[j] * k
            psi = psi + h * acc
            # A trajectory that pads this step keeps its state and norm
            norm2 = (psi.real**2 + psi.imag**2).sum(1)
            jump = (norm2 <= r) & (h[:, 0] != 0)
            if not bool(jump.any()):
                continue
            cands = torch.stack(
                [
                    apply_axis_c(op, psi, q, 2, n)
                    for op in ops
                    for q in range(n)
                ],
                1,
            )  # (B, K·n, dim), operator outer, qubit inner
            w = (cands.real**2 + cands.imag**2).sum(-1)
            total = w[:, 0]
            for c in range(1, n_cand):
                total = total + w[:, c]
            u = u_all[:, s, i, 0] * total
            sel = torch.full((n_traj,), -1, dtype=torch.long, device=dev)
            cum = torch.zeros_like(total)
            for c in range(n_cand):
                prev = cum
                cum = cum + w[:, c]
                hit = (u > prev) & (u <= cum)
                if c == n_cand - 1:
                    hit = hit | (u <= 0)
                sel = torch.where((sel < 0) & hit, c, sel)
            chosen = sel.clamp(min=0)
            w_sel = torch.where(sel >= 0, w[rows, chosen], 0.0)
            inv = torch.rsqrt(torch.clamp(w_sel, min=1e-30))
            new = cands[rows, chosen] * torch.where(sel >= 0, inv, 0.0)[:, None]
            psi = torch.where(jump[:, None], new, psi)
            r = torch.where(jump, u_all[:, s, i, 1], r)
            jumps += jump.to(torch.int32)
        norm2 = (psi.real**2 + psi.imag**2).sum(1, keepdim=True)
        psi_n = psi * torch.rsqrt(torch.clamp(norm2, min=1e-30))
        out[:, s, 0] = psi_n.real
        out[:, s, 1] = psi_n.imag
    return out, jumps
