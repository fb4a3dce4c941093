"""Fixed-step Schrödinger solver over a host-built time grid, in PyTorch.

Port of ``pulser_tpu/ops/solver.py``. QuTiP's adaptive ``sesolve`` is
replaced by fixed-step RK4:

- the Hamiltonian's coefficients are **piecewise linear** between the
  sampling knots (exactly QobjEvo's tlist interpolation), so the three
  RK4 stage values per step are precomputed on the host;
- the integration grid is the union of the sampling knots and the
  requested evaluation times (optionally subdivided), so evaluation
  states are exact grid points;
- the solve runs in the **interaction picture** where it can: the static
  interaction diagonal and the detuning are rotated away exactly, and
  RK4 only integrates the drive term. With the XY term or the SLM mask's
  interaction interpolation (``int_w``) it runs in the lab frame.

States are native complex tensors; the TPU's ``(2, dim)`` real pairs are
gone. For 10 ≤ n ≤ 17 qubits in single precision on a CUDA device the
interaction-picture solve runs through the hand-written kernel of
:mod:`pulser_tpu_torch.ops.kernels`; every other configuration runs a
torch loop (:func:`_scan_segments` over :func:`_ip_terms` or
:func:`_lab_terms`).

A noise-trajectory batch without collapse operators runs
:func:`sesolve_rk4_batched`: the same kernel in its trajectory-batched
mode under the same gate, else the torch loop with a batch axis.

The quantum-jump (MCWF) batch (:func:`mcsolve_rk4_batched`) runs one of
two hand-written kernels (:func:`_mcwf_route`): the row-batched
interaction-picture solve with diagonal collapse operators, or the
lab-frame solve with general local 2×2 collapse operators (on CPU
tensors each runs its plain PyTorch version); every other configuration
runs the torch scan :func:`_mcwf_traj_states`, which also serves the
serial, trajectory-averaged :func:`mcsolve_rk4`.

The Lindblad master equation (:func:`mesolve_rk4`, and
:func:`mesolve_rk4_batched` for one density matrix per noise trajectory)
is a torch loop with native complex density matrices
(:func:`_mesolve_scan`): in the interaction picture on the coarsened
grid when every collapse operator is diagonal, in the lab frame
otherwise (with the XY term there). The JAX package computes the torch
loops' solves in XLA, outside any Pallas kernel.

Every solve takes the JAX package's sharding arguments: ``mesh`` splits
a trajectory batch over the ranks of a ``torch.distributed`` mesh,
``state_mesh`` the state's ``2^N`` axis (or ρ's rows); see
:mod:`pulser_tpu_torch.parallel`. A mesh of more than one rank runs the
torch loops, never a kernel (as the JAX package turns its Pallas routes
off under a mesh), and every rank returns the whole result.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from pulser_tpu_torch import profiling
from pulser_tpu_torch.ops.apply import (
    _digits_of,
    _group_matrix,
    apply_block_c,
    apply_flip_flop_r,
    build_drive_matrices,
    candidate_coefs,
    group_sizes,
    jump_candidates,
)
from pulser_tpu_torch.parallel.capacity import (
    LIVE_STATE_BUFFERS,
    STAGE_CHUNK_BYTES,
)
from pulser_tpu_torch.parallel.comm import mesh_size as _mesh_size


@dataclasses.dataclass(frozen=True)
class EvolutionPlan:
    """Host-precomputed stage data for the fixed-step evolution.

    Attributes:
        dts: ``(n_steps,)`` step sizes (in µs).
        store_idx: ``(n_steps,)`` int32 output slot written after each
            step (``n_eval`` points to the dump row).
        n_eval: Number of evaluation times.
        eval_idx0: Whether t=0 is an evaluation time (slot 0).
        stage_arrays: Mapping of coefficient name to ``(n_steps, 3, ...)``
            stage values (t, t+h/2, t+h per step).
        grid: The full integration grid (µs), for reference.
        eval_times: The evaluation times (µs).
    """

    dts: np.ndarray
    store_idx: np.ndarray
    n_eval: int
    eval_idx0: int | None
    stage_arrays: dict[str, np.ndarray]
    grid: np.ndarray
    eval_times: np.ndarray
    #: Maps each ORIGINAL (possibly near-duplicate) eval time to its
    #: unique slot, so solver outputs match the requested times 1:1.
    eval_map: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([], dtype=np.int32)
    )
    #: Segmented layout: ``seg_map[s, i]`` is the flat step index of
    #: inner step ``i`` of segment ``s`` (segments end exactly at the
    #: unique eval times; shorter segments are padded at the START by
    #: repeating their first step index with a zero ``seg_dts`` entry).
    #: The solvers loop over segments and emit the state after each
    #: one.
    seg_map: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 0), dtype=np.int64)
    )
    seg_dts: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 0))
    )
    #: Exact detuning integrals at the (unique) eval times, for the
    #: interaction-picture lab-frame rotation: (n_eval, n_bases, n).
    eval_det_cum: np.ndarray | None = None
    #: ``(idx0, idx1, frac)`` arrays of shape (n_steps, 3): the knot
    #: gather indices + lerp fractions behind each staged value, for
    #: on-device staging of raw coefficients.
    stage_knots: tuple[np.ndarray, ...] | None = None
    #: The original coefficient sample times (µs) — the gather target
    #: of ``stage_knots`` — for staging derived quantities (e.g. the
    #: exact detuning integrals) from raw coefficients on-device.
    knots: np.ndarray | None = None
    #: Per-plan scratch for solver-side memoization (device-resident
    #: input buffers, staged-layout gathers). Excluded from equality;
    #: safe to mutate on the frozen dataclass because only the dict's
    #: CONTENTS change.
    runtime_cache: dict = dataclasses.field(
        default_factory=dict, compare=False, repr=False
    )

    def seg_stage(self, name: str) -> np.ndarray:
        """A stage array gathered into the (n_seg, L, 3, ...) layout."""
        key = ("seg_stage", name)
        hit = self.runtime_cache.get(key)
        if hit is None:
            hit = self.stage_arrays[name][self.seg_map]
            self.runtime_cache[key] = hit
        return hit


def _interp_at(
    coeffs: np.ndarray, knots: np.ndarray, times: np.ndarray
) -> np.ndarray:
    """Linear interpolation of knot-sampled coefficients at new times.

    Matches QobjEvo's linear interpolation between tlist points, with
    constant extrapolation outside the knot range.

    Args:
        coeffs: Array with the time axis LAST, shape ``(..., n_knots)``.
        knots: ``(n_knots,)`` ascending times.
        times: ``(m,)`` times to evaluate at.

    Returns:
        ``(..., m)`` interpolated values.
    """
    if len(knots) == 1:
        return np.repeat(coeffs, len(times), axis=-1)
    idx = np.clip(
        np.searchsorted(knots, times, side="right") - 1,
        0,
        len(knots) - 2,
    )
    t0 = knots[idx]
    t1 = knots[idx + 1]
    frac = np.clip((times - t0) / (t1 - t0), 0.0, 1.0)
    return coeffs[..., idx] * (1 - frac) + coeffs[..., idx + 1] * frac


def _integ_at(
    coeffs: np.ndarray, knots: np.ndarray, times: np.ndarray
) -> np.ndarray:
    """Exact cumulative integral of piecewise-linear coefficients.

    ``∫₀ᵗ c(t') dt'`` with ``c`` linear between knots (constant outside
    the knot range), evaluated at arbitrary times — closed-form
    (piecewise quadratic), no quadrature error.

    Args:
        coeffs: Array with the time axis LAST, shape ``(..., n_knots)``.
        knots: ``(n_knots,)`` ascending times (first knot defines t=0
            of the integral).
        times: ``(m,)`` times to evaluate at.

    Returns:
        ``(..., m)`` integral values.
    """
    if len(knots) == 1:
        return coeffs * (times - knots[0])
    seg = np.diff(knots)
    # Cumulative integral at the knots (trapezoid, exact for pw-linear)
    cum_knots = np.concatenate(
        [
            np.zeros(coeffs.shape[:-1] + (1,)),
            np.cumsum(
                0.5 * (coeffs[..., 1:] + coeffs[..., :-1]) * seg,
                axis=-1,
            ),
        ],
        axis=-1,
    )
    idx = np.clip(
        np.searchsorted(knots, times, side="right") - 1,
        0,
        len(knots) - 2,
    )
    t0 = knots[idx]
    dt = np.clip(times - t0, 0.0, None)
    dt_in = np.minimum(dt, seg[idx])  # inside the segment
    slope = (coeffs[..., idx + 1] - coeffs[..., idx]) / seg[idx]
    inner = (
        cum_knots[..., idx]
        + coeffs[..., idx] * dt_in
        + 0.5 * slope * dt_in**2
    )
    # Constant extrapolation past the last knot
    return inner + coeffs[..., idx + 1] * np.clip(
        dt - seg[idx], 0.0, None
    )


def build_plan(
    knots: np.ndarray,
    coeffs: dict[str, np.ndarray],
    eval_times: np.ndarray,
    max_step: float | None = None,
    host_stage: bool = True,
    coarsen: bool = False,
    breakpoints: "np.ndarray | None" = None,
) -> EvolutionPlan:
    """Builds the host-side evolution plan.

    Args:
        knots: ``(n_knots,)`` ascending coefficient sample times (µs).
        coeffs: Mapping of name to coefficient array with time last,
            shape ``(..., n_knots)``.
        eval_times: Times (µs) at which the state must be stored. Must
            lie within ``[knots[0], knots[-1]]`` (clipped otherwise).
        max_step: Optional maximum step size (µs). Grid intervals larger
            than this are subdivided evenly. Defaults to the median knot
            spacing (i.e. no subdivision on a uniform grid).
        coarsen: Allow steps LARGER than the knot spacing: the grid is
            built from the eval times alone (subdivided at
            ``max_step``) instead of containing every knot. Stage
            values still read the full knot data — they are lerped at
            the stage times, and the detuning phase integrals remain
            exact closed forms over all knots — so only the RK4
            quadrature of the (slow) drive term coarsens.
        breakpoints: Extra mandatory grid times for the coarsened
            grid — sharp coefficient kinks (pulse edges) that a large
            step would otherwise smear across its stages.
    """
    from pulser_tpu_torch import native

    knots = np.asarray(knots, dtype=float)
    eval_times_in = np.unique(np.asarray(eval_times, dtype=float))
    t_end = knots[-1]
    eval_times_in = np.clip(eval_times_in, knots[0], t_end)
    if max_step is None:
        spacings = np.diff(knots)
        max_step = float(np.median(spacings)) if len(spacings) else 1e-3

    # Merge near-duplicate eval times (fp artifacts like 0.7 vs
    # 0.7000000000000001), remembering the original->unique mapping
    merged = native.merge_eval_times(eval_times_in)
    if merged is not None:
        eval_times, eval_map = merged
    else:
        uniq: list[float] = []
        eval_map = np.empty(len(eval_times_in), dtype=np.int32)
        for i, t in enumerate(eval_times_in):
            if not uniq or t - uniq[-1] > 1e-9:
                uniq.append(float(t))
            eval_map[i] = len(uniq) - 1
        eval_times = np.array(uniq)
    n_eval = len(eval_times)

    # Integration grid + post-step output-slot mapping: native plan
    # compiler when available, numpy fallback otherwise. A coarsened
    # plan anchors the grid only at the evolution endpoints + eval
    # times (the native builder unions its first argument, so passing
    # just the endpoints reuses it unchanged).
    if coarsen and len(knots) > 2:
        grid_knots = knots[[0, -1]]
        if breakpoints is not None and len(breakpoints):
            grid_knots = np.unique(
                np.concatenate([grid_knots, breakpoints])
            )
    else:
        grid_knots = knots
    built = native.build_grid(grid_knots, eval_times, max_step)
    if built is not None:
        grid, store_idx = built
        dts = np.diff(grid)
        n_steps = len(dts)
    else:
        grid = np.union1d(grid_knots, eval_times)
        # Subdivide long intervals
        pieces = [np.array([grid[0]])]
        for a, b in zip(grid[:-1], grid[1:]):
            m = max(
                1, int(np.ceil((b - a) / (max_step * (1 + 1e-9))))
            )
            pieces.append(np.linspace(a, b, m + 1)[1:])
        grid = np.concatenate(pieces)
        # Deduplicate within tolerance
        keep = np.ones(len(grid), dtype=bool)
        keep[1:] = np.diff(grid) > 1e-12
        grid = grid[keep]

        dts = np.diff(grid)
        n_steps = len(dts)

        # Map each post-step time to an eval slot (or the dump row)
        store_idx = np.full(n_steps, n_eval, dtype=np.int32)
        eval_pos = np.searchsorted(grid, eval_times)
        # Snap to nearest grid point (within fp tolerance)
        for slot, t in enumerate(eval_times):
            pos = eval_pos[slot]
            cand = [
                p
                for p in (pos - 1, pos, pos + 1)
                if 0 <= p < len(grid) and abs(grid[p] - t) < 1e-9
            ]
            assert cand, (t, "not on the integration grid")
            p = cand[0]
            if p > 0:
                store_idx[p - 1] = slot
    eval_idx0 = None
    if abs(grid[0] - eval_times[0]) < 1e-9 if n_eval else False:
        eval_idx0 = 0

    # Segmented layout: segment s holds the steps ending at eval slot
    # s (start-padded to the max segment length with repeated indices
    # and zero dts)
    ends = np.full(n_eval, -2, dtype=np.int64)
    for i, s in enumerate(store_idx):
        if s < n_eval:
            ends[s] = i
    if eval_idx0 is not None:
        ends[0] = -1  # eval at t=0: zero-length segment
    assert (ends >= -1).all(), "unmapped evaluation slot"
    prev = np.concatenate([[-1], ends[:-1]])
    seg_lens = ends - prev
    seg_len = max(int(seg_lens.max()), 1) if n_eval else 1
    pad = seg_len - seg_lens  # (n_eval,)
    inner = np.arange(seg_len)
    rel = np.maximum(inner[None, :] - pad[:, None], 0)
    seg_map = np.minimum(
        prev[:, None] + 1 + rel, max(n_steps - 1, 0)
    ).astype(np.int64)
    seg_dts = np.where(
        inner[None, :] >= pad[:, None], dts[seg_map], 0.0
    )

    # Precompute the three RK4 stage values per step for each coefficient
    stage_times = np.stack(
        [grid[:-1], (grid[:-1] + grid[1:]) / 2, grid[1:]], axis=1
    )  # (n_steps, 3)
    flat_times = stage_times.reshape(-1)
    # Knot gather indices + lerp fractions for the same stages, so
    # solvers can move the (large) staging gather onto the device and
    # transfer only the raw (..., n_knots) coefficients
    if len(knots) == 1:
        k_idx0 = np.zeros(len(flat_times), dtype=np.int32)
        k_idx1 = k_idx0
        k_frac = np.zeros(len(flat_times))
    else:
        k_idx0 = np.clip(
            np.searchsorted(knots, flat_times, side="right") - 1,
            0,
            len(knots) - 2,
        ).astype(np.int32)
        k_idx1 = k_idx0 + 1
        k_frac = np.clip(
            (flat_times - knots[k_idx0])
            / (knots[k_idx1] - knots[k_idx0]),
            0.0,
            1.0,
        )
    stage_knots = tuple(
        a.reshape(n_steps, 3) for a in (k_idx0, k_idx1, k_frac)
    )
    stage_arrays = {}
    for name, c in coeffs.items():
        if not host_stage:
            break
        vals = _interp_at(np.asarray(c), knots, flat_times)
        # (..., n_steps*3) -> (n_steps, 3, ...)
        vals = np.moveaxis(
            vals.reshape(c.shape[:-1] + (n_steps, 3)), (-2, -1), (0, 1)
        )
        stage_arrays[name] = vals
    # Exact detuning integrals + absolute stage times, for the
    # interaction-picture solver (phase = ∫D dt', closed-form)
    if host_stage and "det" in coeffs:
        cum = _integ_at(
            np.asarray(coeffs["det"]).real, knots, flat_times
        )
        stage_arrays["det_cum"] = np.moveaxis(
            cum.reshape(coeffs["det"].shape[:-1] + (n_steps, 3)),
            (-2, -1),
            (0, 1),
        )
        # The same integrals at the eval times (IP lab-frame rotation)
        cum_eval = _integ_at(
            np.asarray(coeffs["det"]).real, knots, eval_times
        )
        eval_cum = np.moveaxis(cum_eval, -1, 0)  # (n_eval, nb, n)
    stage_arrays["t_stage"] = stage_times - knots[0]

    return EvolutionPlan(
        dts=dts,
        store_idx=store_idx,
        n_eval=n_eval,
        eval_idx0=eval_idx0,
        stage_arrays=stage_arrays,
        grid=grid,
        eval_times=eval_times,
        eval_map=eval_map,
        seg_map=seg_map,
        seg_dts=seg_dts,
        eval_det_cum=(
            eval_cum if host_stage and "det" in coeffs else None
        ),
        stage_knots=stage_knots,
        knots=knots,
    )


#: Shape/step metadata of the most recent solve, for telemetry.
last_solve_info: dict[str, Any] = {}


def _numpy_dtype(dtype: Any) -> np.dtype:
    """The numpy dtype matching a numpy or torch dtype."""
    if isinstance(dtype, torch.dtype):
        return np.dtype(str(dtype).removeprefix("torch."))
    return np.dtype(dtype)


def _complex_dtype(dtype: Any) -> np.dtype:
    """The complex numpy dtype of a numpy or torch dtype (a real one is
    promoted: float64 to complex128, float32 to complex64)."""
    return np.result_type(_numpy_dtype(dtype), np.complex64)


def _torch_dtype(dtype: Any) -> torch.dtype:
    """The torch dtype matching a numpy dtype."""
    return torch.from_numpy(np.zeros(0, dtype=_numpy_dtype(dtype))).dtype


def _resolve_device(device: Any) -> torch.device:
    """The given device; ``None`` means this process's CUDA device.

    Under an initialized ``torch.distributed`` process group that is the
    rank's card: ``cuda:{LOCAL_RANK}`` when the launcher numbered it
    among the visible cards, else the current CUDA device (ranks that
    share one card all use it). Without a group, the first CUDA device.

    Raises:
        RuntimeError: ``device`` is None or a CUDA device, and no CUDA
            device is visible (the entry points never move to the CPU on
            their own).
    """
    if (device is None or torch.device(device).type == "cuda") and (
        not torch.cuda.is_available()
    ):
        raise RuntimeError(
            "No CUDA device is visible. To run on the CPU, ask for it:"
            " torch_device='cpu' (TorchEmulator) or device='cpu' (the"
            " solver functions)."
        )
    if device is None:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            local = os.environ.get("LOCAL_RANK")
            if local is not None and int(local) < torch.cuda.device_count():
                return torch.device("cuda", int(local))
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cuda")
    return torch.device(device)


#: The public name of :func:`_resolve_device`, for scripts that resolve
#: their ``--device`` as the entry points do.
resolve_device = _resolve_device


def _stage_host(host: Any, device: Any, dtype: Any = None) -> torch.Tensor:
    """A host array on ``device``: cast on the host to the numpy ``dtype``
    (default: its own), then copied from pageable memory, which waits for
    the card. Every copy counts once as ``sync.solver.stage``."""
    profiling.count("sync.solver.stage")
    return torch.from_numpy(np.ascontiguousarray(host, dtype=dtype)).to(
        device
    )


class DeviceStateBatch:
    """Device-resident ``(n_eval, dim)`` solver output, fetched lazily.

    The solver output stays on the device and converts on demand:

    - :meth:`state` fetches ONE evaluation-time state;
    - :meth:`fetch_all` moves the whole batch in a single transfer and
      caches it; reading many states individually upgrades to it
      automatically.

    Args:
        dev: The raw device tensor, indexed by *segment* on axis 0.
        eval_map: Maps evaluation index -> segment index.
        to_complex: Converts one fetched host slice to a ``(dim,)``
            complex vector.
        normalize: Renormalize each state on fetch (coarse RK4 steps
            drift the norm by ~1e-6/µs on an exactly-unitary
            evolution; see ``TorchEmulator._run_solver``).
    """

    #: Individual fetches before upgrading to one bulk transfer.
    _BULK_THRESHOLD = 8

    def __init__(
        self,
        dev: torch.Tensor,
        eval_map: np.ndarray,
        to_complex: Callable[[np.ndarray], np.ndarray],
        normalize: bool = False,
        to_complex_dev: Callable[[torch.Tensor], torch.Tensor] | None = None,
    ):
        self._dev: torch.Tensor | None = dev
        self._eval_map = np.asarray(eval_map)
        self._to_complex = to_complex
        self._to_complex_dev = to_complex_dev or (lambda x: x)
        self.normalize = normalize
        self._all: np.ndarray | None = None
        self._cache: dict[int, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self._eval_map)

    def sync(self) -> None:
        """Blocks until the device computation that wrote the states has
        finished (a no-op once they have been fetched, and on the CPU)."""
        if self._dev is not None and self._dev.device.type == "cuda":
            profiling.count("sync.results.sync")
            torch.cuda.synchronize(self._dev.device)

    def _post(self, vec: np.ndarray) -> np.ndarray:
        if not self.normalize:
            return vec
        nrm = np.linalg.norm(vec)
        return vec if nrm == 0 else vec / nrm

    def state(self, i: int) -> np.ndarray:
        """The ``(dim,)`` complex state at evaluation index ``i``."""
        i = int(i)
        if i < 0:
            i += len(self)
        if self._all is not None:
            return self._all[i]
        if i not in self._cache:
            if len(self._cache) >= self._BULK_THRESHOLD:
                return self.fetch_all()[i]
            assert self._dev is not None
            with profiling.phase("results.fetch"):
                seg = int(self._eval_map[i])
                profiling.count("sync.results.fetch")
                host = self._dev[seg].cpu().numpy()
                self._cache[i] = self._post(self._to_complex(host))
        return self._cache[i]

    def device_state(self, i: int) -> torch.Tensor:
        """The ``(dim,)`` complex state at evaluation index ``i``, on the
        device (renormalized there when ``normalize`` is set)."""
        if self._dev is None:
            # The batch was fetched whole: the states are on the host
            return torch.from_numpy(self.state(i))
        vec = self._to_complex_dev(self._dev[int(self._eval_map[int(i)])])
        if not self.normalize:
            return vec
        nrm = torch.linalg.vector_norm(vec)
        # The comparison reads the norm on the host
        profiling.count("sync.results.norm")
        return vec if nrm == 0 else vec / nrm

    def device_norm(self, i: int) -> torch.Tensor:
        """The norm of the state at evaluation index ``i`` as the solver
        left it (before any renormalization), reduced on the device; a
        0-d tensor. Once the batch was fetched whole, the host copy's."""
        if self._dev is None:
            return torch.linalg.vector_norm(torch.from_numpy(self.state(i)))
        vec = self._to_complex_dev(self._dev[int(self._eval_map[int(i)])])
        return torch.linalg.vector_norm(vec)

    def fetch_all(self) -> np.ndarray:
        """All states as one host ``(n_eval, dim)`` array (cached)."""
        if self._all is None:
            assert self._dev is not None
            with profiling.phase("results.fetch"):
                profiling.count("sync.results.fetch")
                host = self._dev.cpu().numpy()[self._eval_map]
                self._all = np.stack(
                    [self._post(self._to_complex(h)) for h in host]
                )
            self._dev = None
            self._cache = {}
        return self._all


def sesolve_rk4(
    psi0: np.ndarray,
    plan: EvolutionPlan,
    static_diag: np.ndarray,
    pairs: tuple[tuple[int, int, int], ...],
    d: int,
    n: int,
    xy_static: np.ndarray | None = None,
    xy_indices: tuple[int, int] | None = None,
    dtype: Any = None,
    ip_occ: Any = None,
    state_mesh: Any = None,
    lazy: bool = False,
    device: Any = None,
) -> "np.ndarray | DeviceStateBatch":
    """Solves ``dψ/dt = -i H(t) ψ`` over the plan's grid.

    Args:
        psi0: The ``(d**n,)`` complex initial state (host numpy).
        plan: The evolution plan (from :func:`build_plan`). Stage arrays
            must include ``amp`` (n_steps, 3, n_bases, n) complex, the
            detuning integrals ``det_cum`` (interaction picture) or the
            detunings ``det`` (lab frame), and optionally ``int_w``
            (n_steps, 3, 2) interaction interpolation weights.
        static_diag: ``(dim,)`` static interaction diagonal, or ``(2,
            dim)`` [unmasked, masked] when ``int_w`` is present.
        pairs: Static per-basis (i, j, k) drive index triples.
        d, n: Qudit dimension and count.
        xy_static: Optional ``(nxy, N, N)`` XY couplings (1 or 2
            configurations, interpolated with ``int_w`` when 2).
        xy_indices: ``(up_idx, down_idx)`` of the flip-flop term.
        dtype: Complex dtype of the evolution (defaults to psi0's).
        ip_occ: When given (any non-None value) and there is neither an
            XY term nor ``int_w``, the solve runs in the **interaction
            picture**: the full diagonal ``D(t) = int_diag − Σ det·occ``
            is rotated away exactly (``ψ = e^{-iΦ(t)} φ``, ``Φ = ∫D``),
            with the projector occupancies synthesized from the basis
            index. Otherwise the lab-frame loop :func:`_sesolve_scan`
            integrates the whole Hamiltonian.
        state_mesh: A ``torch.distributed`` mesh to shard the state's
            ``2^N`` axis over (:mod:`pulser_tpu_torch.parallel.
            state_sharding`): qubits and qudits (d=3, 4) in the
            interaction picture, and XY mode with one static coupling
            matrix; other configurations solve unsharded.
        lazy: Return a :class:`DeviceStateBatch` (device-resident
            output, fetched on demand) instead of a host array.
        device: The torch device to solve on (default: the first CUDA
            device; without one this raises: pass ``"cpu"`` to run on
            the CPU).

    Returns:
        ``(n_eval, dim)`` complex numpy states at the evaluation
        times, or a :class:`DeviceStateBatch` when ``lazy`` is set.
    """
    has_int_w = "int_w" in plan.stage_arrays
    use_ip = ip_occ is not None and xy_static is None and not has_int_w
    cdtype = _complex_dtype(dtype or np.asarray(psi0).dtype)
    rdtype = np.zeros((), dtype=cdtype).real.dtype
    dev = _resolve_device(device)
    psi0_np = np.asarray(psi0, dtype=cdtype)
    if state_mesh is not None:
        sharded = _sesolve_state_sharded(
            psi0_np, plan, static_diag, pairs, d, n, xy_static, xy_indices,
            use_ip, has_int_w, state_mesh, cdtype, dev,
        )
        if sharded is not None:
            if lazy:
                return DeviceStateBatch(
                    torch.from_numpy(sharded),
                    np.arange(len(sharded)),
                    lambda h: h,
                )
            return sharded
    from pulser_tpu_torch.ops.kernels import ip_sesolve_takes

    # The hand-written kernel covers the flagship configuration
    if use_ip and ip_sesolve_takes(d, pairs, n, rdtype, dev):
        return _sesolve_rk4_kernel(
            psi0_np, plan, static_diag, n, cdtype, dev, lazy=lazy
        )

    pairs = tuple(tuple(p) for p in pairs)
    if use_ip:
        out = _sesolve_scan_ip(
            _stage_host(psi0_np, dev, cdtype),
            *_ip_stage_arrays(plan, rdtype, cdtype, dev),
            _stage_host(np.asarray(static_diag).real, dev, rdtype),
            pairs=pairs,
            d=d,
            n=n,
        )
    else:
        out = _sesolve_scan(
            _stage_host(psi0_np, dev, cdtype),
            _stage_host(plan.seg_stage("amp"), dev, cdtype),
            _stage_host(plan.seg_stage("det").real, dev, rdtype),
            np.asarray(plan.seg_dts, dtype=rdtype),
            _stage_host(np.asarray(static_diag).real, dev, rdtype),
            pairs=pairs,
            d=d,
            n=n,
            int_w=(
                _stage_host(plan.seg_stage("int_w"), dev, rdtype)
                if has_int_w
                else None
            ),
            xy_s=(
                None
                if xy_static is None
                else _stage_host(np.asarray(xy_static).real, dev, rdtype)
            ),
            xy_indices=xy_indices,
        )
    last_solve_info.clear()
    last_solve_info.update(
        kind="sesolve_torch_loop",
        dim=d**n,
        n=n,
        n_steps=int(np.count_nonzero(plan.seg_dts)),
        ip=use_ip,
    )
    if lazy:
        return DeviceStateBatch(
            out, plan.eval_map, lambda h: h.astype(cdtype)
        )
    return out.cpu().numpy()[plan.eval_map].astype(cdtype)


def _ip_stage_arrays(
    plan: EvolutionPlan, rdtype: Any, cdtype: Any, dev: torch.device
) -> tuple:
    """The interaction-picture stage arrays of one plan on ``dev``:
    ``(amp, −∫det mod 2π, t_stage, dts (host), eval_t, −∫det(eval) mod
    2π)``. Phases only matter mod 2π and the occupancies are exactly 0/1,
    so the detuning integrals are range-reduced in float64 on the host
    before the cast (sign: D = int_diag − Σ det·occ, so Φ gets the −∫det
    terms)."""
    two_pi = 2 * np.pi
    return (
        _stage_host(plan.seg_stage("amp"), dev, cdtype),
        _stage_host((-plan.seg_stage("det_cum")) % two_pi, dev, rdtype),
        _stage_host(plan.seg_stage("t_stage"), dev, rdtype),
        np.asarray(plan.seg_dts, dtype=rdtype),
        _stage_host(plan.eval_times - plan.grid[0], dev, rdtype),
        _stage_host((-plan.eval_det_cum) % two_pi, dev, rdtype),
    )


def _sesolve_state_sharded(
    psi0_np: np.ndarray,
    plan: EvolutionPlan,
    static_diag: np.ndarray,
    pairs: tuple,
    d: int,
    n: int,
    xy_static: Any,
    xy_indices: Any,
    use_ip: bool,
    has_int_w: bool,
    state_mesh: Any,
    cdtype: Any,
    dev: torch.device,
) -> "np.ndarray | None":
    """The state-sharded solve of :func:`sesolve_rk4` (the JAX package's
    routing), or None when the configuration solves unsharded."""
    from pulser_tpu_torch.parallel import state_sharding as SS

    route = SS.sharded_route(d, use_ip, xy_static, has_int_w)
    if route == "ip":
        return SS.sesolve_ip_statevector_sharded(
            psi0_np, plan, static_diag, pairs, n, state_mesh, dtype=cdtype,
            device=dev,
        )
    if route == "qudit":
        return SS.qudit_sesolve_ip_statevector_sharded(
            psi0_np, plan, static_diag, pairs, n, state_mesh, d,
            dtype=cdtype, device=dev,
        )
    if route == "xy" and xy_indices is not None:
        return SS.xy_sesolve_statevector_sharded(
            psi0_np, plan, static_diag, np.asarray(xy_static)[0], pairs, n,
            state_mesh, xy_indices, dtype=cdtype, device=dev,
        )
    return None


def _make_ip_phase_fn(
    pairs: tuple[tuple[int, int, int], ...],
    d: int,
    n: int,
    rdtype: torch.dtype,
    device: torch.device,
) -> Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]:
    """Builds the interaction-picture phase evaluator.

    Returns ``phase_at(diag_static, t_s, cum_s) -> (..., dim)`` (for a
    ``(..., dim)`` diagonal and ``(..., n_bases, n)`` integrals, any
    leading batch axes) computing
    ``(diag·t) mod 2π + Σ_bq cum_mod·occ`` with the projector
    occupancies synthesized as axis-wise broadcast adds (one small
    ``(d**g,)`` vector per qubit group) — no ``(n_bases, n, dim)``
    occupancy array ever exists. Qubits are grouped in sixes, as in
    the JAX package, so the sums run in the same order.
    """
    phase_groups: list[int] = []
    rem = n
    while rem > 0:
        phase_groups.append(min(6, rem))
        rem -= phase_groups[-1]
    group_shape = tuple(d**g for g in phase_groups)
    # patterns[b][group j] : (g_j, d**g_j) static 0/1 occupancies
    patterns = []
    for _, _, kp in pairs:
        per_group = []
        for g in phase_groups:
            ar = np.arange(d**g)
            occ = np.stack(
                [(ar // d ** (g - 1 - p)) % d == kp for p in range(g)]
            )
            per_group.append(_stage_host(occ, device, _numpy_dtype(rdtype)))
        patterns.append(per_group)
    k_axes = len(phase_groups)

    def phase_at(
        diag_static: torch.Tensor, t_s: torch.Tensor, cum_s: torch.Tensor
    ) -> torch.Tensor:
        lead = diag_static.shape[:-1]
        shaped = torch.remainder(diag_static * t_s, 2 * math.pi).reshape(
            lead + group_shape
        )
        for b in range(len(pairs)):
            q0 = 0
            for j, g in enumerate(phase_groups):
                vec = cum_s[..., b, q0 : q0 + g] @ patterns[b][j]
                shaped = shaped + vec.reshape(
                    lead + (1,) * j + (d**g,) + (1,) * (k_axes - 1 - j)
                )
                q0 += g
        return shaped.reshape(lead + (-1,))

    return phase_at


#: RK4 tableau: stage-sample index (t, t+h/2, t+h/2, t+h), increment
#: weight and accumulation weight of each of the four stages.
_RK_STAGE = (0, 1, 1, 2)
_RK_A = (0.0, 0.5, 0.5, 1.0)
_RK_B = (1 / 6, 1 / 3, 1 / 3, 1 / 6)


def _sesolve_scan_ip(
    psi0: torch.Tensor,
    amp: torch.Tensor,
    det_cum_mod: torch.Tensor,
    t_stage: torch.Tensor,
    dts: np.ndarray,
    eval_t: torch.Tensor,
    eval_cum_mod: torch.Tensor,
    diag_static: torch.Tensor,
    *,
    pairs: tuple[tuple[int, int, int], ...],
    d: int,
    n: int,
) -> torch.Tensor:
    """Interaction-picture sesolve as a Python loop over segments/steps.

    Integrates ``dφ/dt = -i e^{iΦ} A(t) e^{-iΦ} φ`` with
    ``Φ(t) = t·int_diag − Σ_{b,q} (∫det_bq) occ_bq`` computed exactly
    per stage (:func:`_ip_terms`); only the small amplitude term ``A`` is
    integrated numerically.

    A trajectory batch rides leading axes ``B`` of ``amp``,
    ``det_cum_mod``, ``eval_cum_mod`` and ``diag_static`` (all four, or
    none): the grid and the initial state are shared, and the loop runs
    once over the steps whatever the batch.

    Args:
        psi0: ``(dim,)`` complex initial state.
        amp: ``(B..., n_seg, L, 3, n_bases, n)`` complex drive stages.
        det_cum_mod: ``(B..., n_seg, L, 3, n_bases, n)`` range-reduced
            ``−∫det`` stages.
        t_stage: ``(n_seg, L, 3)`` stage times.
        dts: ``(n_seg, L)`` host step sizes (0 = padding, skipped).
        eval_t: ``(n_seg,)`` evaluation times.
        eval_cum_mod: ``(B..., n_seg, n_bases, n)`` range-reduced
            ``−∫det`` at the evaluation times.
        diag_static: ``(B..., dim)`` static interaction diagonal.
        pairs, d, n: Static structure.

    Returns:
        ``(B..., n_seg, dim)`` lab-frame states after each segment.
    """
    terms = _ip_terms(
        amp, diag_static, det_cum_mod, t_stage, pairs=pairs, d=d, n=n
    )
    phase_at = _make_ip_phase_fn(
        pairs, d, n, diag_static.dtype, psi0.device
    )

    def emit(s: int, phi: torch.Tensor) -> torch.Tensor:
        # The lab frame: ψ = e^{-iΦ(t_eval)} φ
        ph = phase_at(diag_static, eval_t[s], eval_cum_mod[..., s, :, :])
        return torch.complex(torch.cos(ph), -torch.sin(ph)) * phi

    lead = tuple(diag_static.shape[:-1])
    return _scan_segments(
        psi0.expand(lead + tuple(psi0.shape)), dts, *terms, emit
    )


def _rk4_step(
    psi: torch.Tensor, h: float, deriv_at: Callable[[torch.Tensor, int], Any]
) -> torch.Tensor:
    """One classical RK4 step of ``psi`` with ``deriv_at(p, point)``, the
    derivative at stage point 0, 1 or 2 (t, t+h/2, t+h)."""
    k = acc = None
    for j in range(4):
        p = psi if k is None else torch.add(psi, k, alpha=h * _RK_A[j])
        k = deriv_at(p, _RK_STAGE[j])
        acc = _RK_B[j] * k if acc is None else acc.add_(k, alpha=_RK_B[j])
    return torch.add(psi, acc, alpha=h)


def _neg_i_real(x: torch.Tensor) -> torch.Tensor:
    """``−i·x`` of a real tensor, as a complex one."""
    return torch.complex(torch.zeros_like(x), -x)


def _lab_terms(
    amp: torch.Tensor,
    det: torch.Tensor,
    diag_static: torch.Tensor,
    *,
    pairs: tuple[tuple[int, int, int], ...],
    d: int,
    n: int,
    int_w: torch.Tensor | None = None,
    xy_s: torch.Tensor | None = None,
    xy_indices: tuple[int, int] | None = None,
    static_groups: list[torch.Tensor] | None = None,
) -> tuple[Callable, Callable, int]:
    """The lab-frame derivative ``k = −iH(t)ψ`` of the torch loops.

    ``H`` is the drive with its detuning, the interaction diagonal (the
    ``int_w``-weighted sum of its rows with ``int_w``) and the XY term
    (its two configurations interpolated the same way); ``static_groups``
    (one ``(D, D)`` matrix per qudit group, the quantum-jump solve's
    no-jump decay ``−½G``) add to the drive's group matrices.

    Args:
        amp: ``(B..., n_seg, L, 3, n_bases, n)`` complex drive stages.
        det: ``(B..., n_seg, L, 3, n_bases, n)`` real detuning stages.
        diag_static: ``(B..., dim)``, or ``(B..., k, dim)`` with
            ``int_w``.
        pairs, d, n: Static structure.
        int_w: ``(n_seg, L, 3, k)`` interpolation weights.
        xy_s: ``(1 or k, n, n)`` real XY couplings.
        xy_indices: ``(up_idx, down_idx)`` of the flip-flop term.
        static_groups: Extra static group matrices.

    Returns:
        ``(chunk_inputs, deriv, step_bytes)``: ``chunk_inputs(s, sl)``
        stages the steps ``sl`` of segment ``s`` at once (``−i·`` the
        group matrices, the diagonal factor and ``−iU``); ``deriv(p,
        inputs, i, j)`` is the derivative at point ``j`` of step ``i`` of
        that chunk; ``step_bytes`` what one step of a chunk holds.
    """
    groups = group_sizes(d, n)
    offsets = [sum(groups[:i]) for i in range(len(groups))]
    lead = tuple(amp.shape[:-5])
    dim = d**n
    interp_xy = xy_s is not None and int_w is not None and xy_s.shape[0] > 1
    fac_static = None if int_w is not None else _neg_i_real(diag_static)
    u_static = (
        _neg_i_real(xy_s[0]) if xy_s is not None and not interp_xy else None
    )

    def chunk_inputs(s: int, sl: slice) -> tuple:
        mats = build_drive_matrices(
            amp[..., s, sl, :, :, :], det[..., s, sl, :, :, :], pairs, d, n
        )
        gm = []
        for k, (q0, g) in enumerate(zip(offsets, groups)):
            m = -1j * _group_matrix(mats, q0, q0 + g, d)
            gm.append(m if static_groups is None else m + static_groups[k])
        fac, ux = fac_static, u_static
        if int_w is not None:
            w = int_w[s, sl]  # (c, 3, k)
            fac = _neg_i_real(torch.einsum("slk,...kd->...sld", w, diag_static))
            if interp_xy:
                ux = _neg_i_real(torch.einsum("slk,kij->slij", w, xy_s))
        return gm, fac, ux

    def deriv(p: torch.Tensor, inputs: tuple, i: int, j: int) -> torch.Tensor:
        gm, fac, ux = inputs
        out = (fac if fac is fac_static else fac[..., i, j, :]) * p
        for q0, g, m in zip(offsets, groups, gm):
            out = out + apply_block_c(
                m[..., i, j, :, :], p, d**q0, d**g, d ** (n - q0 - g)
            )
        if ux is not None:
            u = ux if ux is u_static else ux[i, j]
            out = out + apply_flip_flop_r(u, p, d, n, *xy_indices)
        return out

    per_step = 3 * sum((d**g) ** 2 for g in groups)
    if int_w is not None:
        per_step += 3 * dim
    per_step *= int(np.prod(lead)) if lead else 1
    return chunk_inputs, deriv, per_step * 2 * amp.real.element_size()


def _ip_terms(
    amp: torch.Tensor,
    diag_static: torch.Tensor,
    cum_mod: torch.Tensor,
    t_stage: torch.Tensor,
    *,
    pairs: tuple[tuple[int, int, int], ...],
    d: int,
    n: int,
    decay: torch.Tensor | None = None,
) -> tuple[Callable, Callable, int]:
    """The interaction-picture derivative of the torch loops,
    ``k = −i e^{iΦ} A(t) (e^{−iΦ} φ) + decay ⊙ φ``: the drive ``A`` without
    its detuning, which lives in the exact phase integrals of ``Φ``
    (:func:`_make_ip_phase_fn`), and an optional diagonal ``decay`` (the
    quantum-jump solve's ``−½ diag(G)``).

    Args:
        amp: ``(B..., n_seg, L, 3, n_bases, n)`` complex drive stages.
        diag_static: ``(B..., dim)`` real interaction diagonal.
        cum_mod: ``(B..., n_seg, L, 3, n_bases, n)`` range-reduced
            ``−∫det`` stages.
        t_stage: ``(n_seg, L, 3)`` stage times.
        pairs, d, n: Static structure.
        decay: ``(dim,)`` complex diagonal term.

    Returns:
        ``(chunk_inputs, deriv, step_bytes)`` as :func:`_lab_terms`;
        ``chunk_inputs(s, sl)`` gives ``(group matrices, rotors)``, the
        rotors ``e^{−iΦ}`` of the chunk's stage points ``(B..., c, 3,
        dim)``.
    """
    groups = group_sizes(d, n)
    offsets = [sum(groups[:i]) for i in range(len(groups))]
    lead = tuple(diag_static.shape[:-1])
    dim = d**n
    phase_at = _make_ip_phase_fn(
        pairs, d, n, diag_static.dtype, diag_static.device
    )

    def chunk_inputs(s: int, sl: slice) -> tuple:
        a = amp[..., s, sl, :, :, :]
        mats = build_drive_matrices(a, torch.zeros_like(a.real), pairs, d, n)
        gm = [
            -1j * _group_matrix(mats, q0, q0 + g, d)
            for q0, g in zip(offsets, groups)
        ]
        ph = phase_at(
            diag_static[..., None, None, :].expand(
                lead + (sl.stop - sl.start, 3, dim)
            ),
            t_stage[s, sl, :, None],
            cum_mod[..., s, sl, :, :, :],
        )
        return gm, torch.complex(torch.cos(ph), -torch.sin(ph))

    def deriv(p: torch.Tensor, inputs: tuple, i: int, j: int) -> torch.Tensor:
        gm, rot = inputs
        r = rot[..., i, j, :]
        w = r * p  # e^{-iΦ} ⊙ φ
        y = None
        for q0, g, m in zip(offsets, groups, gm):
            t = apply_block_c(
                m[..., i, j, :, :], w, d**q0, d**g, d ** (n - q0 - g)
            )
            y = t if y is None else y + t
        k = r.conj() * y  # e^{iΦ} ⊙ (−i A w)
        return k if decay is None else torch.addcmul(k, decay, p)

    per_step = 3 * (sum((d**g) ** 2 for g in groups) + 2 * dim)
    per_step *= int(np.prod(lead)) if lead else 1
    return chunk_inputs, deriv, per_step * 2 * amp.real.element_size()


def _step_chunk(seg_len: int, step_bytes: int) -> int:
    """Steps of a segment staged at once within
    :data:`~pulser_tpu_torch.parallel.capacity.STAGE_CHUNK_BYTES`."""
    return max(1, min(seg_len, STAGE_CHUNK_BYTES // max(1, step_bytes)))


def _scan_segments(
    psi: torch.Tensor,
    dts: np.ndarray,
    chunk_inputs: Callable,
    deriv: Callable,
    step_bytes: int,
    emit: Callable[[int, torch.Tensor], torch.Tensor],
    after_step: Callable | None = None,
) -> torch.Tensor:
    """The RK4 loop of the torch solves over the plan's segments.

    The steps of a segment are staged a chunk at once
    (``chunk_inputs(s, sl)``, within ``STAGE_CHUNK_BYTES`` by
    ``step_bytes``); each nonzero step is one :func:`_rk4_step` with
    ``deriv(p, inputs, i, point)``, followed by ``after_step(psi, inputs,
    s, step, i)`` where given (the quantum jumps); zero steps are the start
    padding of a short segment. ``emit(s, psi)`` is segment ``s``'s output.

    Returns:
        The outputs stacked on axis -2: ``(B..., n_seg, dim)``.
    """
    n_seg, seg_len = dts.shape
    chunk = _step_chunk(seg_len, step_bytes)
    outs = []
    for s in range(n_seg):
        for c0 in range(0, seg_len, chunk):
            sl = slice(c0, min(seg_len, c0 + chunk))
            if not np.any(dts[s, sl]):
                continue
            inputs = chunk_inputs(s, sl)
            for i in range(sl.stop - sl.start):
                h = float(dts[s, sl.start + i])
                if h == 0.0:
                    continue
                psi = _rk4_step(psi, h, lambda p, j: deriv(p, inputs, i, j))
                if after_step is not None:
                    psi = after_step(psi, inputs, s, sl.start + i, i)
        outs.append(emit(s, psi))
    return torch.stack(outs, dim=-2)


def _sesolve_scan(
    psi0: torch.Tensor,
    amp: torch.Tensor,
    det: torch.Tensor,
    dts: np.ndarray,
    diag_static: torch.Tensor,
    *,
    pairs: tuple[tuple[int, int, int], ...],
    d: int,
    n: int,
    int_w: torch.Tensor | None = None,
    xy_s: torch.Tensor | None = None,
    xy_indices: tuple[int, int] | None = None,
) -> torch.Tensor:
    """The lab-frame sesolve as a torch loop over segments and steps.

    Integrates ``dψ/dt = −iH(t)ψ`` with the whole Hamiltonian
    (:func:`_lab_terms`: the drive with its detuning, the interaction
    diagonal, the XY flip-flop term; with ``int_w`` the diagonal and the
    couplings interpolated per RK4 stage); the per-step inputs are staged
    for a chunk of steps at once.

    Args:
        psi0: ``(dim,)`` complex initial state.
        amp, det: ``(n_seg, L, 3, n_bases, n)`` drive and detuning
            stages.
        dts: ``(n_seg, L)`` host step sizes (0 = padding, skipped).
        diag_static: ``(dim,)``, or ``(k, dim)`` with ``int_w``.
        pairs, d, n: Static structure.
        int_w: ``(n_seg, L, 3, k)`` interpolation weights.
        xy_s: ``(1 or k, n, n)`` real XY couplings.
        xy_indices: ``(up_idx, down_idx)`` of the flip-flop term.

    Returns:
        ``(n_seg, dim)`` states after each segment.
    """
    terms = _lab_terms(
        amp, det, diag_static, pairs=pairs, d=d, n=n, int_w=int_w,
        xy_s=xy_s, xy_indices=xy_indices,
    )
    return _scan_segments(psi0, dts, *terms, lambda s, psi: psi)


def ip_kernel_inputs(
    psi0_np: np.ndarray,
    plan: EvolutionPlan,
    static_diag: np.ndarray,
    n: int,
    device: Any,
) -> tuple[list[torch.Tensor], dict[str, Any]]:
    """The arguments of :func:`~pulser_tpu_torch.ops.kernels.ip_sesolve`
    for one solve: ``(tensors, keyword arguments)``.

    The host-side preparation mirrors :func:`sesolve_rk4`'s
    interaction-picture path, in the input layout of the JAX package's
    ``_ip_sesolve_jit`` (float32, qubits split over rows and columns).
    The plan-derived tensors are staged on the device once per plan.
    """
    dev = torch.device(device)
    n_col = 8 if n >= 15 else 7  # the JAX package's (rows, cols) split
    n_row = n - n_col
    rows, cols = 1 << n_row, 1 << n_col
    two_pi = 2 * np.pi
    n_seg, seg_len = plan.seg_dts.shape
    f32 = np.float32
    key = ("ip_kernel_inputs", str(dev))
    staged = plan.runtime_cache.get(key)
    if staged is None:
        a = plan.seg_stage("amp")[..., 0, :]  # single basis: (S,L,3,n)
        cum = (-plan.seg_stage("det_cum")[..., 0, :]) % two_pi
        eval_t = plan.eval_times - plan.grid[0]
        eval_cum = (-plan.eval_det_cum[:, 0, :]) % two_pi
        seg_dts = np.asarray(plan.seg_dts, f32).reshape(n_seg, seg_len, 1)
        staged = (
            [
                _stage_host(x, dev, f32)
                for x in (
                    a.real,
                    a.imag,
                    cum,
                    plan.seg_stage("t_stage"),
                    seg_dts,
                    np.reshape(eval_t, (n_seg, 1, 1)),
                    np.reshape(eval_cum, (n_seg, 1, n)),
                )
            ],
            seg_dts,
        )
        plan.runtime_cache[key] = staged
    tensors, seg_dts_host = staged
    per_run = [
        _stage_host(x, dev, f32)
        for x in (
            np.asarray(static_diag).real.reshape(1, rows, cols),
            psi0_np.real.reshape(rows, cols),
            psi0_np.imag.reshape(rows, cols),
        )
    ]
    kwargs = dict(
        n_row=n_row, n_col=n_col, seg_len=seg_len, seg_dts_host=seg_dts_host
    )
    return tensors + per_run, kwargs


def _sesolve_rk4_kernel(
    psi0_np: np.ndarray,
    plan: EvolutionPlan,
    static_diag: np.ndarray,
    n: int,
    cdtype: Any,
    device: Any,
    lazy: bool = False,
) -> "np.ndarray | DeviceStateBatch":
    """Dispatches the hand-written interaction-picture sesolve kernel.

    On a CPU device the kernel's plain PyTorch version runs instead.
    """
    from pulser_tpu_torch.ops.kernels import ip_sesolve

    dev = torch.device(device)
    args, kwargs = ip_kernel_inputs(psi0_np, plan, static_diag, n, dev)
    out = ip_sesolve(*args, **kwargs)
    last_solve_info.clear()
    last_solve_info.update(
        kind="ip_sesolve_cuda" if dev.type == "cuda" else "ip_sesolve_plain",
        rows=1 << kwargs["n_row"],
        cols=1 << kwargs["n_col"],
        n_steps=int(np.count_nonzero(plan.seg_dts)),
        n=n,
    )

    def to_complex(h: np.ndarray) -> np.ndarray:
        return (h[0].ravel() + 1j * h[1].ravel()).astype(cdtype)

    def to_complex_dev(h: torch.Tensor) -> torch.Tensor:
        return torch.complex(h[0].reshape(-1), h[1].reshape(-1))

    if lazy:
        return DeviceStateBatch(out, plan.eval_map, to_complex, to_complex_dev=to_complex_dev)
    out_np = out.cpu().numpy()[plan.eval_map]
    return np.stack([to_complex(h) for h in out_np])


# -- Batched plans and the row-batched quantum-jump solve -----------------


class RankFactors:
    """Rank-``R`` factorization of a trajectory coefficient batch.

    ``batch[b] = Σ_r coeffs[b, r] · profiles[r]`` with ``profiles`` of
    shape ``(R, nb, n, K)`` and ``coeffs`` of shape ``(B, R, nb, n)``.
    Noise perturbations are linear combinations of a few shared time
    profiles (the noiseless drive, the doppler slot mask), so staging
    gathers run on the ``R·nb·n`` profile rows instead of the ``B·nb·n``
    batch rows.
    """

    def __init__(self, profiles: Any, coeffs: Any) -> None:
        self.profiles = profiles
        self.coeffs = coeffs


@dataclasses.dataclass
class BatchedPlan:
    """One plan for a whole trajectory batch.

    Every noise trajectory shares the integration grid (only coefficient
    *values* differ), so the grid and its segmentation are built once.
    """

    plan: EvolutionPlan
    n_traj: int
    #: The raw ``(B, ..., n_knots)`` coefficient batch (or
    #: :class:`RankFactors`), staged on the device by the solvers.
    raw_coeffs: dict[str, Any] | None = None

    def seg_stage_b(self, name: str) -> np.ndarray:
        """``(B, n_seg, L, 3, ...)`` staged values for ``name``."""
        # In the underlying plan the batch rides at axis 3
        return np.moveaxis(self.plan.seg_stage(name), 3, 0)

    def seg_knots(self) -> tuple[np.ndarray, ...]:
        """``(idx0, idx1, frac)`` in the (n_seg, L, 3) layout."""
        assert self.plan.stage_knots is not None
        return tuple(a[self.plan.seg_map] for a in self.plan.stage_knots)

    @property
    def eval_det_cum_b(self) -> np.ndarray:
        """``(B, n_eval, n_bases, n)`` detuning integrals."""
        assert self.plan.eval_det_cum is not None
        return np.moveaxis(self.plan.eval_det_cum, 1, 0)


def build_plan_batched(
    knots: np.ndarray,
    coeffs_batch: dict[str, Any],
    eval_times: np.ndarray,
    max_step: float | None = None,
    host_stage: bool = True,
    coarsen: bool = False,
    breakpoints: "np.ndarray | None" = None,
) -> BatchedPlan:
    """Builds one :class:`BatchedPlan` for stacked coefficients.

    Args:
        knots: Shared ``(n_knots,)`` coefficient sample times.
        coeffs_batch: Name -> ``(B, ..., n_knots)`` stacked
            per-trajectory coefficients, or :class:`RankFactors`.
        eval_times: Shared evaluation times.
        max_step, host_stage, coarsen, breakpoints: See
            :func:`build_plan`.
    """
    lead = next(iter(coeffs_batch.values()))
    n_traj = (
        lead.coeffs.shape[0]
        if isinstance(lead, RankFactors)
        else lead.shape[0]
    )
    plan = build_plan(
        knots,
        coeffs_batch,
        eval_times,
        max_step=max_step,
        host_stage=host_stage,
        coarsen=coarsen,
        breakpoints=breakpoints,
    )
    return BatchedPlan(plan=plan, n_traj=n_traj, raw_coeffs=dict(coeffs_batch))


def _raw_drive_leaves(plans: BatchedPlan, rdtype: Any) -> tuple:
    """Stageable ``(amp_re, amp_im, det)`` leaves from raw coefficients:
    :class:`RankFactors` split into real/imaginary factor pairs, plain
    arrays into their real and imaginary parts."""
    np_r = np.dtype(rdtype)
    raw_amp = plans.raw_coeffs["amp"]
    if isinstance(raw_amp, RankFactors):
        prof = np.asarray(raw_amp.profiles)
        coeffs = np.asarray(raw_amp.coeffs, np_r)
        amp_re = RankFactors(prof.real.astype(np_r), coeffs)
        amp_im = RankFactors(prof.imag.astype(np_r), coeffs)
    else:
        arr = np.asarray(raw_amp)
        amp_re = arr.real.astype(np_r)
        amp_im = arr.imag.astype(np_r)
    det = _det_rank_leaf(plans, plans.raw_coeffs["det"], np_r)
    return amp_re, amp_im, det


def _det_rank_leaf(plans: BatchedPlan, raw_det: Any, np_r: Any) -> Any:
    """The detuning leaf for :func:`_stage_cum_on_device`: the real part
    of a :class:`RankFactors` batch or of a plain array."""
    if isinstance(raw_det, RankFactors):
        return RankFactors(
            np.asarray(raw_det.profiles).real.astype(np_r),
            np.asarray(raw_det.coeffs, np_r),
        )
    return np.asarray(raw_det).real.astype(np_r)


def _raw_cum_inputs(plans: BatchedPlan, rdtype: Any) -> tuple[Any, ...]:
    """Host-side prep for :func:`_stage_cum_on_device`.

    Only small index/fraction arrays are computed here (the raw knot
    values and a handful of per-eval-time scalars); everything
    proportional to the step count is staged on the device.
    """
    plan = plans.plan
    knots = np.asarray(plan.knots)
    seg_w = np.diff(knots)
    idx0, idx1, frac = plans.seg_knots()  # (n_seg, L, 3)
    dt_in = frac * seg_w[idx0]
    # Eval-time segment lookup, matching _integ_at's clip semantics
    times = np.asarray(plan.eval_times)
    eidx = np.clip(
        np.searchsorted(knots, times, side="right") - 1, 0, len(knots) - 2
    )
    ev_dt = np.clip(times - knots[eidx], 0.0, None)
    ev_dt_in = np.minimum(ev_dt, seg_w[eidx])
    ev_frac = ev_dt_in / seg_w[eidx]
    ev_dt_out = np.clip(ev_dt - seg_w[eidx], 0.0, None)
    np_r = np.dtype(rdtype)
    return (
        _det_rank_leaf(plans, plans.raw_coeffs["det"], np_r),
        np.asarray(seg_w, dtype=np_r),
        np.asarray(idx0),
        np.asarray(idx1),
        np.asarray(dt_in, dtype=np_r),
        np.asarray(frac, dtype=np_r),
        np.asarray(eidx),
        np.asarray(ev_dt_in, dtype=np_r),
        np.asarray(ev_frac, dtype=np_r),
        np.asarray(ev_dt_out, dtype=np_r),
    )


def _on_device(x: Any, device: Any, dtype: torch.dtype | None = None) -> Any:
    """A numpy leaf (or the leaves of a :class:`RankFactors`) as tensors
    on ``device``; integer arrays become int64 indices."""
    if isinstance(x, RankFactors):
        return RankFactors(
            _on_device(x.profiles, device, dtype),
            _on_device(x.coeffs, device, dtype),
        )
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype or x.dtype)
    arr = np.asarray(x)
    if np.issubdtype(arr.dtype, np.integer):
        return _stage_host(arr, device, np.int64)
    t = _stage_host(arr, device)
    return t if dtype is None else t.to(dtype)


def _stage_cum_on_device(
    raw_det: Any,
    seg_w: torch.Tensor,
    idx0: torch.Tensor,
    idx1: torch.Tensor,
    dt_in: torch.Tensor,
    frac: torch.Tensor,
    eidx: torch.Tensor,
    ev_dt_in: torch.Tensor,
    ev_frac: torch.Tensor,
    ev_dt_out: torch.Tensor,
    acc_dtype: torch.dtype = torch.float64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact detuning phase integrals, staged on the inputs' device.

    ``∫₀ᵗ det`` for piecewise-linear ``det`` is a knot-cumsum plus a
    local quadratic correction; per stage time ``t`` in knot segment
    ``idx0``: ``I = cum[idx0] + dt_in·(c0 + ½·frac·(c1 − c0))``. The
    eval-time integrals ride the same cumsum (``eidx``/``ev_*`` as in
    ``_integ_at``, with constant extrapolation past the last knot).

    The integrals, their per-trajectory combination and the reduction
    mod 2π run in ``acc_dtype`` (float64 by default: a float32 cumsum
    over thousands of knots accumulates phase error, and its rounding
    depends on the device's summation order) and are cast to the
    inputs' dtype at the end.

    Args:
        raw_det: ``(B, nb, n, K)`` real detunings or a
            :class:`RankFactors` of them (the profile rows are
            integrated once, then combined per trajectory).
        seg_w .. ev_dt_out: The device tensors of
            :func:`_raw_cum_inputs`.
        acc_dtype: Working precision.

    Returns:
        ``(B, n_seg, L, 3, nb, n)`` stage integrals and ``(B, m, nb,
        n)`` eval-time integrals, pre-negated mod 2π.
    """
    out_dtype = seg_w.dtype
    two_pi = 2 * math.pi

    def c(x: torch.Tensor) -> torch.Tensor:
        return x.to(acc_dtype)

    def integrals(det: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Raw (un-negated) stage and eval integrals of ``det``."""
        det = c(det)
        inc = 0.5 * (det[..., 1:] + det[..., :-1]) * c(seg_w)
        cum = torch.cat(
            [torch.zeros_like(det[..., :1]), torch.cumsum(inc, dim=-1)], -1
        )
        c0 = det[..., idx0]  # (..., n_seg, L, 3)
        c1 = det[..., idx1]
        i_val = cum[..., idx0] + c(dt_in) * (c0 + 0.5 * c(frac) * (c1 - c0))
        c0e = det[..., eidx]  # (..., m)
        c1e = det[..., eidx + 1]
        ev = (
            cum[..., eidx]
            + c(ev_dt_in) * (c0e + 0.5 * c(ev_frac) * (c1e - c0e))
            + c1e * c(ev_dt_out)
        )
        return i_val, ev

    if isinstance(raw_det, RankFactors):
        i_prof, ev_prof = integrals(raw_det.profiles)
        coeffs = c(raw_det.coeffs)  # (B, R, nb, n)
        i_val = torch.einsum("trjq,rjqslk->tjqslk", coeffs, i_prof)
        ev = torch.einsum("trjq,rjqm->tjqm", coeffs, ev_prof)
    else:
        i_val, ev = integrals(raw_det)
    out = torch.remainder(-i_val, two_pi).to(out_dtype)
    ev_out = torch.movedim(torch.remainder(-ev, two_pi), -1, 1).to(out_dtype)
    return torch.movedim(out, (-3, -2, -1), (1, 2, 3)).contiguous(), (
        ev_out.contiguous()
    )


def _stage_on_device(
    raw: Any,
    idx0: torch.Tensor,
    idx1: torch.Tensor,
    frac: torch.Tensor,
) -> torch.Tensor:
    """Stages raw ``(B, ..., K)`` coefficients on their device.

    Returns the ``(B, n_seg, L, 3, ...)`` RK4 stage values via two knot
    gathers and a lerp. A :class:`RankFactors` stages its shared profile
    rows and expands per trajectory after the gather, so the gather
    cost never scales with the batch.
    """
    if isinstance(raw, RankFactors):
        g0 = raw.profiles[..., idx0]  # (R, ..., n_seg, L, 3)
        g1 = raw.profiles[..., idx1]
        st = torch.einsum(
            "trjq,rjqslk->tjqslk", raw.coeffs, g0 * (1 - frac) + g1 * frac
        )
    else:
        g0 = raw[..., idx0]  # (B, ..., n_seg, L, 3)
        g1 = raw[..., idx1]
        st = g0 * (1 - frac) + g1 * frac
    return torch.movedim(st, (-3, -2, -1), (1, 2, 3)).contiguous()


def _batched_inputs(
    plans: "list[EvolutionPlan] | BatchedPlan", names: tuple[str, ...]
) -> tuple[EvolutionPlan, int, dict[str, np.ndarray]]:
    """``(base plan, B, host-staged dict)`` of a batched plan or of a
    list of per-trajectory plans on one grid, the staged arrays in the
    ``(B, n_seg, L, 3, ...)`` layout. (Of the port's solves only
    :func:`sesolve_rk4_batched` takes a list.)"""
    if isinstance(plans, BatchedPlan):
        return (
            plans.plan,
            plans.n_traj,
            {name: plans.seg_stage_b(name) for name in names},
        )
    return (
        plans[0],
        len(plans),
        {name: np.stack([p.seg_stage(name) for p in plans]) for name in names},
    )


def _batched_k1_takes(
    plans: Any, mesh: Any, d: int, pairs: tuple, n: int, rdtype: Any,
    dev: torch.device,
) -> bool:
    """:func:`sesolve_rk4_batched`'s gate: K1's own
    (:func:`~pulser_tpu_torch.ops.kernels.ip_sesolve_takes`), for a
    :class:`BatchedPlan` on one rank (a mesh of several ranks never takes
    the kernel). On a card it alone decides."""
    from pulser_tpu_torch.ops.kernels import ip_sesolve_takes

    return (
        isinstance(plans, BatchedPlan)
        and _mesh_size(mesh) == 1
        and ip_sesolve_takes(d, pairs, n, rdtype, dev)
    )


def sesolve_rk4_batched(
    psi0: np.ndarray,
    plans: "list[EvolutionPlan] | BatchedPlan",
    static_diags: np.ndarray,
    pairs: tuple[tuple[int, int, int], ...],
    d: int,
    n: int,
    ip_occ: Any,
    dtype: Any = None,
    mesh: Any = None,
    device: Any = None,
    lazy: bool = False,
) -> "np.ndarray | BatchedKets":
    """Batched interaction-picture sesolve over noise trajectories.

    Every trajectory's host-staged stage coefficients ride a leading
    batch axis and the whole batch integrates at once: through the
    trajectory-batched mode of the hand-written kernel
    (:func:`~pulser_tpu_torch.ops.kernels.ip_sesolve` with
    ``segs_per_traj``) for a :class:`BatchedPlan` of qubits (d=2) with one
    ground-rydberg drive basis, 10 ≤ n ≤ 17, in single precision on a
    CUDA device; through the torch loop :func:`_sesolve_scan_ip` with a
    batch axis otherwise (any d and n, either precision, the CPU).

    Args:
        psi0: ``(dim,)`` shared complex initial state.
        plans: A :class:`BatchedPlan`, or one :func:`build_plan` result
            per trajectory; all share the grid and segment structure
            (noise trajectories only perturb coefficient values). The
            plans are host-staged (``host_stage=True``).
        static_diags: ``(T, dim)`` per-trajectory interaction diagonals.
        pairs, d, n: Static Hamiltonian structure.
        ip_occ: Kept for the JAX package's signature: the solve always
            runs in the interaction picture, the occupancies synthesized
            from the basis index.
        dtype: Complex dtype of the evolution (defaults to psi0's).
        mesh: A ``torch.distributed`` mesh to split the trajectories
            over (:func:`~pulser_tpu_torch.parallel.trajectories.
            sesolve_ip_states_sharded`; padded to a multiple of its
            ranks): each rank runs the torch loop on its block, never the
            kernel.
        device: The torch device to solve on (default: the first CUDA
            device; without one this raises: pass ``"cpu"`` to run on
            the CPU).
        lazy: On the kernel's route, return its output where it lies, a
            :class:`BatchedKets`, in place of the fetched states (the
            other routes return the states).

    Returns:
        ``(T, n_eval, dim)`` complex states at the evaluation times, or,
        when ``lazy`` and the batch takes the kernel, a
        :class:`BatchedKets`.
    """
    cdtype = _complex_dtype(dtype or np.asarray(psi0).dtype)
    rdtype = np.zeros((), dtype=cdtype).real.dtype
    dev = _resolve_device(device)
    psi0_np = np.asarray(psi0, dtype=cdtype)
    pairs = tuple(tuple(p) for p in pairs)
    if _batched_k1_takes(plans, mesh, d, pairs, n, rdtype, dev):
        return _sesolve_batched_kernel(
            psi0_np, plans, static_diags, n, cdtype, dev, lazy=lazy
        )

    # Phases reduced mod 2π in float64 on the host, before the cast
    two_pi = 2 * np.pi
    base, n_traj, staged = _batched_inputs(plans, ("amp", "det_cum"))
    if isinstance(plans, BatchedPlan):
        eval_cum = plans.eval_det_cum_b
    else:
        eval_cum = np.stack([p.eval_det_cum for p in plans])
    per_traj = (
        staged["amp"],
        (-staged["det_cum"]) % two_pi,
        (-eval_cum) % two_pi,
        np.asarray(static_diags).real,
    )
    sharded = mesh is not None and n_traj > 1
    if sharded:
        from pulser_tpu_torch.parallel.trajectories import pad_to_multiple

        per_traj, _ = pad_to_multiple(per_traj, _mesh_size(mesh))
    amp, cum, ev_cum, diags = (
        _stage_host(x, dev, dt)
        for x, dt in zip(per_traj, (cdtype, rdtype, rdtype, rdtype))
    )
    shared = (
        _stage_host(base.seg_stage("t_stage"), dev, rdtype),
        np.asarray(base.seg_dts, dtype=rdtype),
        _stage_host(base.eval_times - base.grid[0], dev, rdtype),
    )
    if sharded:
        from pulser_tpu_torch.parallel.trajectories import (
            sesolve_ip_states_sharded,
        )

        out = sesolve_ip_states_sharded(
            mesh, _stage_host(psi0_np, dev, cdtype), amp, cum, *shared,
            ev_cum, diags,
            pairs=pairs, d=d, n=n,
        )
    else:
        out = _sesolve_scan_ip(
            _stage_host(psi0_np, dev, cdtype), amp, cum, *shared, ev_cum,
            diags,
            pairs=pairs, d=d, n=n,
        )
    last_solve_info.clear()
    last_solve_info.update(
        kind="sesolve_batched_torch",
        dim=d**n,
        n=n,
        n_traj=n_traj,
        n_steps=int(np.count_nonzero(base.seg_dts)),
        ranks=_mesh_size(mesh) if sharded else 1,
    )
    # (T, n_seg, dim) -> the requested evaluation times, one transfer
    # (padded trajectories, if any, are sliced off)
    return _fetch_states(out)[:n_traj, base.eval_map].astype(cdtype)


def _fetch_states(out: torch.Tensor) -> np.ndarray:
    """A batched solve's whole output in host memory: one read that
    waits for the card, counted with the bytes it brings back.

    From a card the copy lands in page-locked memory from PyTorch's
    caching host allocator, so a run after the first reuses its buffer
    and copies at the link's speed; the buffer returns to the cache when
    the array is freed.
    """
    profiling.count("sync.solver.fetch")
    profiling.count("traj.fetched_bytes", out.numel() * out.element_size())
    if out.device.type != "cuda":
        return out.cpu().numpy()
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    torch.cuda.current_stream(out.device).synchronize()
    return host.numpy()


def ip_batched_kernel_inputs(
    psi0_np: np.ndarray,
    plans: BatchedPlan,
    static_diags: np.ndarray,
    n: int,
    device: Any,
) -> tuple[list[torch.Tensor], dict[str, Any]]:
    """The arguments of :func:`~pulser_tpu_torch.ops.kernels.ip_sesolve`
    for one trajectory batch: ``(tensors, keyword arguments)``.

    The layout of the JAX package's ``_ip_sesolve_jit`` with
    ``segs_per_traj``: (trajectory, segment) flattened trajectory-major
    on the leading axis, the shared grid tiled per trajectory, float32,
    qubits split over rows and columns. Drives and phase integrals come
    from the plan's host-staged float64 arrays, reduced mod 2π before
    the cast.
    """
    dev = torch.device(device)
    n_col = 8 if n >= 15 else 7  # the JAX package's (rows, cols) split
    n_row = n - n_col
    rows, cols = 1 << n_row, 1 << n_col
    two_pi = 2 * np.pi
    n_traj = plans.n_traj
    base = plans.plan
    spt, seg_len = base.seg_dts.shape
    n_flat = n_traj * spt
    f32 = np.float32

    def tiled(x: np.ndarray, shape: tuple) -> np.ndarray:
        return np.tile(np.asarray(x, f32).reshape(shape), (n_traj, 1, 1))

    # (B, S, L, 3, n) -> (B*S, L, 3, n), single drive basis
    stage = (n_flat, seg_len, 3, n)
    a = plans.seg_stage_b("amp")[..., 0, :].reshape(stage)
    cum = (-plans.seg_stage_b("det_cum")[..., 0, :]) % two_pi
    eval_cum = (-plans.eval_det_cum_b[:, :, 0, :]) % two_pi
    seg_dts = tiled(base.seg_dts, (spt, seg_len, 1))
    tensors = [
        _stage_host(x, dev, f32)
        for x in (
            a.real,
            a.imag,
            cum.reshape(stage),
            tiled(base.seg_stage("t_stage"), (spt, seg_len, 3)),
            seg_dts,
            tiled(base.eval_times - base.grid[0], (spt, 1, 1)),
            eval_cum.reshape(n_flat, 1, n),
            np.asarray(static_diags).real.reshape(n_traj, rows, cols),
            psi0_np.real.reshape(rows, cols),
            psi0_np.imag.reshape(rows, cols),
        )
    ]
    kwargs = dict(
        n_row=n_row,
        n_col=n_col,
        seg_len=seg_len,
        segs_per_traj=spt,
        seg_dts_host=seg_dts,
    )
    return tensors, kwargs


def _sesolve_batched_kernel(
    psi0_np: np.ndarray,
    plans: BatchedPlan,
    static_diags: np.ndarray,
    n: int,
    cdtype: Any,
    device: Any,
    lazy: bool = False,
) -> "np.ndarray | BatchedKets":
    """Dispatches the trajectory-batched mode of the hand-written
    interaction-picture sesolve kernel: one device launch for the whole
    batch, the states fetched once, or, when ``lazy``, left where they
    lie as a :class:`BatchedKets`.

    On a CPU device the kernel's plain PyTorch version runs instead.
    """
    from pulser_tpu_torch.ops.kernels import ip_sesolve

    dev = torch.device(device)
    base = plans.plan
    args, kwargs = ip_batched_kernel_inputs(
        psi0_np, plans, static_diags, n, dev
    )
    out = ip_sesolve(*args, **kwargs)
    last_solve_info.clear()
    last_solve_info.update(
        kind=(
            "ip_sesolve_batched_cuda"
            if dev.type == "cuda"
            else "ip_sesolve_batched_plain"
        ),
        rows=1 << kwargs["n_row"],
        cols=1 << kwargs["n_col"],
        n=n,
        n_traj=plans.n_traj,
        n_steps=int(np.count_nonzero(base.seg_dts)),
    )
    kets = BatchedKets(
        out.reshape(plans.n_traj, kwargs["segs_per_traj"], 2, -1),
        np.asarray(base.eval_map, dtype=np.int64),
    )
    return kets if lazy else kets.fetch().astype(cdtype, copy=False)


@dataclasses.dataclass
class BatchedKets:
    """A trajectory batch's kets as the batched kernel left them.

    Attributes:
        planes: ``(T, S, 2, dim)`` float32 real and imaginary planes of
            each trajectory's state after each of the plan's S segments,
            on the solve's device.
        eval_map: ``(n_eval,)`` segment of each evaluation time.
    """

    planes: torch.Tensor
    eval_map: np.ndarray

    def fetch(self) -> np.ndarray:
        """The ``(T, n_eval, dim)`` complex64 states in host memory:
        gathered at the evaluation times and assembled into complex
        states on the device, then copied once (:func:`_fetch_states`)."""
        planes = self.planes
        if not np.array_equal(self.eval_map, np.arange(planes.shape[1])):
            planes = planes[:, _stage_host(self.eval_map, planes.device)]
        return _fetch_states(torch.complex(planes[:, :, 0], planes[:, :, 1]))

    def draw(
        self,
        time_index: list[int],
        offs: np.ndarray,
        rnd: np.ndarray,
        *,
        renormalize: bool,
        reverse: bool,
    ) -> np.ndarray:
        """Outcome indices of the uniforms ``rnd`` drawn on the kets'
        device (:func:`~pulser_tpu_torch.ops.kernels.sample_states`):
        entry ``e = t·n_times + i`` (trajectory-major) reads trajectory
        ``t`` at evaluation index ``time_index[i]`` and draws
        ``rnd[offs[e]:offs[e + 1]]``. The segment map, the offsets and the
        uniforms cross to the device in one copy, the indices come back
        in one: only they, of the states, reach the host.

        Returns:
            ``(offs[-1],)`` int64 outcome indices in bitstring order
            (reversed where ``reverse``).
        """
        from pulser_tpu_torch.ops.kernels import sample_states

        seg_of = self.eval_map[np.asarray(time_index, dtype=np.int64)]
        n_seg, n_off = len(seg_of), len(offs)
        packed = np.concatenate(
            [
                seg_of.astype(np.int64),
                np.asarray(offs, dtype=np.int64),
                np.asarray(rnd, dtype=np.float64).view(np.int64),
            ]
        )
        staged = _stage_host(packed, self.planes.device)
        idx = sample_states(
            self.planes,
            staged[:n_seg],
            staged[n_seg : n_seg + n_off],
            staged[n_seg + n_off :].view(torch.float64),
            renormalize=renormalize,
            reverse=reverse,
        )
        profiling.count("sync.solver.fetch")
        profiling.count("traj.fetched_bytes", idx.numel() * idx.element_size())
        return idx.cpu().numpy().astype(np.int64)


def _lindblad_drive_arrays(
    plans: BatchedPlan, rdtype: Any, device: Any
) -> tuple:
    """Staged drive arrays for the lab-frame quantum-jump solve, on
    ``device``.

    For a :class:`BatchedPlan` carrying raw coefficients, only the small
    knot values (or rank factors) cross to the device, where
    :func:`_stage_on_device` gathers the stage arrays.

    Returns:
        ``(amp_re, amp_im, det, base_plan, n_traj)`` with the staged
        arrays in the ``(B, n_seg, L, 3, nb, n)`` layout.
    """
    dev = torch.device(device)
    np_r = np.dtype(rdtype)
    if plans.raw_coeffs is not None and plans.plan.stage_knots is not None:
        idx0, idx1, frac = plans.seg_knots()
        gather = (
            _on_device(idx0, dev),
            _on_device(idx1, dev),
            _on_device(np.asarray(frac, np_r), dev),
        )
        staged = [
            _stage_on_device(_on_device(leaf, dev), *gather)
            for leaf in _raw_drive_leaves(plans, np_r)
        ]
        return (*staged, plans.plan, plans.n_traj)
    base, n_traj, host = _batched_inputs(plans, ("amp", "det"))
    return (
        _stage_host(host["amp"].real, dev, np_r),
        _stage_host(host["amp"].imag, dev, np_r),
        _stage_host(host["det"].real, dev, np_r),
        base,
        n_traj,
    )


def mcwf_ip_eligible(collapse_ops: "list[np.ndarray]") -> bool:
    """Whether MCWF can integrate in the interaction picture.

    The IP rotor is diagonal, so the unravelling is frame-invariant
    exactly when every collapse operator is either diagonal (commutes
    with the rotor) or a single matrix unit ``|a⟩⟨b|`` (rotor
    conjugation is a global phase on the post-jump state).
    """
    for c in collapse_ops:
        c = np.asarray(c)
        off = c - np.diag(np.diag(c))
        if not np.any(off):
            continue
        if np.count_nonzero(c) == 1:
            continue
        return False
    return True


def _diag_cops_spec(
    collapse_ops: list[np.ndarray],
) -> "tuple[tuple[float, float, float, float], ...] | None":
    """Flattens diagonal 2x2 collapse ops, or None if any is not."""
    spec = []
    for c_np in collapse_ops:
        c = np.asarray(c_np, dtype=np.complex128)
        if c.shape != (2, 2) or c[0, 1] != 0 or c[1, 0] != 0:
            return None
        spec.append(
            (
                float(c[0, 0].real),
                float(c[0, 0].imag),
                float(c[1, 1].real),
                float(c[1, 1].imag),
            )
        )
    return tuple(spec)


#: Largest register the quantum-jump kernels take: the bound the JAX
#: package's TPU block ladder admits for the row-batched kernel, kept for
#: the lab-frame kernel (at n = 13 a trajectory's stage-input planes take
#: 128 KiB of its block's shared memory).
MCWF_MAX_QUBITS = 13


def _n_bases(plans: BatchedPlan) -> int:
    """The number of drive bases of a batched plan's coefficients."""
    raw_amp = (plans.raw_coeffs or {}).get("amp")
    if isinstance(raw_amp, RankFactors):
        return int(raw_amp.profiles.shape[1])
    if raw_amp is not None:
        return int(np.asarray(raw_amp).shape[1])
    return int(plans.seg_stage_b("amp").shape[-2])


def _mcwf_route(
    plans: Any,
    ip: bool,
    collapse_ops: list[np.ndarray],
    d: int,
    n: int,
    pairs: tuple,
    rdtype: Any,
) -> str:
    """Which quantum-jump solve takes this configuration.

    Both kernels take a :class:`BatchedPlan`, qubits (d=2) with one
    ground-rydberg drive basis, float32 and 2 ≤ n ≤ 13. On the
    interaction-picture grid the operators must all be diagonal: the
    row-batched solve (K2). On the lab-frame grid they may be any local
    2×2: the lab-frame solve (K3). Everything else (relaxation and other
    single matrix units on the interaction-picture grid, qudits or
    several bases, more atoms, float64, a list of plans) runs the torch
    scan :func:`_mcwf_traj_states`.

    Returns:
        ``"rows"``, ``"lab"`` or ``"scan"``.
    """
    if not (
        isinstance(plans, BatchedPlan)
        and d == 2
        and _n_bases(plans) == 1
        and tuple(pairs) == ((1, 0, 0),)
        and np.dtype(rdtype) == np.float32
        and 2 <= n <= MCWF_MAX_QUBITS
    ):
        return "scan"
    if not ip:
        return "lab"
    return "rows" if _diag_cops_spec(collapse_ops) is not None else "scan"


def _traj_uniforms(
    keys: np.ndarray, seg_shape: tuple[int, int], dtype: Any = np.float32
) -> tuple[np.ndarray, np.ndarray]:
    """``(r0 (B,), us (B, S, L, 2))`` of one trajectory key each: the JAX
    package's ``key, k0, ku = split(key, 3)``, the initial threshold from
    ``k0`` and the per-step uniforms (channel selector, next threshold)
    from ``ku``, bit for bit (:mod:`pulser_tpu_torch.ops.random`)."""
    from pulser_tpu_torch.ops import random as prng

    sub = prng.split(keys, 3)  # (B, 3, 2)
    r0 = prng.uniform(sub[:, 1], (), dtype)
    us = prng.uniform(
        sub[:, 2], tuple(int(x) for x in seg_shape) + (2,), dtype
    )
    return r0, us


def _mcwf_uniforms(
    seeds: list[int], seg_shape: tuple[int, int], dtype: Any = np.float32
) -> tuple[np.ndarray, np.ndarray]:
    """Pre-draws ``(r0 (B,), us (B, S, L, 2))`` per trajectory.

    Trajectory ``b`` uses the JAX package's key derivation of the batched
    solve (``split(PRNGKey(seed), 1)[0]``, then :func:`_traj_uniforms`).
    """
    from pulser_tpu_torch.ops import random as prng

    key = prng.split(prng.PRNGKey(np.asarray(seeds, dtype=np.int64)), 1)
    return _traj_uniforms(key[:, 0], seg_shape, dtype)


def rows_kernel_inputs(
    psi0_np: np.ndarray,
    plans: BatchedPlan,
    diags: np.ndarray,
    seeds: list[int],
    device: Any,
) -> list[torch.Tensor]:
    """The tensors :func:`~pulser_tpu_torch.ops.kernels.mcwf_rows` takes
    for one noisy batch: drives and phase integrals staged on ``device``
    from the raw knot coefficients, the shared grid, the trajectories'
    uniforms, diagonals and the initial state (float32)."""
    dev = torch.device(device)
    f32 = torch.float32
    base = plans.plan
    n_seg, seg_len = base.seg_dts.shape
    if plans.raw_coeffs is None or base.stage_knots is None:
        raise NotImplementedError(
            "Not ported: the quantum-jump solve stages raw knot"
            " coefficients (build the plan with build_plan_batched)."
        )
    amp_re_leaf, amp_im_leaf, _ = _raw_drive_leaves(plans, np.float32)
    cum_in = [_on_device(x, dev) for x in _raw_cum_inputs(plans, np.float32)]
    idx0, idx1, frac = cum_in[2], cum_in[3], cum_in[5]
    amp_re = _stage_on_device(_on_device(amp_re_leaf, dev), idx0, idx1, frac)
    amp_im = _stage_on_device(_on_device(amp_im_leaf, dev), idx0, idx1, frac)
    cum_b, ev_cum_b = _stage_cum_on_device(*cum_in)
    r0, us = _mcwf_uniforms(seeds, (n_seg, seg_len))
    np32 = np.float32
    return [
        amp_re,
        amp_im,
        cum_b,
        _stage_host(base.seg_stage("t_stage"), dev, np32),
        _stage_host(base.seg_dts, dev, np32),
        _stage_host(us, dev, np32),
        _stage_host(base.eval_times - base.grid[0], dev, np32),
        ev_cum_b.to(f32),
        _stage_host(r0, dev, np32),
        _stage_host(np.asarray(diags).real, dev, np32),
        _stage_host(psi0_np.real, dev, np32),
        _stage_host(psi0_np.imag, dev, np32),
    ]


def _sample_codes(
    states: torch.Tensor, sample_spec: tuple, eval_map: np.ndarray
) -> torch.Tensor:
    """The on-device measurement draws after the solve.

    Probabilities of each (trajectory, segment) state, their float32
    cumsum, one gathered row per entry, and a searchsorted-left of
    ``u · total`` (the total scaling keeps the draw exact under cumsum
    rounding).

    Args:
        states: ``(B, S, 2, dim)`` solver output.
        sample_spec: ``(samp_u, row_traj, row_ti)``: ``(n_entries, m)``
            uniforms, and each entry's trajectory and (requested)
            evaluation-time index.
        eval_map: The plan's evaluation-time -> segment map.

    Returns:
        ``(n_entries, m)`` sampled STATE indices (int64, on the device).
    """
    samp_u, row_traj, row_ti = sample_spec
    dev = states.device
    row_idx = np.asarray(row_traj, np.int64) * states.shape[1] + np.asarray(
        eval_map, np.int64
    )[np.asarray(row_ti, np.int64)]
    p = states[:, :, 0] ** 2 + states[:, :, 1] ** 2
    cum = torch.cumsum(p.reshape(-1, p.shape[-1]), dim=-1)
    rows_g = cum[_stage_host(row_idx, dev)]
    u = _stage_host(np.asarray(samp_u, np.float32), dev)
    return torch.searchsorted(rows_g, u * rows_g[:, -1:], right=False)


def _mcsolve_rows_kernel(
    psi0_np: np.ndarray,
    plans: BatchedPlan,
    diags: np.ndarray,
    n: int,
    cops_spec: tuple,
    seeds: list[int],
    cdtype: Any,
    device: Any,
    sample_spec: "tuple | None" = None,
) -> np.ndarray:
    """Runs the row-batched quantum-jump solve
    (:func:`~pulser_tpu_torch.ops.kernels.mcwf_rows`).

    With ``sample_spec = (samp_u, row_traj, row_ti)`` the measurement
    draws run on the device after the solve and only the sampled STATE
    indices return; ``row_ti`` indexes the plan's (requested) evaluation
    times (the unique-segment mapping ``eval_map`` is applied here).

    Returns:
        ``(n_entries, m)`` int64 state indices with ``sample_spec``,
        else ``(B, n_eval, dim)`` complex states.
    """
    from pulser_tpu_torch.ops.kernels import mcwf_rows

    dev = torch.device(device)
    base = plans.plan
    args = rows_kernel_inputs(psi0_np, plans, diags, seeds, dev)
    states, _ = mcwf_rows(*args, cops=cops_spec)
    last_solve_info.clear()
    last_solve_info.update(
        kind="mcwf_rows_cuda" if dev.type == "cuda" else "mcwf_rows_torch",
        dim=1 << n,
        n=n,
        n_traj=plans.n_traj,
        n_steps=int(np.count_nonzero(base.seg_dts)),
        n_cops=len(cops_spec),
        sampled=sample_spec is not None,
    )
    if sample_spec is not None:
        return _sample_codes(states, sample_spec, base.eval_map).cpu().numpy()
    host = states.cpu().numpy()[:, base.eval_map]  # (B, n_eval, 2, dim)
    return (host[:, :, 0] + 1j * host[:, :, 1]).astype(cdtype)


def _general_cops_spec(collapse_ops: list[np.ndarray]) -> dict[str, Any]:
    """The static collapse algebra of the lab-frame kernel: each local
    2×2 as 8 floats ``(l00r, l00i, l01r, l01i, l10r, l10i, l11r,
    l11i)``, and the diagonal ``(G00, G11)`` and ``G[1, 0]`` (as ``(re,
    im)``) of ``G = Σ_k L_k†L_k``, formed in float64."""
    mats = [np.asarray(c, dtype=np.complex128) for c in collapse_ops]
    g = sum(m.conj().T @ m for m in mats)
    return dict(
        cops=tuple(
            tuple(float(v) for e in m.reshape(-1) for v in (e.real, e.imag))
            for m in mats
        ),
        g_diag=(float(g[0, 0].real), float(g[1, 1].real)),
        g_lo=(float(g[1, 0].real), float(g[1, 0].imag)),
    )


def mcwf_kernel_inputs(
    psi0_np: np.ndarray,
    plans: BatchedPlan,
    diags: np.ndarray,
    collapse_ops: list[np.ndarray],
    seeds: list[int],
    device: Any,
) -> tuple[list[torch.Tensor], dict[str, Any]]:
    """The tensors and keywords :func:`~pulser_tpu_torch.ops.kernels.mcwf`
    takes for one noisy batch, in the layout of the JAX package's
    ``_mcwf_jit``: drives and detunings staged on ``device``
    (``(B·S, L, 3, n)``), the grid tiled per trajectory, the
    trajectories' uniforms, diagonals and the initial state (float32),
    and the static collapse algebra."""
    dev = torch.device(device)
    base = plans.plan
    n_traj = plans.n_traj
    n_seg, seg_len = base.seg_dts.shape
    dim = psi0_np.shape[0]
    n = dim.bit_length() - 1
    n_col = min(7, n - 1)
    n_row = n - n_col
    shape2d = (1 << n_row, 1 << n_col)
    amp_re, amp_im, det, _, _ = _lindblad_drive_arrays(plans, np.float32, dev)
    r0, us = _mcwf_uniforms(seeds, (n_seg, seg_len))

    def flat(x: torch.Tensor) -> torch.Tensor:
        return x.reshape(n_traj * n_seg, seg_len, 3, n)

    tensors = [flat(amp_re), flat(amp_im), flat(det)] + [
        _stage_host(x, dev, np.float32)
        for x in (
            np.tile(base.seg_dts.reshape(n_seg, seg_len, 1), (n_traj, 1, 1)),
            us.reshape(n_traj * n_seg, seg_len, 2),
            r0.reshape(n_traj, 1),
            np.asarray(diags).real.reshape((n_traj,) + shape2d),
            psi0_np.real.reshape(shape2d),
            psi0_np.imag.reshape(shape2d),
        )
    ]
    kw = dict(
        n_row=n_row,
        n_col=n_col,
        seg_len=seg_len,
        segs_per_traj=n_seg,
        **_general_cops_spec(collapse_ops),
    )
    return tensors, kw


def _mcsolve_kernel_batched(
    psi0_np: np.ndarray,
    plans: BatchedPlan,
    diags: np.ndarray,
    n: int,
    collapse_ops: list[np.ndarray],
    seeds: list[int],
    cdtype: Any,
    device: torch.device,
) -> np.ndarray:
    """Runs the lab-frame quantum-jump solve with general collapse
    operators (:func:`~pulser_tpu_torch.ops.kernels.mcwf`).

    Returns:
        ``(B, n_eval, dim)`` complex states.
    """
    from pulser_tpu_torch.ops.kernels import mcwf

    base = plans.plan
    args, kw = mcwf_kernel_inputs(
        psi0_np, plans, diags, collapse_ops, seeds, device
    )
    states, _ = mcwf(*args, **kw)
    last_solve_info.clear()
    last_solve_info.update(
        kind="mcwf_cuda" if device.type == "cuda" else "mcwf_torch",
        dim=1 << n,
        n=n,
        n_traj=plans.n_traj,
        n_steps=int(np.count_nonzero(base.seg_dts)),
        n_cops=len(collapse_ops),
    )
    host = states.cpu().numpy()[:, base.eval_map]  # (B, n_eval, 2, dim)
    return (host[:, :, 0] + 1j * host[:, :, 1]).astype(cdtype)


def mcsolve_rows_codes(
    psi0: np.ndarray,
    plans: BatchedPlan,
    diags: np.ndarray,
    pairs: tuple[tuple[int, int, int], ...],
    d: int,
    n: int,
    collapse_ops: list[np.ndarray],
    seeds: list[int],
    sample_spec: tuple,
    dtype: Any = None,
    mesh: Any = None,
    ip: bool = False,
    device: Any = None,
) -> "np.ndarray | None":
    """Fused quantum-jump solve + on-device measurement draws.

    The noisy-emulation endgame is bitstring counts: when the row-batched
    solve takes the configuration, the draws run on the device against
    the freshly computed state probabilities and only the sampled STATE
    indices return (see :func:`_mcsolve_rows_kernel`).

    Args:
        sample_spec: ``(samp_u, row_traj, row_ti)`` — per-draw uniforms,
            trajectory index and (requested) evaluation-time index.
        mesh: The trajectory mesh: the kernel runs only without one or
            on one rank (the JAX package's rows gate).
        device: The torch device (default: the first CUDA device; without
            one this raises: pass ``"cpu"`` to run on the CPU).

    Returns:
        ``(n_entries, m)`` int64 state indices, or None when the
        row-batched solve does not take this configuration (the caller
        then runs :func:`mcsolve_rk4_batched` and samples on the host).
    """
    cdtype = _complex_dtype(dtype or np.asarray(psi0).dtype)
    rdtype = np.zeros((), dtype=cdtype).real.dtype
    if (
        not collapse_ops
        or _mesh_size(mesh) > 1
        or _mcwf_route(plans, ip, collapse_ops, d, n, pairs, rdtype) != "rows"
        or plans.raw_coeffs is None
        or plans.plan.stage_knots is None
        or plans.plan.knots is None
    ):
        return None
    return _mcsolve_rows_kernel(
        np.asarray(psi0, dtype=cdtype),
        plans,
        diags,
        n,
        _diag_cops_spec(collapse_ops),
        seeds,
        cdtype,
        _resolve_device(device),
        sample_spec=sample_spec,
    )


def mcsolve_rk4_batched(
    psi0: np.ndarray,
    plans: "list[EvolutionPlan] | BatchedPlan",
    diags: np.ndarray,
    pairs: tuple[tuple[int, int, int], ...],
    d: int,
    n: int,
    collapse_ops: list[np.ndarray],
    seeds: list[int],
    dtype: Any = None,
    mesh: Any = None,
    ip: bool = False,
    device: Any = None,
) -> np.ndarray:
    """One quantum-jump realization per noise trajectory, batched.

    Trajectory ``i`` draws from ``seeds[i]`` with the JAX package's key
    derivation (``split(PRNGKey(seeds[i]), 1)[0]``, the key the serial
    solve would give it), so seeded runs match it trajectory for
    trajectory. :func:`_mcwf_route` picks the solve: the row-batched
    interaction-picture kernel with diagonal collapse operators, the
    lab-frame kernel with general local 2×2 ones, or the torch scan
    (:func:`_mcwf_traj_states` with a trajectory batch) for the rest.

    Args:
        plans: A :class:`BatchedPlan`, or one plan per trajectory on one
            grid (the scan).
        mesh: A ``torch.distributed`` mesh to split the trajectories over:
            with more than one rank the batch runs the torch scan (never a
            kernel), each rank on its block, gathered on every rank.
        ip: The plan's grid is the interaction-picture (coarsened) one;
            every collapse operator must then be diagonal or a single
            matrix unit (:func:`mcwf_ip_eligible`).
        device: The torch device (default: the first CUDA device; without
            one this raises: pass ``"cpu"`` to run on the CPU).

    Returns:
        ``(n_traj, n_eval, dim)`` complex states.

    Raises:
        ValueError: No collapse operator (such a batch runs
            :func:`sesolve_rk4_batched`), or ``ip`` with operators the
            interaction picture does not take.
    """
    if not collapse_ops:
        raise ValueError(
            "Without collapse operators there is no quantum jump to solve:"
            " such a batch runs sesolve_rk4_batched."
        )
    if ip and not mcwf_ip_eligible(collapse_ops):
        raise ValueError(
            "The interaction picture needs diagonal or single-matrix-unit"
            " collapse operators."
        )
    cdtype = _complex_dtype(dtype or np.asarray(psi0).dtype)
    rdtype = np.zeros((), dtype=cdtype).real.dtype
    route = _mcwf_route(plans, ip, collapse_ops, d, n, pairs, rdtype)
    if _mesh_size(mesh) > 1 and len(seeds) > 1:
        route = "scan"
    psi0_np = np.asarray(psi0, dtype=cdtype)
    dev = _resolve_device(device)
    if route == "rows":
        return _mcsolve_rows_kernel(
            psi0_np, plans, diags, n, _diag_cops_spec(collapse_ops), seeds,
            cdtype, dev,
        )
    if route == "lab":
        return _mcsolve_kernel_batched(
            psi0_np, plans, diags, n, collapse_ops, seeds, cdtype, dev
        )
    amp, det, base, n_traj = _mesolve_drive_arrays(plans, rdtype, dev)
    psi0_t = _stage_host(psi0_np, dev)
    diag_b = _on_device(np.asarray(np.asarray(diags).real, rdtype), dev)
    dts = np.asarray(base.seg_dts, dtype=rdtype)
    if ip:
        cum_b, ev_cum_b = _batched_cum_arrays(plans, rdtype, dev)
        shared = tuple(
            _on_device(np.asarray(x, rdtype), dev)
            for x in (
                base.seg_stage("t_stage"),
                base.eval_times - base.grid[0],
                _embedded_g_diag(collapse_ops, d, n),
            )
        )
    r0, us = _mcwf_uniforms(seeds, dts.shape, rdtype)
    batch = _chunk_trajectories(
        n_traj, _mcwf_traj_bytes(collapse_ops, dts.shape[0], d, n, cdtype),
        dev,
    )
    eval_map = _stage_host(base.eval_map, dev)

    def solve(a, dg, r0_b, us_b, x1, x2=None):
        frame: dict[str, Any] = {"det": x1}
        if ip:
            t_stage, eval_t, g_diag = shared
            frame = {"ip_args": (x1, t_stage, eval_t, x2, g_diag)}
        ys = _mcwf_traj_states(
            psi0_t, a.to(psi0_t.dtype), dts, dg, collapse_ops, r0_b, us_b,
            pairs=tuple(tuple(p) for p in pairs), d=d, n=n, **frame,
        )
        return ys.index_select(1, eval_map)

    per_traj = (
        amp, diag_b, _on_device(r0, dev), _on_device(us, dev),
        *((cum_b, ev_cum_b) if ip else (det,)),
    )
    out = _run_trajectory_blocks(
        mesh, per_traj, solve, batch,
        shared=(psi0_t, dts, *collapse_ops, *(shared if ip else ())),
    )
    last_solve_info.clear()
    last_solve_info.update(
        kind="mcwf_batched_torch",
        dim=d**n,
        n=n,
        n_traj=n_traj,
        n_steps=int(np.count_nonzero(base.seg_dts)),
        n_cops=len(collapse_ops),
        ip=bool(ip),
        traj_per_call=batch,
        ranks=_mesh_size(mesh) if n_traj > 1 else 1,
    )
    return out.astype(cdtype, copy=False)


def _run_trajectory_blocks(
    mesh: Any,
    per_traj: tuple[torch.Tensor, ...],
    solve: Callable[..., torch.Tensor],
    batch: int,
    shared: tuple[Any, ...] = (),
) -> np.ndarray:
    """``solve`` over a trajectory batch, ``batch`` trajectories per call.

    ``per_traj`` are the per-trajectory tensors (leading axis); ``solve``
    takes a slice of each and returns that slice's states, and one call's
    states at a time leave the device. With a mesh of several ranks the
    batch is padded to a multiple of its ranks (the last trajectory
    repeated), each rank solves its block so, and the blocks are gathered
    on the host (:func:`~pulser_tpu_torch.parallel.trajectories.
    trajectory_sharded`, which checks that the ranks share ``per_traj``
    and the ``shared`` inputs ``solve`` closes over); the padding is
    sliced off.
    """
    n_traj = per_traj[0].shape[0]

    def on_host(*xs: torch.Tensor) -> torch.Tensor:
        return torch.cat(
            [
                solve(*(x[lo : lo + batch] for x in xs)).cpu()
                for lo in range(0, xs[0].shape[0], batch)
            ]
        )

    if _mesh_size(mesh) > 1 and n_traj > 1:
        from pulser_tpu_torch.parallel.trajectories import (
            pad_to_multiple,
            trajectory_sharded,
        )

        padded, _ = pad_to_multiple(per_traj, _mesh_size(mesh))
        out = trajectory_sharded(mesh, on_host, padded, shared=shared)
        return out[:n_traj].numpy()
    return on_host(*per_traj).numpy()


def _embedded_g_diag(
    collapse_ops: "list[np.ndarray]", d: int, n: int
) -> np.ndarray:
    """The full ``(d**n,)`` diagonal of ``Σ_{k,q} L†L``.

    Only valid when :func:`mcwf_ip_eligible` holds (each per-qudit
    ``L†L`` is then diagonal).
    """
    g_np = np.zeros((d, d), dtype=np.complex128)
    for c_np in collapse_ops:
        c_np = np.asarray(c_np, dtype=np.complex128)
        g_np += c_np.conj().T @ c_np
    off = g_np - np.diag(np.diag(g_np))
    assert not np.any(np.abs(off) > 1e-12), (
        "G must be diagonal for the IP MCWF path"
    )
    gvals = np.diag(g_np).real
    idx = np.arange(d**n)
    out = np.zeros(d**n)
    for q in range(n):
        out += gvals[(idx // d ** (n - 1 - q)) % d]
    return out


def _mcwf_traj_bytes(
    collapse_ops: list, n_seg: int, d: int, n: int, cdtype: Any
) -> int:
    """Device bytes one trajectory of :func:`_mcwf_traj_states` holds:
    its live states, its output segments and the jump candidates."""
    cands = len(collapse_ops) * n * (d + 1)
    return (LIVE_STATE_BUFFERS + n_seg + cands) * d**n * np.dtype(
        cdtype
    ).itemsize


def _mcwf_traj_states(
    psi0: torch.Tensor,
    amp: torch.Tensor,
    dts: np.ndarray,
    diag_static: torch.Tensor,
    collapse_ops: list[np.ndarray],
    r0: torch.Tensor,
    us: torch.Tensor,
    *,
    pairs: tuple[tuple[int, int, int], ...],
    d: int,
    n: int,
    det: torch.Tensor | None = None,
    int_w: torch.Tensor | None = None,
    xy_s: torch.Tensor | None = None,
    xy_indices: tuple[int, int] | None = None,
    ip_args: "tuple[torch.Tensor, ...] | None" = None,
) -> torch.Tensor:
    """A batch of quantum-jump (MCWF) trajectories as a torch loop.

    Each trajectory evolves ``dψ/dt = −iH_eff ψ`` with the non-Hermitian
    ``H_eff = H − (i/2) Σ_{k,q} L†L``. After each RK4 step, the
    trajectories whose decayed norm has fallen to their threshold jump:
    every candidate ``L_k`` on qudit ``q`` is formed at once
    (:func:`~pulser_tpu_torch.ops.apply.jump_candidates`), the channel is
    chosen ∝ ``‖L ψ‖²`` with the step's first uniform, the state is
    renormalized and the step's second uniform becomes the new threshold.
    The jump is a masked update of the whole batch (no host-side branch).

    In the lab frame the derivative is :func:`_lab_terms` with ``−½G``
    added to the drive's group matrices (the XY term and ``int_w`` ride
    along). With ``ip_args = (cum_mod, t_stage, eval_t, eval_cum_mod,
    g_diag)`` the drift integrates in the **interaction picture**
    (:func:`_ip_terms` with the decay ``−½ g_diag``); the jump rotates to
    the lab frame with the step's end rotor and back, and emitted states
    rotate to the lab frame.

    The trajectory batch rides the leading axis of ``r0``/``us``; the
    drive, detuning, diagonal and IP integrals carry it too (the batched
    solve) or not (the serial solve, all trajectories on one
    Hamiltonian).

    Args:
        psi0: ``(dim,)`` complex initial state.
        amp: ``([B,] n_seg, L, 3, n_bases, n)`` complex drive stages.
        dts: ``(n_seg, L)`` host step sizes (0 = padding, skipped: a
            padded step could not jump, its norm being unchanged).
        diag_static: ``([B,] dim)``, or ``([B,] k, dim)`` with ``int_w``.
        collapse_ops: Local ``(d, d)`` collapse operators.
        r0: ``(B,)`` initial thresholds.
        us: ``(B, n_seg, L, 2)`` per-step uniforms.
        pairs, d, n: Static structure.
        det, int_w, xy_s, xy_indices: The lab frame's detuning stages and
            optional interaction interpolation and XY term.
        ip_args: The interaction-picture inputs.

    Returns:
        ``(B, n_seg, dim)`` normalized states after each segment.
    """
    dim = d**n
    mats = np.stack([np.asarray(c, np.complex128) for c in collapse_ops])
    dev, cdtype = psi0.device, psi0.dtype
    coef = candidate_coefs(_stage_host(mats, dev).to(cdtype), d, n)
    n_cand = len(mats) * n
    use_ip = ip_args is not None
    if use_ip:
        cum_mod, t_stage, eval_t, eval_cum_mod, g_diag = ip_args
        chunk_inputs, deriv, step_bytes = _ip_terms(
            amp, diag_static, cum_mod, t_stage, pairs=pairs, d=d, n=n,
            decay=(-0.5 * g_diag).to(cdtype),
        )
        phase_at = _make_ip_phase_fn(pairs, d, n, diag_static.dtype, dev)
    else:
        g_sum = np.einsum("kji,kjl->il", mats.conj(), mats)  # Σ L†L
        g_stack = _stage_host(g_sum, dev).to(cdtype).expand(n, d, d)
        groups = group_sizes(d, n)
        decay = [
            -0.5 * _group_matrix(g_stack, q0, q0 + g, d)
            for q0, g in zip(
                [sum(groups[:i]) for i in range(len(groups))], groups
            )
        ]
        chunk_inputs, deriv, step_bytes = _lab_terms(
            amp, det, diag_static, pairs=pairs, d=d, n=n, int_w=int_w,
            xy_s=xy_s, xy_indices=xy_indices, static_groups=decay,
        )

    def jump(
        psi: torch.Tensor, r: torch.Tensor, u2: torch.Tensor, rot: Any
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """The jump branch, applied where ``‖ψ‖² ≤ r``; ``rot`` is the
        step's end rotor ``e^{−iΦ}`` (interaction picture) or None."""
        hit = (psi.real.square() + psi.imag.square()).sum(-1) <= r
        lab = psi if rot is None else rot * psi
        cands = jump_candidates(coef, lab, d, n)  # (B, K·n, dim)
        w = (cands.real.square() + cands.imag.square()).sum(-1)
        cum = torch.cumsum(w, -1)
        idx = torch.searchsorted(cum, u2[:, :1] * cum[:, -1:])
        idx = idx.clamp_(max=n_cand - 1)
        new = cands.gather(1, idx[..., None].expand(-1, -1, dim))[:, 0]
        new = new / torch.sqrt(torch.clamp_min(w.gather(1, idx), 1e-30))
        if rot is not None:
            new = rot.conj() * new
        return torch.where(hit[:, None], new, psi), torch.where(hit, u2[:, 1], r)

    state = {"r": r0}

    def after_step(psi, inputs, s, step, i):
        rot = inputs[1][..., i, 2, :] if use_ip else None
        psi, state["r"] = jump(psi, state["r"], us[:, s, step], rot)
        return psi

    def emit(s: int, psi: torch.Tensor) -> torch.Tensor:
        # The normalized state (QuTiP's mcsolve convention)
        norm2 = (psi.real.square() + psi.imag.square()).sum(-1, keepdim=True)
        psi_n = psi / torch.sqrt(torch.clamp_min(norm2, 1e-30))
        if use_ip:
            ph = phase_at(diag_static, eval_t[s], eval_cum_mod[..., s, :, :])
            psi_n = torch.complex(torch.cos(ph), -torch.sin(ph)) * psi_n
        return psi_n

    return _scan_segments(
        psi0.expand(r0.shape[0], d**n), dts, chunk_inputs, deriv,
        step_bytes, emit, after_step,
    )


def _avg_density(states: torch.Tensor, denom: int) -> torch.Tensor:
    """``Σ_t |ψ_t><ψ_t| / denom`` over the trajectory axis of ``(B, n_seg,
    dim)`` states: ``(n_seg, dim, dim)``."""
    rho = torch.einsum("tea,teb->eab", states, states.conj())
    return rho / denom


def mcsolve_rk4(
    psi0: np.ndarray,
    plan: EvolutionPlan,
    static_diag: np.ndarray,
    pairs: tuple[tuple[int, int, int], ...],
    d: int,
    n: int,
    collapse_ops: list[np.ndarray],
    ntraj: int,
    seed: int,
    xy_static: np.ndarray | None = None,
    xy_indices: tuple[int, int] | None = None,
    dtype: Any = None,
    mesh: Any = None,
    ip: bool = False,
    device: Any = None,
) -> np.ndarray:
    """Quantum-jump Monte-Carlo (MCWF) solve, trajectory-averaged.

    ``ntraj`` trajectories of one Hamiltonian (:func:`_mcwf_traj_states`)
    averaged into density matrices on the device (QuTiP's
    ``McResult.states`` average). Every trajectory's key comes from one
    stream, ``split(PRNGKey(seed), ntraj)``, as in the JAX package, so a
    seeded solve matches it trajectory for trajectory. The trajectories
    run in device calls of as many as the free device memory holds
    (``torch.cuda.mem_get_info``, :func:`_chunk_trajectories`): the calls
    only split the batch, so they never change the result.

    Args:
        psi0: ``(dim,)`` complex initial state (host numpy).
        collapse_ops: Local ``(d, d)`` complex collapse operators, each
            applied on every qudit.
        ntraj: The number of Monte-Carlo trajectories.
        seed: The seed of the trajectories' key stream.
        xy_static, xy_indices: The XY term (lab frame).
        mesh: A ``torch.distributed`` mesh to split the trajectories
            over: each device call's chunk is rounded up to a multiple of
            its ranks and padded with zero-weight copies of the last key,
            each rank sums its share's weighted density matrices and one
            ``all_reduce`` completes the average, so sharded equals serial
            up to the reduction's rounding, whatever the chunk size.
        ip: Integrate in the interaction picture (no XY term or
            ``int_w``, :func:`mcwf_ip_eligible` operators).
        device: The torch device (default: the first CUDA device; without
            one this raises: pass ``"cpu"`` to run on the CPU).
        (other args as in :func:`sesolve_rk4`)

    Returns:
        ``(n_eval, dim, dim)`` trajectory-averaged density matrices.
    """
    if not collapse_ops:
        raise ValueError("The quantum-jump solve needs collapse operators.")
    has_int_w = "int_w" in plan.stage_arrays
    if ip and (
        xy_static is not None
        or has_int_w
        or not mcwf_ip_eligible(collapse_ops)
    ):
        raise ValueError(
            "The interaction picture needs a static diagonal, no XY term"
            " and diagonal or single-matrix-unit collapse operators."
        )
    from pulser_tpu_torch.ops import random as prng

    cdtype = _complex_dtype(dtype or np.asarray(psi0).dtype)
    rdtype = np.zeros((), dtype=cdtype).real.dtype
    dev = _resolve_device(device)
    two_pi = 2 * np.pi
    kw: dict[str, Any] = {}
    if ip:
        kw["ip_args"] = tuple(
            _stage_host(x, dev, rdtype)
            for x in (
                (-plan.seg_stage("det_cum")) % two_pi,
                plan.seg_stage("t_stage"),
                plan.eval_times - plan.grid[0],
                (-plan.eval_det_cum) % two_pi,
                _embedded_g_diag(collapse_ops, d, n),
            )
        )
    else:
        kw["det"] = _stage_host(plan.seg_stage("det").real, dev, rdtype)
        if has_int_w:
            kw["int_w"] = _stage_host(plan.seg_stage("int_w"), dev, rdtype)
        if xy_static is not None:
            kw["xy_s"] = _stage_host(np.asarray(xy_static).real, dev, rdtype)
            kw["xy_indices"] = xy_indices
    dts = np.asarray(plan.seg_dts, dtype=rdtype)
    keys = prng.split(prng.PRNGKey(seed), ntraj)
    r0, us = _traj_uniforms(keys, dts.shape, rdtype)
    psi0_t = _stage_host(psi0, dev, cdtype)
    amp = _stage_host(plan.seg_stage("amp"), dev, cdtype)
    diag = _stage_host(np.asarray(static_diag).real, dev, rdtype)
    chunk = _chunk_trajectories(
        ntraj, _mcwf_traj_bytes(collapse_ops, dts.shape[0], d, n, cdtype),
        dev,
    )
    dim = d**n
    ranks = _mesh_size(mesh)
    rank = 0
    if ranks > 1:
        from pulser_tpu_torch.parallel import comm

        comm.check_same_inputs(
            mesh, "quantum-jump solve", seed, ntraj, psi0, static_diag,
            pairs, *collapse_ops, *comm.plan_arrays(plan),
        )
        # Each rank takes an equal share of every chunk
        chunk = -(-chunk // ranks) * ranks
        rank = comm.axis_rank(mesh, "traj")
    share = chunk // ranks
    rho = torch.zeros((dts.shape[0], dim, dim), dtype=psi0_t.dtype, device=dev)
    for lo in range(0, ntraj, chunk):
        if ranks == 1:
            idx = np.arange(lo, min(ntraj, lo + chunk))
            weight = np.ones(len(idx), dtype=rdtype)
        else:
            # This rank's share of the chunk; past the last trajectory,
            # zero-weight copies of it (no collective in the loop: a share
            # of padding alone is skipped)
            idx = lo + rank * share + np.arange(share)
            weight = (idx < ntraj).astype(rdtype)
            idx = np.minimum(idx, ntraj - 1)
            if not weight.any():
                continue
        states = _mcwf_traj_states(
            psi0_t, amp, dts, diag, collapse_ops,
            _stage_host(r0[idx], dev, rdtype),
            _stage_host(us[idx], dev, rdtype),
            pairs=tuple(tuple(p) for p in pairs), d=d, n=n, **kw,
        )
        if weight.all():
            rho += _avg_density(states, ntraj)
        else:
            rho += _avg_density(
                states * _stage_host(weight, dev, rdtype)[:, None, None],
                ntraj,
            )
        del states
    if ranks > 1:
        rho = comm.all_reduce_sum(rho, comm.axis_group(mesh, "traj"))
    last_solve_info.clear()
    last_solve_info.update(
        kind="mcwf_serial_torch",
        dim=dim,
        n=n,
        n_traj=ntraj,
        n_steps=int(np.count_nonzero(plan.seg_dts)),
        n_cops=len(collapse_ops),
        ip=bool(ip),
        traj_per_call=chunk,
        ranks=ranks,
    )
    return rho.cpu().numpy()[plan.eval_map].astype(cdtype, copy=False)


# -- The Lindblad master equation -----------------------------------------



class CollapseAlgebra(NamedTuple):
    """The static collapse algebra of :func:`_collapse_algebra`.

    Attributes:
        cdc_sum: ``(d, d)`` complex ``Σ_k L_k†L_k`` (for ``−½{L†L, ρ}``).
        lrl_idx: The matrix-unit terms ``(i1, j1, i2, j2)`` of
            ``L ρ L†`` whose units are not both diagonal.
        lrl_coef: Their complex coefficients ``v1·v2*``.
        diag_mask: ``(dim, dim)`` complex
            ``W[r, c] = Σ_q Σ_t c_t [digit_q(r) = i1][digit_q(c) = i2]``
            over the diagonal-unit terms, or None when there are none.
    """

    cdc_sum: torch.Tensor
    lrl_idx: list[tuple[int, int, int, int]]
    lrl_coef: list[complex]
    diag_mask: torch.Tensor | None


def _collapse_algebra(
    collapse_ops: list[np.ndarray],
    d: int,
    n: int,
    cdtype: torch.dtype,
    device: Any,
    cols: slice = slice(None),
) -> CollapseAlgebra:
    """The collapse algebra of local ``d×d`` operators on every qudit.

    Any local ``L`` is ``Σ v_a |i_a><j_a|``, so ``L ρ L† = Σ_{a,b} v_a
    v_b* E_{i_a j_a} ρ E_{j_b i_b}``: each term moves the ``(j_a, j_b)``
    block of the qudit's (row, column) digits to ``(i_a, i_b)``. Terms
    whose units are both diagonal collapse into one elementwise mask
    ``W``, built on the device from the digit vectors: its entries are
    ``Σ_q C[digit_q(r), digit_q(c)]`` with ``C[i1, i2] = Σ_t c_t``; with
    ``cols``, only those columns of it (a row-sharded ρ's block).
    """
    cdc_sum = np.zeros((d, d), dtype=np.complex128)
    lrl_idx: list[tuple[int, int, int, int]] = []
    lrl_coef: list[complex] = []
    unit_coef = np.zeros((d, d), dtype=np.complex128)
    for c_np in collapse_ops:
        c_np = np.asarray(c_np, dtype=np.complex128)
        cdc_sum += c_np.conj().T @ c_np
        nz = [
            (i, j, c_np[i, j])
            for i in range(d)
            for j in range(d)
            if abs(c_np[i, j]) > 1e-14
        ]
        for i1, j1, v1 in nz:
            for i2, j2, v2 in nz:
                c = v1 * np.conj(v2)
                if i1 == j1 and i2 == j2:
                    unit_coef[i1, i2] += c
                else:
                    lrl_idx.append((i1, j1, i2, j2))
                    lrl_coef.append(complex(c))
    diag_mask = None
    if np.any(np.abs(unit_coef) > 1e-14):
        dig = _digits_of(d, n, device)
        dig_c = dig[:, cols]
        coef = _stage_host(unit_coef, device).to(cdtype)
        diag_mask = torch.zeros(
            (d**n, dig_c.shape[1]), dtype=cdtype, device=device
        )
        for q in range(n):
            diag_mask += coef[dig[q][:, None], dig_c[q][None, :]]
    return CollapseAlgebra(
        _stage_host(cdc_sum, device).to(cdtype),
        lrl_idx,
        lrl_coef,
        diag_mask,
    )


def _dag2(rho: torch.Tensor) -> torch.Tensor:
    """Conjugate transpose of (a batch of) density matrices."""
    return rho.transpose(-1, -2).conj()


def mesolve_ip_eligible(collapse_ops: "list[np.ndarray]") -> bool:
    """Whether the master equation can integrate in the IP.

    The density-matrix rotor conjugation only commutes with the
    dissipator when every collapse operator is DIAGONAL (off-diagonal
    matrix units pick up state-dependent phases in ``LρL†``).
    """
    for c in collapse_ops:
        c = np.asarray(c)
        if np.any(c - np.diag(np.diag(c))):
            return False
    return True


def _dissipator_parts(
    alg: CollapseAlgebra,
    d: int,
    n: int,
    groups: tuple[int, ...],
    cols: slice = slice(None),
) -> tuple[torch.Tensor | None, list[torch.Tensor], list[tuple]]:
    """The dissipator in the scan's layout: ``(mask, g_off_groups, S)``.

    - ``mask``: ``(dim, dim)`` ``W − ½(g_r + g_c)`` with ``g`` the
      diagonal of ``Σ_q (Σ L†L)_q``: the diagonal-unit terms of ``LρL†``
      and the diagonal part of the anticommutator as one elementwise
      factor (None without either);
    - ``g_off_groups``: ``−½·`` the group matrices of the off-diagonal
      part of ``Σ L†L`` (empty when it is diagonal, as for dephasing,
      relaxation and the Pauli channels);
    - ``S``: the nonzero entries ``(i1, i2, j1, j2, c)`` of the
      superoperator ``S[i1, i2, j1, j2] = Σ_t c_t`` of the remaining
      matrix-unit terms (terms that cancel, as the X and Y parts of a
      Pauli channel partly do, drop out). Each entry moves the ``(j1,
      j2)`` block of a qudit's (row, column) digits to ``(i1, i2)``: one
      strided in-place add per entry and qudit.

    With ``cols`` the mask holds only those columns (the
    ``alg.diag_mask`` of :func:`_collapse_algebra` with the same ``cols``).
    """
    cdc = alg.cdc_sum
    dev, cdtype = cdc.device, cdc.dtype
    dim = d**n
    dig = _digits_of(d, n, dev)
    g_vec = torch.zeros(dim, dtype=cdtype, device=dev)
    cdc_diag = torch.diagonal(cdc)
    for q in range(n):
        g_vec += cdc_diag[dig[q]]
    mask = alg.diag_mask
    if bool((cdc_diag != 0).any()):
        anti = -0.5 * (g_vec[:, None] + g_vec[None, cols])
        mask = anti if mask is None else mask + anti
    g_off_groups: list[torch.Tensor] = []
    off = cdc - torch.diag(cdc_diag)
    if bool((off != 0).any()):
        stack = off.expand(n, d, d)
        q0 = 0
        for g in groups:
            g_off_groups.append(-0.5 * _group_matrix(stack, q0, q0 + g, d))
            q0 += g
    s_np = np.zeros((d, d, d, d), dtype=np.complex128)
    for (i1, j1, i2, j2), c in zip(alg.lrl_idx, alg.lrl_coef):
        s_np[i1, i2, j1, j2] += c
    sup = [
        (*(int(i) for i in idx), complex(s_np[idx]))
        for idx in zip(*np.nonzero(s_np))
    ]
    return mask, g_off_groups, sup


def _row_group(
    op: torch.Tensor, rho: torch.Tensor, q0: int, g: int, d: int, n: int
) -> torch.Tensor:
    """``(op on qudits [q0, q0+g)) @ rho`` on the row multi-index; ``op``
    is ``(B..., d**g, d**g)`` with the batch axes of ``rho``, whose
    columns may be any block."""
    lead, width = rho.shape[:-2], rho.shape[-1]
    v = rho.reshape(*lead, d**q0, d**g, d ** (n - q0 - g) * width)
    return torch.matmul(op.unsqueeze(-3), v).reshape(rho.shape)


def _mesolve_scan(
    rho0: torch.Tensor,
    amp: torch.Tensor,
    dts: np.ndarray,
    diag_static: torch.Tensor,
    alg: CollapseAlgebra,
    *,
    pairs: tuple[tuple[int, int, int], ...],
    d: int,
    n: int,
    det: torch.Tensor | None = None,
    int_w: torch.Tensor | None = None,
    xy_s: torch.Tensor | None = None,
    xy_indices: tuple[int, int] | None = None,
    ip_args: "tuple[torch.Tensor, ...] | None" = None,
    shard: Any = None,
) -> torch.Tensor:
    """The Lindblad RK4 scan as a torch loop over segments and steps.

    ``dρ/dt = −i[H, ρ] + Σ_q (W ⊙ ρ + Σ_t c_t E ρ E'†) − ½{Σ L†L, ρ}``:

    - the coherent part applies the grouped drive matrices (folded with
      ``−i``) to the row multi-index, one batched matmul per group, and
      completes the commutator as ``X + X†`` (ρ is Hermitian, so
      ``−i[A, ρ] = X + X†`` with ``X = −iAρ``); in the lab frame the
      static (or ``int_w``-interpolated) diagonal is one elementwise
      factor ``−i(D_r − D_c)``, and the XY flip-flop term (Hermitian, its
      couplings interpolated with ``int_w`` as the diagonal) joins ``A``
      on the row side (:func:`~pulser_tpu_torch.ops.apply.apply_flip_flop_r`);
    - in the **interaction picture** (``ip_args``), ``ρ_I = R†ρR`` with
      the diagonal rotor ``R = e^{−iθ}``: ``[H_I, ρ_I] = R†[A, σ]R`` with
      ``σ = R ρ_I R†``, so one elementwise phase factor goes in and its
      conjugate comes out; the drive ``A`` carries no detuning (it lives
      in the exact phase integrals). Valid when every collapse operator
      is diagonal: the dissipator then commutes with ``R``;
    - the dissipator is :func:`_dissipator_parts`'s mask, the static
      off-diagonal anticommutator groups (``Y + Y†``, ``Y = −½Gρ``), and
      the matrix-unit superoperator's entries as strided adds per qudit.

    A trajectory batch rides leading axes ``B`` of ``amp``, ``det``,
    the IP integrals and ``diag_static`` (all of them, or none); the
    grid, the initial state and the collapse algebra are shared.

    With ``shard`` (a :class:`~pulser_tpu_torch.parallel.state_sharding.
    RhoColumns`) ρ is row-sharded: ``rho0`` and the result hold this
    rank's block ``ρ[:, R_r]`` (``(dim, B)``), ``alg`` was built for those
    columns, and the transpose of ``X + X†`` and the column side of the
    superoperator on sharded digits exchange blocks with the other ranks.

    Args:
        rho0: ``(dim, dim)`` complex initial density matrix.
        amp: ``(B..., n_seg, L, 3, n_bases, n)`` complex drive stages.
        dts: ``(n_seg, L)`` host step sizes (0 = padding, skipped).
        diag_static: ``(B..., dim)`` real interaction diagonal, or
            ``(B..., k, dim)`` with ``int_w``.
        alg: The collapse algebra.
        pairs, d, n: Static structure.
        det: ``(B..., n_seg, L, 3, n_bases, n)`` real detuning stages
            (lab frame).
        int_w: ``(n_seg, L, 3, k)`` interaction-interpolation weights
            (lab frame).
        xy_s: ``(1 or k, n, n)`` real XY couplings (lab frame).
        xy_indices: ``(up_idx, down_idx)`` of the flip-flop term.
        ip_args: ``(cum_mod, t_stage, eval_t, eval_cum_mod)``: the
            range-reduced ``−∫det`` stages ``(B..., n_seg, L, 3, n_bases,
            n)``, the stage times ``(n_seg, L, 3)``, the evaluation times
            ``(n_seg,)`` and ``−∫det`` there ``(B..., n_seg, n_bases, n)``.

    Returns:
        ``(B..., n_seg, dim, dim)`` lab-frame states after each segment.
    """
    cdtype, dev = rho0.dtype, rho0.device
    dim = d**n
    use_ip = ip_args is not None
    groups = group_sizes(d, n)
    offsets = [sum(groups[:i]) for i in range(len(groups))]
    lead = tuple(amp.shape[:-5])
    cs = slice(None) if shard is None else shard.cols
    mask, g_off, sup = _dissipator_parts(alg, d, n, groups, cs)
    # Diagonal collapse operators only: the IP derivative rotates the
    # coherent part alone
    assert not (use_ip and (g_off or sup or xy_s is not None))
    interp_xy = xy_s is not None and int_w is not None and xy_s.shape[0] > 1
    u_static = (
        _neg_i_real(xy_s[0]) if xy_s is not None and not interp_xy else None
    )
    if use_ip:
        cum_mod, t_stage, eval_t, eval_cum_mod = ip_args
        phase_at = _make_ip_phase_fn(pairs, d, n, diag_static.dtype, dev)
    else:
        # −i(D_r − D_c): one factor with the mask folded in, or with
        # int_w one part per interpolation weight, combined per point
        diff = diag_static[..., :, None] - diag_static[..., None, cs]
        lab_parts = torch.complex(torch.zeros_like(diff), -diff)
        lab_fac = lab_parts if mask is None else lab_parts + mask

    def rotors(ph: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(e^{−iθ}, e^{+iθ})``."""
        c, s = torch.cos(ph), torch.sin(ph)
        return torch.complex(c, -s), torch.complex(c, s)

    def outer(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return u[..., :, None] * v[..., None, :]

    def stage_mats(sl: slice, s: int) -> list[torch.Tensor]:
        """``−i·`` the drive group matrices of steps ``sl``:
        ``(B..., c, 3, D, D)`` per group."""
        a = amp[..., s, sl, :, :, :]
        de = torch.zeros_like(a.real) if use_ip else det[..., s, sl, :, :, :]
        mats = build_drive_matrices(a, de, pairs, d, n)
        return [
            -1j * _group_matrix(mats, q0, q0 + g, d)
            for q0, g in zip(offsets, groups)
        ]

    def rhs(p: torch.Tensor, mats, fac, ph, ux) -> torch.Tensor:
        # ρ is Hermitian, so −i[A, ρ] = X + X† with X = −iAρ (the group
        # matrices carry the −i), and −½{G, ρ} = Y + Y† with Y = −½Gρ:
        # one side of group products, and a derivative that is Hermitian
        # by construction
        x = ph[0] * p if use_ip else p
        acc_x = None
        for q0, g, m in zip(offsets, groups, mats):
            t = _row_group(m, x, q0, g, d, n)
            acc_x = t if acc_x is None else acc_x.add_(t)
        if ux is not None:
            acc_x.add_(apply_flip_flop_r(ux, x, d, n, *xy_indices, rows=True))
        for q0, g, m in zip(offsets, groups, g_off):
            acc_x.add_(_row_group(m, p, q0, g, d, n))
        k = acc_x + (_dag2(acc_x) if shard is None else shard.dag(acc_x))
        if use_ip:
            k = ph[1] * k
            if mask is not None:
                k = torch.addcmul(k, mask, p)
        else:
            k = torch.addcmul(k, fac, p)
        for q in range(n if sup else 0):
            if shard is not None:
                shard.sup_add(k, p, q, sup, d, n)
                continue
            shape5 = (*lead, d**q, d, d ** (n - 1), d, d ** (n - q - 1))
            kv, pv = k.view(shape5), p.view(shape5)
            for i1, i2, j1, j2, c in sup:
                kv[..., i1, :, i2, :].add_(pv[..., j1, :, j2, :], alpha=c)
        return k

    def chunk_inputs(s: int, sl: slice) -> tuple:
        """Steps ``sl`` of segment ``s``: ``−i·`` the drive group matrices
        ``(B..., c, 3, D, D)``, and the IP rotors ``(B..., c, 3, dim)``
        or the ``int_w`` weights ``(c, 3, k)``."""
        mats = stage_mats(sl, s)
        if use_ip:
            ph = phase_at(
                diag_static[..., None, None, :].expand(
                    lead + (sl.stop - sl.start, 3, dim)
                ),
                t_stage[s, sl, :, None],
                cum_mod[..., s, sl, :, :, :],
            )
            return mats, rotors(ph)
        return mats, None if int_w is None else int_w[s, sl]

    def point(inputs: tuple, i: int, j: int) -> tuple:
        """Stage point ``j`` of step ``i`` of a chunk: its group matrices,
        lab-frame factor, IP phase factors ``(R·R†, R†·R)`` and ``−iU``."""
        mats_c, extra = inputs
        mats = [m[..., i, j, :, :] for m in mats_c]
        if use_ip:
            u, uc = extra[0][..., i, j, :], extra[1][..., i, j, :]
            phases = (outer(u, uc[..., cs]), outer(uc, u[..., cs]))
            return mats, None, phases, None
        if extra is None:
            return mats, lab_fac, None, u_static
        f = (extra[i, j][:, None, None] * lab_parts).sum(-3)
        ux = u_static
        if interp_xy:
            ux = _neg_i_real(torch.einsum("k,kab->ab", extra[i, j], xy_s))
        return mats, f if mask is None else f + mask, None, ux

    n_seg, seg_len = dts.shape
    # The drive matrices and rotors are staged for a chunk of steps at once
    per_step = 3 * (sum((d**g) ** 2 for g in groups) + 2 * dim * use_ip)
    per_step *= (int(np.prod(lead)) if lead else 1) * rho0.element_size()
    chunk = _step_chunk(seg_len, per_step)
    rho = rho0.expand(lead + tuple(rho0.shape)).clone()
    out = torch.empty(
        lead + (n_seg,) + tuple(rho0.shape), dtype=cdtype, device=dev
    )
    for s in range(n_seg):
        for c0 in range(0, seg_len, chunk):
            sl = slice(c0, min(seg_len, c0 + chunk))
            if not np.any(dts[s, sl]):
                continue  # start padding of a short segment
            inputs = chunk_inputs(s, sl)
            for i in range(sl.stop - sl.start):
                h = float(dts[s, sl.start + i])
                if h == 0.0:
                    continue
                pts = [point(inputs, i, j) for j in range(3)]
                k = acc = None
                for j in range(4):
                    p = rho
                    if k is not None:
                        p = torch.add(rho, k, alpha=h * _RK_A[j])
                    k = rhs(p, *pts[_RK_STAGE[j]])
                    if acc is None:
                        acc = _RK_B[j] * k
                    else:
                        acc.add_(k, alpha=_RK_B[j])
                rho.add_(acc, alpha=h)
        if use_ip:
            u, uc = rotors(
                phase_at(diag_static, eval_t[s], eval_cum_mod[..., s, :, :])
            )
            out[..., s, :, :] = outer(u, uc[..., cs]) * rho
        else:
            out[..., s, :, :] = rho
    return out


def _chunk_trajectories(
    n_traj: int, per_traj_bytes: int, device: torch.device
) -> int:
    """Trajectories per device call: what the free device memory holds
    (``torch.cuda.mem_get_info``, with a fifth kept back), the whole
    batch on the CPU."""
    if device.type != "cuda":
        return n_traj
    free, _ = torch.cuda.mem_get_info(device)
    return max(1, min(n_traj, int(0.8 * free) // max(1, per_traj_bytes)))


def mesolve_rk4(
    rho0: "np.ndarray | tuple",
    plan: EvolutionPlan,
    static_diag: np.ndarray,
    pairs: tuple[tuple[int, int, int], ...],
    d: int,
    n: int,
    collapse_ops: list[np.ndarray],
    xy_static: np.ndarray | None = None,
    xy_indices: tuple[int, int] | None = None,
    dtype: Any = None,
    ip: bool = False,
    state_mesh: Any = None,
    lazy: bool = False,
    device: Any = None,
) -> "np.ndarray | DeviceStateBatch":
    """Solves the Lindblad master equation over the plan's grid.

    ``dρ/dt = −i[H, ρ] + Σ_{k,q} L ρ L† − ½{L†L, ρ}`` with every
    collapse operator a local ``d×d`` matrix applied on each qudit
    (:func:`_mesolve_scan`).

    Args:
        rho0: ``(dim, dim)`` complex initial density matrix (host), or
            ``("pure", psi)``: a ``(dim,)`` state whose ``ψψ†`` is formed
            on the device (the dense host matrix never exists).
        plan: The evolution plan; ``int_w`` stage arrays select the
            interpolated interaction (lab frame only).
        static_diag: ``(dim,)`` interaction diagonal (``(k, dim)`` with
            ``int_w``).
        collapse_ops: Local ``(d, d)`` complex collapse operators (each
            applied on every qudit).
        xy_static: Optional ``(nxy, N, N)`` XY couplings (1 or 2
            configurations, interpolated with ``int_w`` when 2; lab frame).
        xy_indices: ``(up_idx, down_idx)`` of the flip-flop term.
        dtype: Complex dtype of the evolution (defaults to rho0's).
        ip: Integrate in the interaction picture (every collapse operator
            diagonal, no ``int_w``).
        state_mesh: A ``torch.distributed`` mesh to shard ρ's rows over
            (:class:`~pulser_tpu_torch.parallel.state_sharding.RhoColumns`;
            its size must divide ``d**n``); every rank returns the whole
            result.
        lazy: Return a :class:`DeviceStateBatch` of the ``(dim, dim)``
            states instead of a host array.
        device: The torch device (default: the first CUDA device; without
            one this raises: pass ``"cpu"`` to run on the CPU).

    Returns:
        ``(n_eval, dim, dim)`` complex density matrices at the evaluation
        times (host numpy), or a :class:`DeviceStateBatch`.
    """
    dim = d**n
    n_dev = _mesh_size(state_mesh)
    if state_mesh is not None and dim % n_dev:
        raise ValueError(
            f"cannot shard a dim-{dim} density matrix over {n_dev} devices"
        )
    has_int_w = "int_w" in plan.stage_arrays
    if ip and (
        has_int_w
        or xy_static is not None
        or not mesolve_ip_eligible(collapse_ops)
    ):
        raise ValueError(
            "The interaction picture needs a static diagonal, no XY term"
            " and diagonal collapse operators."
        )
    pure = isinstance(rho0, tuple) and rho0[0] == "pure"
    src = np.asarray(rho0[1] if pure else rho0)
    cdtype = _complex_dtype(dtype or src.dtype)
    rdtype = np.zeros((), dtype=cdtype).real.dtype
    dev = _resolve_device(device)
    shard = None
    if state_mesh is not None:
        from pulser_tpu_torch.parallel import comm
        from pulser_tpu_torch.parallel.state_sharding import RhoColumns

        if not comm.in_mesh(state_mesh):
            # A rank the mesh leaves out receives the result
            out = comm.broadcast_from(
                None, state_mesh, (plan.seg_dts.shape[0], dim, dim),
                _torch_dtype(cdtype),
            )
            return _mesolve_result(out, plan, cdtype, lazy)
        comm.check_same_inputs(
            state_mesh, "master-equation solve", src, static_diag, pairs,
            *collapse_ops, *comm.plan_arrays(plan),
        )
        shard = RhoColumns(state_mesh, dim)
    cols = slice(None) if shard is None else shard.cols
    if pure:
        psi = _stage_host(src, dev, cdtype)
        rho0_t = psi[:, None] * psi.conj()[None, cols]
    else:
        rho0_t = _stage_host(np.asarray(src)[:, cols], dev, cdtype)
    alg = _collapse_algebra(collapse_ops, d, n, rho0_t.dtype, dev, cols)
    two_pi = 2 * np.pi
    kw: dict[str, Any] = {}
    if ip:
        kw["ip_args"] = tuple(
            _stage_host(x, dev, rdtype)
            for x in (
                (-plan.seg_stage("det_cum")) % two_pi,
                plan.seg_stage("t_stage"),
                plan.eval_times - plan.grid[0],
                (-plan.eval_det_cum) % two_pi,
            )
        )
    else:
        kw["det"] = _stage_host(plan.seg_stage("det").real, dev, rdtype)
        if has_int_w:
            kw["int_w"] = _stage_host(
                plan.seg_stage("int_w").real, dev, rdtype
            )
        if xy_static is not None:
            kw["xy_s"] = _stage_host(np.asarray(xy_static).real, dev, rdtype)
            kw["xy_indices"] = xy_indices
    out = _mesolve_scan(
        rho0_t,
        _stage_host(plan.seg_stage("amp"), dev, cdtype),
        np.asarray(plan.seg_dts, dtype=rdtype),
        _stage_host(np.asarray(static_diag).real, dev, rdtype),
        alg,
        pairs=tuple(tuple(p) for p in pairs),
        d=d,
        n=n,
        shard=shard,
        **kw,
    )
    if shard is not None:
        # (n_seg, dim, B) blocks -> the whole (n_seg, dim, dim) in every
        # rank's host memory (and in those the mesh leaves out); the card
        # holds only its block
        parts = comm.gather_to_host(out, shard.group)  # (P, n_seg, dim, B)
        out = torch.movedim(parts, 0, -2).reshape(out.shape[0], dim, dim)
        out = comm.broadcast_from(out, state_mesh, tuple(out.shape), out.dtype)
    last_solve_info.clear()
    last_solve_info.update(
        kind=f"mesolve_{dev.type}",
        dim=d**n,
        n=n,
        n_steps=int(np.count_nonzero(plan.seg_dts)),
        n_cops=len(collapse_ops),
        ip=bool(ip),
        ranks=n_dev,
    )
    return _mesolve_result(out, plan, cdtype, lazy)


def _mesolve_result(
    out: torch.Tensor, plan: EvolutionPlan, cdtype: Any, lazy: bool
) -> "np.ndarray | DeviceStateBatch":
    """:func:`mesolve_rk4`'s ``(n_seg, dim, dim)`` states at the
    evaluation times: a :class:`DeviceStateBatch`, or host numpy."""
    if lazy:
        return DeviceStateBatch(out, plan.eval_map, lambda h: h.astype(cdtype))
    return out.cpu().numpy()[plan.eval_map].astype(cdtype)


def _batched_cum_arrays(
    plans: "list[EvolutionPlan] | BatchedPlan", rdtype: Any, device: Any
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotor-phase arrays for a batched IP solve, on ``device``.

    Returns ``(cum_mod_b, eval_cum_mod_b)``: the per-trajectory staged
    detuning integrals (pre-negated mod 2π) and their values at the
    evaluation times. For a :class:`BatchedPlan` carrying raw
    coefficients the staging runs on the device
    (:func:`_stage_cum_on_device`); otherwise the host-staged integrals
    are reduced mod 2π in float64 before the cast.
    """
    two_pi = 2 * np.pi
    dev = torch.device(device)
    np_r = np.dtype(rdtype)
    if (
        isinstance(plans, BatchedPlan)
        and plans.raw_coeffs is not None
        and plans.plan.stage_knots is not None
        and plans.plan.knots is not None
    ):
        cum_in = [_on_device(x, dev) for x in _raw_cum_inputs(plans, np_r)]
        return _stage_cum_on_device(*cum_in)
    if isinstance(plans, BatchedPlan):
        cum_np = (-plans.seg_stage_b("det_cum")) % two_pi
        ev_np = (-plans.eval_det_cum_b) % two_pi
    else:
        cum_np = np.stack([(-p.seg_stage("det_cum")) % two_pi for p in plans])
        ev_np = np.stack([(-p.eval_det_cum) % two_pi for p in plans])
    return (
        _on_device(np.asarray(cum_np, np_r), dev),
        _on_device(np.asarray(ev_np, np_r), dev),
    )


def _mesolve_drive_arrays(
    plans: "list[EvolutionPlan] | BatchedPlan", rdtype: Any, device: Any
) -> tuple:
    """``(amp complex, det, base plan, B)`` in the ``(B, n_seg, L, 3, nb,
    n)`` layout on ``device``: staged there from the raw knots of a
    :class:`BatchedPlan`, transferred from a host-staged one or from a
    list of plans."""
    if isinstance(plans, BatchedPlan) and plans.raw_coeffs is not None and (
        plans.plan.stage_knots is not None
    ):
        amp_re, amp_im, det, base, n_traj = _lindblad_drive_arrays(
            plans, rdtype, device
        )
        return torch.complex(amp_re, amp_im), det, base, n_traj
    base, n_traj, host = _batched_inputs(plans, ("amp", "det"))
    dev = torch.device(device)
    np_r = np.dtype(rdtype)
    np_c = np.result_type(np_r, np.complex64)
    amp = _stage_host(host["amp"], dev, np_c)
    return amp, _stage_host(host["det"].real, dev, np_r), base, n_traj


def mesolve_rk4_batched(
    rho0: np.ndarray,
    plans: "list[EvolutionPlan] | BatchedPlan",
    diags: np.ndarray,
    pairs: tuple[tuple[int, int, int], ...],
    d: int,
    n: int,
    collapse_ops: list[np.ndarray],
    dtype: Any = None,
    mesh: Any = None,
    ip: bool = False,
    device: Any = None,
) -> np.ndarray:
    """Solves one Lindblad equation per noise trajectory, batched.

    All plans share the grid (noise trajectories only perturb coefficient
    values). The batch runs :func:`_mesolve_scan` on a leading trajectory
    axis (the JAX package's ``vmap`` of ``_mesolve_scan_batched``), split
    into device calls of as many trajectories as the free device memory
    holds (``torch.cuda.mem_get_info`` against
    :data:`~pulser_tpu_torch.parallel.capacity.LIVE_STATE_BUFFERS` density
    matrices per trajectory and its output).

    Args:
        rho0: ``(dim, dim)`` shared complex initial density matrix.
        plans: A :class:`BatchedPlan` or one plan per trajectory.
        diags: ``(T, dim)`` per-trajectory interaction diagonals.
        collapse_ops: Local ``(d, d)`` collapse operators.
        dtype: Complex dtype of the evolution (defaults to rho0's).
        mesh: A ``torch.distributed`` mesh to split the trajectories
            over: padded to a multiple of its ranks, each rank solves its
            block, gathered on every rank.
        ip: Integrate in the interaction picture (diagonal collapse
            operators).
        device: The torch device (default: the first CUDA device; without
            one this raises: pass ``"cpu"`` to run on the CPU).

    Returns:
        ``(n_traj, n_eval, dim, dim)`` complex density matrices.
    """
    if ip and not mesolve_ip_eligible(collapse_ops):
        raise ValueError(
            "The interaction picture needs diagonal collapse operators."
        )
    cdtype = _complex_dtype(dtype or np.asarray(rho0).dtype)
    rdtype = np.zeros((), dtype=cdtype).real.dtype
    dev = _resolve_device(device)
    rho0_t = _stage_host(rho0, dev, cdtype)
    amp, det, base, n_traj = _mesolve_drive_arrays(plans, rdtype, dev)
    amp = amp.to(rho0_t.dtype)
    diag_b = _stage_host(np.asarray(diags).real, dev, rdtype)
    alg = _collapse_algebra(collapse_ops, d, n, rho0_t.dtype, dev)
    dts = np.asarray(base.seg_dts, dtype=rdtype)
    if ip:
        cum_b, ev_cum_b = _batched_cum_arrays(plans, rdtype, dev)
        t_stage = _on_device(
            np.asarray(base.seg_stage("t_stage"), rdtype), dev
        )
        eval_t = _on_device(
            np.asarray(base.eval_times - base.grid[0], rdtype), dev
        )
    dim = d**n
    n_seg = dts.shape[0]
    per_traj = (LIVE_STATE_BUFFERS + n_seg) * dim * dim * rho0_t.element_size()
    batch = _chunk_trajectories(n_traj, per_traj, dev)
    eval_map = _stage_host(base.eval_map, dev)

    def solve(a, dg, x1, x2=None):
        frame: dict[str, Any] = {"det": x1}
        if ip:
            frame = {"ip_args": (x1, t_stage, eval_t, x2)}
        ys = _mesolve_scan(
            rho0_t, a, dts, dg, alg, pairs=tuple(tuple(p) for p in pairs),
            d=d, n=n, **frame,
        )
        return ys.index_select(1, eval_map)

    out = _run_trajectory_blocks(
        mesh, (amp, diag_b, *((cum_b, ev_cum_b) if ip else (det,))), solve,
        batch, shared=(rho0_t, dts, *collapse_ops),
    )
    last_solve_info.clear()
    last_solve_info.update(
        kind=f"mesolve_batched_{dev.type}",
        dim=dim,
        n=n,
        n_steps=int(np.count_nonzero(base.seg_dts)),
        n_traj=n_traj,
        n_cops=len(collapse_ops),
        ip=bool(ip),
        traj_per_call=batch,
        ranks=_mesh_size(mesh) if n_traj > 1 else 1,
    )
    return out.astype(cdtype, copy=False)
