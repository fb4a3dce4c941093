"""The collectives of the sharded solves, on ``torch.distributed``.

Every sharded solve of :mod:`pulser_tpu_torch.parallel` moves data with
the functions here, over the process group of one mesh axis
(:func:`axis_group`):

- :func:`all_to_all` (``all_to_all_single`` with per-rank split sizes):
  the XOR-partner exchanges of the state sharding (JAX's ``ppermute``,
  :func:`exchange`), the column transposes and the cycle gathers of the
  row-sharded density matrix;
- :func:`all_reduce_sum`: the histogram and density-matrix ``psum`` of
  the trajectory sharding;
- :func:`gather_to_host`: the final gathers, so that every rank returns
  the whole result. Each rank's share leaves the card first and the
  result is assembled in host memory (``all_gather_single`` where the
  installed PyTorch has it, else ``all_gather_into_tensor``, on gloo;
  one broadcast a rank on NCCL), so the card holds no more than the
  rank's share: the JAX package keeps its outputs sharded and
  assembles them on the host too;
- :func:`broadcast_from`: hands a result to the ranks a mesh leaves out
  (a power-of-two state mesh in a world of another size), host to host.

:func:`check_same_inputs` opens every sharded solve: the ranks compare
digests of their inputs and raise alike unless they agree.

A gloo group moves host tensors: with CUDA tensors the collectives of
the solve loops go through host memory in
:func:`host_staged_collective`, the one place that stages, decided by
:func:`stages_through_host` from the group's backend (never for NCCL).
Complex tensors travel as their real views.
"""

from __future__ import annotations

import hashlib
import math
from typing import Any, Callable, Sequence

import numpy as np
import torch

from pulser_tpu_torch import profiling

#: The :mod:`pulser_tpu_torch.profiling` counters of the bytes this
#: process has sent to other ranks: through :func:`all_to_all` (the
#: exchanges of the solve loops), and through the gathers, reductions and
#: broadcasts that end a solve.
EXCHANGED_BYTES = "comm.exchanged_bytes"
GATHERED_BYTES = "comm.gathered_bytes"

_MESHES: dict[tuple, Any] = {}


def _dist() -> Any:
    import torch.distributed as dist

    return dist


def world_ready() -> bool:
    """Whether a default process group is up in this process."""
    dist = _dist()
    return bool(dist.is_available() and dist.is_initialized())


def make_mesh(shape: tuple[int, ...], names: tuple[str, ...]) -> Any:
    """A ``DeviceMesh`` over the first ``prod(shape)`` ranks of the world,
    cached per layout (building one creates process groups, a collective
    step every rank takes at the same point of the program)."""
    from torch.distributed.device_mesh import DeviceMesh

    dist = _dist()
    dev_type = "cuda" if torch.cuda.is_available() else "cpu"
    key = (dev_type, tuple(shape), tuple(names), dist.get_world_size())
    mesh = _MESHES.get(key)
    if mesh is None:
        ranks = torch.arange(math.prod(shape)).reshape(shape)
        mesh = _MESHES[key] = DeviceMesh(
            dev_type, ranks, mesh_dim_names=tuple(names)
        )
    return mesh


def mesh_size(mesh: Any) -> int:
    """Ranks of a mesh (1 when no mesh is given)."""
    return 1 if mesh is None else int(mesh.size())


def _axis(mesh: Any, axis: str | None) -> str:
    names = tuple(mesh.mesh_dim_names or ())
    if axis in names:
        return axis
    if len(names) == 1:
        return names[0]
    raise ValueError(f"the mesh has no axis {axis!r} (axes: {names})")


def axis_size(mesh: Any, axis: str | None) -> int:
    """Ranks along one named axis of a mesh (a 1-D mesh's only axis
    answers to any name)."""
    names = tuple(mesh.mesh_dim_names)
    return int(mesh.shape[names.index(_axis(mesh, axis))])


def axis_rank(mesh: Any, axis: str | None) -> int:
    """This rank's coordinate along one axis of a mesh."""
    return int(mesh.get_local_rank(_axis(mesh, axis)))


def axis_group(mesh: Any, axis: str | None) -> Any:
    """The process group of one mesh axis."""
    return mesh.get_group(_axis(mesh, axis))


def in_mesh(mesh: Any) -> bool:
    """Whether this rank belongs to the mesh."""
    return mesh.get_coordinate() is not None


def stages_through_host(group: Any, device: Any) -> bool:
    """Whether collectives of ``group`` on ``device`` tensors go through
    host memory: CUDA tensors on a group without NCCL (gloo, the backend
    of several ranks sharing one card, moves host buffers)."""
    if torch.device(device).type != "cuda":
        return False
    return "nccl" not in str(_dist().get_backend(group))


def host_staged_collective(
    fn: Callable, tensors: Sequence[torch.Tensor], group: Any, **kw: Any
) -> None:
    """Runs ``fn(*tensors, group=group, **kw)``, the first tensor being
    the output (written in place); under :func:`stages_through_host` the
    tensors are copied to the host around the call."""
    if not stages_through_host(group, tensors[0].device):
        fn(*tensors, group=group, **kw)
        return
    host = [t.cpu() for t in tensors]
    fn(*host, group=group, **kw)
    tensors[0].copy_(host[0])


def _flat_real(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    if x.is_complex():
        x = torch.view_as_real(x)
    return x.reshape(-1)


def _real_dtype(dtype: torch.dtype) -> torch.dtype:
    return dtype.to_real() if dtype.is_complex else dtype


def all_to_all(
    chunks: Sequence[torch.Tensor | None],
    recv_shapes: Sequence[tuple[int, ...] | None],
    group: Any,
    like: torch.Tensor,
) -> list[torch.Tensor | None]:
    """Sends ``chunks[s]`` to group rank ``s`` and receives a tensor of
    ``recv_shapes[s]`` from it (None: nothing either way), in one
    ``all_to_all_single``. Every rank knows what it receives: the
    patterns are functions of the ranks, which all run the same program.
    ``like`` gives the dtype and device."""
    dist = _dist()
    me = dist.get_rank(group)
    rdt = _real_dtype(like.dtype)
    per = 2 if like.is_complex() else 1
    send = [None if c is None else _flat_real(c.to(like.dtype)) for c in chunks]
    in_sizes = [0 if s is None else s.numel() for s in send]
    out_sizes = [
        0 if sh is None else math.prod(sh) * per for sh in recv_shapes
    ]
    parts = [s for s in send if s is not None]
    inp = (
        torch.cat(parts)
        if parts
        else torch.empty(0, dtype=rdt, device=like.device)
    )
    out = torch.empty(sum(out_sizes), dtype=rdt, device=like.device)
    host_staged_collective(
        dist.all_to_all_single, (out, inp), group,
        output_split_sizes=out_sizes, input_split_sizes=in_sizes,
    )
    profiling.count(
        EXCHANGED_BYTES, (sum(in_sizes) - in_sizes[me]) * inp.element_size()
    )
    res: list[torch.Tensor | None] = []
    for piece, sh in zip(torch.split(out, out_sizes), recv_shapes):
        if sh is None:
            res.append(None)
        elif like.is_complex():
            res.append(torch.view_as_complex(piece.reshape(*sh, 2)))
        else:
            res.append(piece.reshape(sh))
    return res


def exchange(x: torch.Tensor, partner: int, group: Any) -> torch.Tensor:
    """Sends ``x`` to group rank ``partner`` and returns what it sent
    back (a pairwise swap: the XOR-partner ``ppermute``)."""
    dist = _dist()
    size, me = dist.get_world_size(group), dist.get_rank(group)
    if partner == me:
        return x
    chunks: list[torch.Tensor | None] = [None] * size
    shapes: list[tuple[int, ...] | None] = [None] * size
    chunks[partner] = x
    shapes[partner] = tuple(x.shape)
    return all_to_all(chunks, shapes, group, x)[partner]  # type: ignore


def moves_host_buffers(group: Any) -> bool:
    """Whether ``group`` carries host tensors: a gloo backend (alone, or
    beside NCCL as ``cpu:gloo,cuda:nccl``)."""
    return "gloo" in str(_dist().get_backend(group))


#: The largest piece of a result that crosses the card at once when an
#: NCCL group gathers or broadcasts it (:func:`_broadcast_host`).
PIECE_BYTES = 1 << 26


def _global_rank(group: Any, rank: int) -> int:
    return rank if group is None else _dist().get_global_rank(group, rank)


def _broadcast_host(buf: torch.Tensor, src: int, group: Any) -> None:
    """Broadcasts the flat host tensor ``buf`` from global rank ``src``
    in place. NCCL moves device buffers only: there ``buf`` crosses the
    card in pieces of at most :data:`PIECE_BYTES`, through one buffer."""
    dist = _dist()
    if moves_host_buffers(group):
        dist.broadcast(buf, src=src, group=group)
        return
    dev = torch.device("cuda", torch.cuda.current_device())
    step = max(1, min(buf.numel(), PIECE_BYTES // buf.element_size()))
    piece = torch.empty(step, dtype=buf.dtype, device=dev)
    mine = dist.get_rank() == src
    for lo in range(0, buf.numel(), step):
        hi = min(buf.numel(), lo + step)
        part = piece[: hi - lo]
        if mine:
            part.copy_(buf[lo:hi])
        dist.broadcast(part, src=src, group=group)
        if not mine:
            buf[lo:hi].copy_(part)


def _gather_host(x: torch.Tensor, group: Any) -> torch.Tensor:
    """Every rank's flat real view of ``x``, in rank order, on the host."""
    dist = _dist()
    size, me = dist.get_world_size(group), dist.get_rank(group)
    flat = _flat_real(x).cpu()
    if size == 1:
        return flat
    out = torch.empty(size * flat.numel(), dtype=flat.dtype)
    if moves_host_buffers(group):
        gather = getattr(dist, "all_gather_single", None) or (
            dist.all_gather_into_tensor
        )
        gather(out, flat, group=group)
        return out
    for r, part in enumerate(out.split(flat.numel())):
        if r == me:
            part.copy_(flat)
        _broadcast_host(part, _global_rank(group, r), group)
    return out


def gather_to_host(x: torch.Tensor, group: Any) -> torch.Tensor:
    """``(group size, *x.shape)`` on the host: every rank's ``x``, in rank
    order.

    ``x`` leaves the device first, so the card never holds more than this
    rank's share (and, on NCCL, one piece of :data:`PIECE_BYTES`): a
    sharded result too large for one card is assembled in host memory,
    as the JAX package assembles its sharded outputs with ``np.asarray``.
    A gloo group gathers the host tensors in one ``all_gather_single``
    (else ``all_gather_into_tensor``); an NCCL group broadcasts each
    rank's share in turn (:func:`_broadcast_host`).
    """
    dist = _dist()
    out = _gather_host(x, group)
    size = dist.get_world_size(group)
    profiling.count(
        GATHERED_BYTES, (size - 1) * out.numel() // size * out.element_size()
    )
    if x.is_complex():
        return torch.view_as_complex(out.reshape(size, *x.shape, 2))
    return out.reshape(size, *x.shape)


def all_reduce_sum(x: torch.Tensor, group: Any) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks (a new tensor)."""
    dist = _dist()
    flat = _flat_real(x).clone()
    host_staged_collective(dist.all_reduce, (flat,), group)
    profiling.count(GATHERED_BYTES, flat.numel() * flat.element_size())
    if x.is_complex():
        return torch.view_as_complex(flat.reshape(*x.shape, 2))
    return flat.reshape(x.shape)


def broadcast_from(
    x: torch.Tensor | None,
    mesh: Any,
    shape: tuple[int, ...],
    dtype: torch.dtype,
) -> torch.Tensor:
    """The mesh's result on the host of every rank of the world: the ranks
    outside ``mesh`` (``x`` None) receive it from the mesh's first rank.
    A mesh that spans the world returns ``x`` unchanged, with no
    collective."""
    dist = _dist()
    if mesh.size() == dist.get_world_size():
        assert x is not None
        return x
    src = int(mesh.mesh.reshape(-1)[0])
    buf = (
        _flat_real(x.cpu()).clone()
        if x is not None
        else torch.empty(
            math.prod(shape) * (2 if dtype.is_complex else 1),
            dtype=_real_dtype(dtype),
        )
    )
    _broadcast_host(buf, src, None)
    if x is not None:
        profiling.count(GATHERED_BYTES, buf.numel() * buf.element_size())
    if dtype.is_complex:
        return torch.view_as_complex(buf.reshape(*shape, 2))
    return buf.reshape(shape)


def plan_arrays(plan: Any) -> tuple[np.ndarray, ...]:
    """The arrays that define an evolution plan, for
    :func:`check_same_inputs`."""
    return (
        plan.dts,
        plan.eval_times,
        *(plan.stage_arrays[k] for k in sorted(plan.stage_arrays)),
    )


def check_same_inputs(mesh: Any, what: str, *inputs: Any) -> None:
    """Raises unless every rank of ``mesh`` was given the same inputs.

    A sharded solve assumes that every rank runs the same program (the
    same sequence, numpy seeded alike); a job that calls the emulator
    independently on each rank (a parameter sweep under ``torchrun``, a
    training script) breaks that and would hang in the collectives or
    gather other ranks' results into its own. Each rank hashes its
    ``inputs`` (arrays, tensors, numbers: values, dtypes and shapes), the
    digests are gathered along every axis of the mesh, so every rank
    holds all of them, and every rank raises alike on a mismatch.

    Raises:
        RuntimeError: The ranks' inputs differ.
    """
    h = hashlib.blake2b(digest_size=8)
    for a in inputs:
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.reshape(-1).view(np.uint8))
    mine = int(np.frombuffer(h.digest(), dtype=np.int64)[0])
    digests = torch.tensor([mine], dtype=torch.int64)
    for name in mesh.mesh_dim_names:
        digests = _gather_host(digests, mesh.get_group(name))
    if bool((digests != mine).any()):
        raise RuntimeError(
            f"The ranks of a sharded {what} were given different inputs"
            f" ({len(set(digests.tolist()))} distinct among"
            f" {digests.numel()} ranks). Sharding needs every rank to run"
            " the same program: the same sequence, numpy seeded alike. To"
            " run independently on each rank, pass no mesh or set"
            " PULSER_TPU_DISABLE_SHARDING=1."
        )
