"""Trajectory and state sharding over the ranks of ``torch.distributed``.

Port of ``pulser_tpu/parallel``. The model of execution:

- **One process per rank.** JAX drives many devices from one process;
  here every rank is its own process (SPMD, as under ``torchrun
  --nproc-per-node N``, or a :class:`~.launch.RankPool` from one script)
  and runs the same program: it builds the same ``Sequence`` and seeds
  numpy the same way, so the emulator draws the same noise trajectories
  on every rank. Each rank solves its shard — a block of trajectories, a
  block of ``2^k`` amplitude rows, or both — and the states, ρ or
  histograms are gathered, so **every rank returns the same result**,
  equal to the serial run's. Padding follows :func:`pad_to_multiple`
  (repeat the last trajectory, slice back); the serial quantum-jump
  solve pads its chunks with zero-weight copies of the last key, so
  sharded equals serial whatever the chunk size.
- **A mesh is a** ``torch.distributed.device_mesh.DeviceMesh`` whose
  dimension names are JAX's axis names, ``"traj"`` and ``"state"``; the
  process group of one dimension (``mesh.get_group("state")``) carries
  that axis's collectives. :func:`default_mesh` and
  :func:`~.state_sharding.default_state_mesh` return a mesh over the
  default process group's world when it is initialized and holds at
  least two ranks (the counterpart of "more than one local device"),
  else None: on one card, with no process group, nothing shards by
  default. ``default_state_mesh`` keeps the largest power-of-two set of
  ranks; the ranks a mesh leaves out receive the result by broadcast.
  :func:`default_2d_mesh` keeps JAX's policy: at least 4 ranks, the
  state axis sized from the threshold, the rest to trajectories.
- **The environment variables are the JAX package's:**
  ``PULSER_TPU_DISABLE_SHARDING``, ``PULSER_TPU_STATE_SHARD_MIN_QUBITS``,
  ``PULSER_TPU_RHO_SHARD_MIN_QUBITS`` and ``PULSER_TPU_TRAJ_STATE_MESH``
  (``TxS``).
- **Each rank's device:** the entry points' default device is the rank's
  card (``ops.solver._resolve_device``: ``cuda:{LOCAL_RANK}``, or the
  current CUDA device when ranks share one card); without a card and
  without ``device="cpu"`` they raise, as on one process.
- **The collectives** (:mod:`.comm`), over the axis's process group:

  - JAX's ``ppermute`` over XOR partners becomes ``all_to_all_single``
    with per-rank split sizes (:func:`~.comm.exchange`); the row-sharded
    density matrix's transposes and column slabs use the same call;
  - the histogram and density-matrix ``psum`` becomes ``all_reduce``;
  - the final gathers become ``all_gather_single`` where the installed
    PyTorch has it, else ``all_gather_into_tensor``;
  - gloo (several ranks sharing one card: NCCL refuses two ranks on one
    device) moves host buffers, so with CUDA tensors on a gloo group
    every collective is staged through host memory in one function,
    :func:`~.comm.host_staged_collective` (never with NCCL).

No kernel runs on these paths, as in the JAX package (which turns its
Pallas routes off under a mesh): the sharded bodies are the torch loops
of ``ops.solver`` over ``ops.apply``, each rank on its shard.
"""

from pulser_tpu_torch.parallel.capacity import (
    CapacityError,
    capacity_report,
    check_capacity,
    measured_memory_bytes,
    single_chip_ceiling,
    solve_bytes,
)
from pulser_tpu_torch.parallel.launch import RankPool
from pulser_tpu_torch.parallel.mesh2d import (
    default_2d_mesh,
    sesolve_ip_2d_sharded,
)
from pulser_tpu_torch.parallel.state_sharding import (
    STATE_SHARD_MIN_QUBITS,
    default_state_mesh,
    sesolve_ip_statevector_sharded,
)
from pulser_tpu_torch.parallel.trajectories import (
    default_mesh,
    pad_to_multiple,
    run_trajectories_sharded,
    sesolve_ip_states_sharded,
)

__all__ = [
    "STATE_SHARD_MIN_QUBITS",
    "CapacityError",
    "RankPool",
    "capacity_report",
    "check_capacity",
    "default_2d_mesh",
    "default_mesh",
    "default_state_mesh",
    "measured_memory_bytes",
    "sesolve_ip_2d_sharded",
    "sesolve_ip_statevector_sharded",
    "single_chip_ceiling",
    "solve_bytes",
    "pad_to_multiple",
    "run_trajectories_sharded",
    "sesolve_ip_states_sharded",
]
