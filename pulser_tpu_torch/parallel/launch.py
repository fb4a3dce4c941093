"""A pool of rank processes for running the sharded solves from one script.

Under ``torchrun`` every rank is its own process from the start and
nothing here is needed. A script or a test that wants a world of ranks
from inside one process (the examples with ``--device cpu``, the tests,
the card's smoke run) starts a :class:`RankPool`: ``world_size`` spawned
processes joined by a ``FileStore`` rendezvous in a file the caller
names (so concurrent pools never share a port), one torch thread each,
that run the calls submitted to them until the pool closes::

    with RankPool(4, "/tmp/x/store") as pool:
        results = pool.run(fn, arg)   # fn(arg) on every rank, in rank order

``fn`` must be importable by name in a fresh interpreter (a module-level
function). A call that raises on any rank raises here, with the rank's
traceback.
"""

from __future__ import annotations

import datetime
import os
import traceback
from typing import Any, Callable


def _rank_main(
    rank: int,
    world: int,
    store_path: str,
    backend: str,
    env: dict[str, str],
    timeout_s: float,
    tasks: Any,
    results: Any,
) -> None:
    os.environ.update(env)
    os.environ["RANK"] = str(rank)
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["WORLD_SIZE"] = str(world)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    if torch.cuda.is_available():
        # Ranks beyond the visible cards share the last one
        torch.cuda.set_device(min(rank, torch.cuda.device_count() - 1))
    dist.init_process_group(
        backend,
        init_method=f"file://{store_path}",
        rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    try:
        while True:
            job = tasks.get()
            if job is None:
                break
            fn, args, kwargs = job
            try:
                results.put((rank, True, fn(*args, **kwargs)))
            except BaseException:  # reported to the caller, who raises
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    """``world_size`` rank processes in one ``torch.distributed`` world.

    Args:
        world_size: The number of ranks.
        store_path: The ``FileStore`` file of the rendezvous (must not
            exist yet; its directory must).
        backend: ``"gloo"`` (CPU tensors, or CUDA tensors through host
            memory) or ``"nccl"`` (one card per rank).
        env: Environment variables set in every rank before it starts.
        timeout_s: How long a collective waits for the other ranks before
            it raises (a rank that failed leaves the others waiting).
    """

    def __init__(
        self,
        world_size: int,
        store_path: str,
        backend: str = "gloo",
        env: dict[str, str] | None = None,
        timeout_s: float = 300.0,
    ):
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.world_size = world_size
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(world_size)]
        self._procs = [
            ctx.Process(
                target=_rank_main,
                args=(
                    r, world_size, store_path, backend, dict(env or {}),
                    timeout_s, self._tasks[r], self._results,
                ),
                daemon=True,
            )
            for r in range(world_size)
        ]
        for p in self._procs:
            p.start()

    def run(self, fn: Callable, *args: Any, **kwargs: Any) -> list[Any]:
        """``fn(*args, **kwargs)`` on every rank; the results in rank
        order."""
        for q in self._tasks:
            q.put((fn, args, kwargs))
        out: list[Any] = [None] * self.world_size
        errors = []
        for _ in range(self.world_size):
            rank, ok, value = self._get()
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            raise RuntimeError("\n".join(sorted(errors)))
        return out

    def _get(self) -> tuple:
        import queue

        while True:
            try:
                return self._results.get(timeout=5)
            except queue.Empty:
                dead = [p for p in self._procs if not p.is_alive()]
                if dead:
                    self.close()
                    raise RuntimeError(
                        f"{len(dead)} rank process(es) exited"
                        f" (codes {[p.exitcode for p in dead]})"
                    ) from None

    def close(self) -> None:
        """Stops every rank and waits for it."""
        for q, p in zip(self._tasks, self._procs):
            if p.is_alive():
                q.put(None)
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
