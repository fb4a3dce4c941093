"""Demo: a 24-atom (dim 2^24 = 16.8M) solve with the statevector
sharded across ranks.

One card's memory caps out near N ≈ 30 qubits; beyond that the 2^N axis
must split across cards. This demo runs the full public pipeline
(Register → Sequence → TorchEmulator) with the distributed-statevector
solver engaged, each rank holding a 2^N / R block of amplitudes.

Usage:
    python examples_torch/distributed_statevector_demo.py [n_atoms]
        [--device cpu] [--ranks R]
    torchrun --nproc-per-node N examples_torch/distributed_statevector_demo.py

Under ``torchrun`` each process is one rank on its own card (NCCL).
Otherwise the script spawns its ranks itself: one per visible card (NCCL)
when there are several, two ranks sharing the one card (gloo) when there
is one, and with ``--device cpu`` a world of 8 CPU ranks (gloo), as the
JAX demo builds 8 virtual devices. On the CPU all ranks share one host,
so a 24-atom run takes many minutes.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import numpy as np
import torch

# Engage state sharding at this demo's sizes (default threshold: 22)
os.environ.setdefault("PULSER_TPU_STATE_SHARD_MIN_QUBITS", "20")


def solve(n_atoms: int, device: str | None) -> dict:
    """One rank's run of the demo's sequence: timings, the final state's
    norm and the route the solve took."""
    import pulser_tpu_torch as pt
    from pulser_tpu_torch.emulator import TorchEmulator
    from pulser_tpu_torch.ops import solver

    rows = int(np.floor(np.sqrt(n_atoms)))
    cols = -(-n_atoms // rows)
    coords = [
        (7.0 * c, 7.0 * r) for r in range(rows) for c in range(cols)
    ][:n_atoms]
    reg = pt.Register.from_coordinates(coords, prefix="q")
    seq = pt.Sequence(reg, pt.devices.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(pt.Pulse.ConstantPulse(52, 2 * np.pi, 1.0, 0.0), "ryd")

    t0 = time.perf_counter()
    sim = TorchEmulator.from_sequence(
        seq, evaluation_times="Minimal", torch_device=device
    )
    t1 = time.perf_counter()
    res = sim.run()
    final = res.get_final_state(ignore_global_phase=False)
    norm = float(np.linalg.norm(final.full()))
    t2 = time.perf_counter()
    return {
        "rows": rows,
        "cols": cols,
        "build_s": t1 - t0,
        "solve_s": t2 - t1,
        "norm": norm,
        "kind": solver.last_solve_info.get("kind"),
        "ranks": solver.last_solve_info.get("ranks", 1),
        "device": str(sim._torch_device),
    }


def report(out: dict, n_atoms: int, world: int) -> None:
    kind = "cpu" if out["device"] == "cpu" else "cuda"
    print(f"devices: {world} ({kind})")
    print(
        f"atoms: {n_atoms}  (register {out['rows']}x{out['cols']}, truncated)"
    )
    print(f"Hilbert-space dim: 2^{n_atoms} = {2**n_atoms:,}")
    print(f"Hamiltonian build: {out['build_s']:.2f}s")
    print(f"solve (incl. compile): {out['solve_s']:.2f}s")
    print(f"final-state norm: {out['norm']:.8f}")
    assert abs(out["norm"] - 1.0) < 1e-5, "norm drifted — solver bug"
    threshold = int(os.environ["PULSER_TPU_STATE_SHARD_MIN_QUBITS"])
    if world > 1 and n_atoms >= threshold:
        assert out["kind"] == "sesolve_state_sharded_torch", out["kind"]
    print("OK: distributed statevector solve completed")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n_atoms", nargs="?", type=int, default=24)
    parser.add_argument(
        "--device",
        default=None,
        help="'cpu' to run a gloo world of CPU ranks (default: the cards)",
    )
    parser.add_argument(
        "--ranks", type=int, default=None, help="ranks to spawn"
    )
    args = parser.parse_args()
    import torch.distributed as dist

    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        # Launched by torchrun: this process is one rank
        cpu = args.device == "cpu"
        if not cpu:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        world = int(os.environ["WORLD_SIZE"])
        shared = not cpu and world > torch.cuda.device_count()
        dist.init_process_group("gloo" if cpu or shared else "nccl")
        try:
            out = solve(args.n_atoms, args.device)
            if dist.get_rank() == 0:
                report(out, args.n_atoms, world)
        finally:
            dist.destroy_process_group()
        return
    from pulser_tpu_torch.parallel import RankPool

    cpu = args.device == "cpu"
    if not cpu and not torch.cuda.is_available():
        # The entry points' own refusal: no card and no --device cpu
        from pulser_tpu_torch.ops.solver import resolve_device

        resolve_device(None)
    cards = 0 if cpu else torch.cuda.device_count()
    world = args.ranks or (8 if cpu else max(2, cards))
    backend = "gloo" if cpu or world > cards else "nccl"
    env = {
        "PULSER_TPU_STATE_SHARD_MIN_QUBITS": os.environ[
            "PULSER_TPU_STATE_SHARD_MIN_QUBITS"
        ]
    }
    with tempfile.TemporaryDirectory() as tmp:
        with RankPool(
            world, os.path.join(tmp, "store"), backend=backend, env=env
        ) as pool:
            outs = pool.run(solve, args.n_atoms, args.device)
    report(outs[0], args.n_atoms, world)


if __name__ == "__main__":
    main()
