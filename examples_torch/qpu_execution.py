"""Execution on a QPU: the remote-backend workflow, end to end.

PyTorch rendition of the reference's "Execution on a QPU" tutorial
(reference: tutorials/advanced_features/Execution on a QPU.ipynb). A
real deployment points ``QPUBackend`` at a vendor connection; here an
in-process ``RemoteConnection`` stands in, *emulating* each submitted
sequence with ``TorchEmulator`` — which is exactly how a remote emulator
fleet would serve jobs. The workflow is identical either way:

1. fetch the available devices from the connection,
2. build a sequence against the device's calibrated trap layout,
3. submit with job parameters, 4. poll, 5. read bitstring counts.

Run:  python examples_torch/qpu_execution.py [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import numpy as np

import pulser_tpu_torch as pt
from pulser_tpu_torch.backend.remote import (
    BatchStatus,
    JobStatus,
    RemoteConnection,
    RemoteResults,
)
from pulser_tpu_torch.backend.results import Results
from pulser_tpu_torch.emulator import TorchEmulator
from pulser_tpu_torch.ops.solver import resolve_device

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument(
    "--device",
    default=None,
    help="torch device to run on (default: the CUDA card; 'cpu' to run"
    " without one)",
)
DEVICE = resolve_device(parser.parse_args().device)


class EmulatingConnection(RemoteConnection):
    """Serves submitted sequences with the PyTorch emulator.

    Mimics a cloud connection's batch/job lifecycle: each ``submit``
    opens (or extends) a batch, each job-params entry becomes one job,
    and results are sampled bitstring counters.
    """

    def __init__(self) -> None:
        self.batches: dict[str, list[Results]] = {}
        self.open_batches: set[str] = set()

    def fetch_available_devices(self):
        return {"AnalogDevice": pt.AnalogDevice}

    def submit(
        self, sequence, wait=False, open=False, batch_id=None, **kw
    ):
        bid = batch_id or f"batch-{len(self.batches)}"
        if open:
            self.open_batches.add(bid)
        jobs = kw.get("job_params") or [{"runs": 100}]
        for params in jobs:
            built = sequence
            if sequence.is_parametrized():
                built = sequence.build(
                    **params.get("variables", {})
                )
            sim = TorchEmulator.from_sequence(built, torch_device=DEVICE)
            counts = sim.run().sample_final_state(
                N_samples=params["runs"]
            )
            self.batches.setdefault(bid, []).append(
                Results.from_final_bitstrings(
                    atom_order=tuple(built.register.qubit_ids),
                    total_duration=built.get_duration(),
                    final_bitstrings=counts,
                )
            )
        return RemoteResults(bid, self)

    def _fetch_result(self, batch_id, job_ids):
        return tuple(self.batches[batch_id])

    def _query_job_progress(self, batch_id):
        return {
            f"job-{i}": (JobStatus.DONE, r)
            for i, r in enumerate(self.batches[batch_id])
        }

    def _get_batch_status(self, batch_id):
        return BatchStatus.DONE

    def _get_job_ids(self, batch_id):
        return [
            f"job-{i}" for i in range(len(self.batches[batch_id]))
        ]

    def supports_open_batch(self):
        return True

    def _close_batch(self, batch_id):
        self.open_batches.discard(batch_id)


conn = EmulatingConnection()

# --- 1. discover what the connection offers -------------------------
devices = conn.fetch_available_devices()
device = devices["AnalogDevice"]
print(f"available devices: {list(devices)}")

# --- 2. QPUs require calibrated layouts -----------------------------
layout = device.pre_calibrated_layouts[0]
reg = layout.define_register(26, 35, qubit_ids=["q0", "q1"])
seq = pt.Sequence(reg, device)
seq.declare_channel("ryd", "rydberg_global")
# 1000 ns keeps the Blackman peak under the channel's max amplitude
# (4*pi rad/us on AnalogDevice). The 5 um pair sits inside the
# blockade radius, so it behaves as ONE two-level system driven at the
# collective rate sqrt(2)*Omega — a single-atom area of pi/sqrt(2) is
# a collective pi pulse: |00> -> (|01>+|10>)/sqrt(2).
seq.add(
    pt.Pulse.ConstantDetuning(
        pt.BlackmanWaveform(1000, np.pi / np.sqrt(2)), 0.0, 0.0
    ),
    "ryd",
)
seq.measure("ground-rydberg")

# A free-form register is rejected before anything is submitted.
free_seq = pt.Sequence(
    pt.Register.square(2, spacing=6.0, prefix="q"), device
)
free_seq.declare_channel("ryd", "rydberg_global")
free_seq.add(pt.Pulse.ConstantPulse(100, 2.0, 0.0, 0.0), "ryd")
try:
    pt.QPUBackend(free_seq, conn)
    raise AssertionError("expected layout validation to fire")
except ValueError as e:
    print(f"layoutless register rejected: {str(e)[:60]}...")

# --- 3./4. submit and poll ------------------------------------------
qpu = pt.QPUBackend(seq, conn)
remote = qpu.run(job_params=[{"runs": 500}])
assert remote.get_batch_status() == BatchStatus.DONE
print(f"batch {remote.batch_id}: {remote.job_ids}")

# --- 5. read the sampled bitstrings ---------------------------------
counts = remote.results[0].final_bitstrings
total = sum(counts.values())
print(f"bitstring counts ({total} shots): {dict(counts)}")
assert total == 500
# pi-area blackman pulse on a blockaded pair: '00' should be rare
p00 = counts.get("00", 0) / total
assert p00 < 0.2, counts
print(f"P(00) = {p00:.3f} (pulse drove the pair out of vacuum)")

# --- open batches: stream jobs into one logical batch ---------------
with qpu.open_batch() as ob:
    qpu.run(job_params=[{"runs": 50}])
    qpu.run(job_params=[{"runs": 50}])
    bid = ob.backend._batch_id
assert len(conn.batches[bid]) >= 2
assert bid not in conn.open_batches  # closed on context exit
print(f"open batch {bid}: {len(conn.batches[bid])} jobs, now closed")
print("OK qpu-execution walkthrough complete")
