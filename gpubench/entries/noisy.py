"""A job of a noisy configuration through ``TorchEmulator``: numpy
seeded with the job's seed first (the emulator draws its noise
realizations when it is built, its shots and their SPAM flips in
``run()``), ``build(**values)``, ``TorchEmulator.from_sequence(seq,
noise_model=..., evaluation_times=...).run()``; the outputs are the
result's bitstring counts at every evaluation time."""

from collections import Counter

import numpy as np


def run(d, job: dict) -> dict:
    from pulser_tpu_torch.emulator import TorchEmulator

    np.random.seed(job["np_seed"])
    seq = d.build(job)
    with d.spans("emulator_build"):
        emu = TorchEmulator.from_sequence(
            seq, noise_model=d.noise,
            evaluation_times=d.evaluation_times(seq.get_duration()),
            torch_device=d.device,
        )
    with d.spans("run"):
        res = emu.run()
    return {"counts": [Counter(r.bitstring_counts) for r in res]}
