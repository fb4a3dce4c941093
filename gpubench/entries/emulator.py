"""A job through ``TorchEmulator``: ``build(**values)`` of the
parametrized sequence, ``TorchEmulator.from_sequence(seq, noise_model=...,
evaluation_times=...).run()``, the final state fetched to the host, then
``sample_final_state(shots)`` after seeding numpy with the job's seed."""

from collections import Counter

import numpy as np


def run(d, job: dict) -> dict:
    from pulser_tpu_torch.emulator import TorchEmulator

    seq = d.build(job)
    with d.spans("emulator_build"):
        emu = TorchEmulator.from_sequence(
            seq, noise_model=d.noise,
            evaluation_times=d.evaluation_times(seq.get_duration()),
            torch_device=d.device,
        )
    with d.spans("run"):
        res = emu.run()
    with d.spans("fetch"):
        state = np.asarray(res.states[-1].full()[:, 0])
    with d.spans("shots"):
        np.random.seed(job["np_seed"])
        shots = Counter(res.sample_final_state(int(d.traffic["shots"])))
    return {"final_state": state, "shots": shots}
