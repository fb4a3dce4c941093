"""A job through the Pulser v1 backend API: numpy seeded with the job's
seed, ``build(**values)``, then ``TorchBackendV2(seq,
config=TorchConfig(observables=..., noise_model=...)).run()``; the
observables' values come back, as the traffic's ``observables`` list
them (``kind``: the program's observable class; ``times``: relative
times, or a count of evenly spaced ones; ``num_shots`` where it has
shots)."""

from collections import Counter

import numpy as np


def _observables(P, specs: list):
    out = []
    for s in specs:
        times = s["times"]
        if isinstance(times, int):
            times = np.linspace(0.0, 1.0, times)
        kw = {"num_shots": s["num_shots"]} if "num_shots" in s else {}
        out.append(getattr(P, s["kind"])(evaluation_times=list(times), **kw))
    return out


def run(d, job: dict) -> dict:
    from pulser_tpu_torch import TorchBackendV2, TorchConfig

    np.random.seed(job["np_seed"])
    seq = d.build(job)
    with d.spans("run"):
        backend = TorchBackendV2(
            seq,
            config=TorchConfig(
                observables=_observables(d.P, d.traffic["observables"]),
                noise_model=d.noise,
                torch_device=d.device,
            ),
        )
        res = backend.run()
    with d.spans("fetch"):
        out = {}
        for s in d.traffic["observables"]:
            tag = s["tag"]
            values = getattr(res, tag)
            if tag == "bitstrings":
                out[tag] = [Counter(v) for v in values]
            else:
                out[tag] = np.asarray([np.asarray(v, dtype=float) for v in values])
    return out
