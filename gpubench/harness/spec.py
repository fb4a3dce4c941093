"""Finds a cell's pieces by name.

``BENCHMARK.json`` names the cells, configurations and metrics; each
piece is a file of its own under the benchmark's folder, so a cell or a
metric is added by adding files and entries:

- ``configs/<config>.json``: the configuration as it is run (the path is
  the configuration's ``file``);
- ``traffic/<traffic>.json``: the job mix, read by :mod:`.traffic`;
- ``entries/<entry>.py``: how a job of a traffic whose ``entry`` is
  that name enters the program (:mod:`.jobs`);
- ``waveforms/<kind>.py``: the samples of the program's waveform class
  ``kind``, as a configuration's pulses name it;
- ``reference/<config>.py``: the plain reference and the comparison;
- ``work/<config>.py``: the operations and bytes a job needs;
- ``metrics/<metric>.py``: the reader of a per-layer metric.

Modules are loaded from their files, so a copy of the folder with an
added file runs that file.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

HARNESS_DIR = "gpubench"


@dataclass
class Cell:
    root: str
    bench: dict
    workload: dict
    config: dict
    traffic: dict

    @property
    def name(self) -> str:
        return self.workload["name"]

    def end_to_end(self) -> list[dict]:
        return [m for m in self.bench["end_to_end"] if self._has(m)]

    def per_layer(self) -> list[dict]:
        return [m for m in self.bench["per_layer"] if self._has(m)]

    def _has(self, metric: dict) -> bool:
        return self.name in metric.get("workloads", [self.name])

    def phases(self, kind: str) -> list[str]:
        """The program's phase names of ``kind`` (``host_prep``,
        ``solve``), as the configuration lists them."""
        return list(self.config.get("phases", {}).get(kind, []))

    def module(self, kind: str, name: str):
        return load_module(self.root, kind, name)

    def reference(self):
        return self.module("reference", self.config["name"])

    def work(self):
        return self.module("work", self.config["name"])


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: str, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``.

    Raises:
        KeyError: No such cell, or its configuration is not listed.
    """
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[cell["config"]]["file"]))
    config["name"] = cell["config"]
    traffic = load_json(
        os.path.join(root, HARNESS_DIR, "traffic", f"{cell['traffic']}.json")
    )
    return Cell(root, bench, cell, config, traffic)


def load_module(root: str, kind: str, name: str):
    """The module ``<root>/gpubench/<kind>/<name>.py``, loaded by path."""
    path = os.path.join(root, HARNESS_DIR, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"gpubench_{kind}_{name}".replace(".", "_"), path
    )
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
