"""Runs one script of ``examples_torch/`` in a fresh interpreter.

The script runs with ``--device cpu`` (the tests have no card) through a
wrapper that, once the script has finished, prints on its last line the
modules of ``jax`` and of the JAX package that the run loaded: the port's
examples must load none.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WRAPPER = """
import json, runpy, sys
path = sys.argv[1]
sys.argv = sys.argv[1:]
runpy.run_path(path, run_name="__main__")
print(json.dumps(sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "pulser_tpu")
)))
"""


def run_example(
    example: str,
    timeout: int = 420,
    device: str | None = "cpu",
    extra: tuple[str, ...] = (),
):
    """``(returncode, stdout without the module line, stderr)``; with a
    return code of 0, also requires that no JAX module was loaded.
    ``extra`` are the script's own arguments."""
    args = [os.path.join(REPO, "examples_torch", example), *extra]
    if device is not None:
        args += ["--device", device]
    out = subprocess.run(
        [sys.executable, "-c", _WRAPPER, *args],
        capture_output=True,
        text=True,
        timeout=timeout,
        cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"),
    )
    if out.returncode != 0:
        return out.returncode, out.stdout, out.stderr
    body, _, last = out.stdout.rstrip("\n").rpartition("\n")
    assert json.loads(last) == [], f"{example} loaded {last}"
    return 0, body, out.stderr


def run_ok(example: str, timeout: int = 420) -> str:
    """The example's standard output; fails unless it exits with 0."""
    rc, stdout, stderr = run_example(example, timeout)
    assert rc == 0, stderr[-2000:]
    return stdout
