"""``docs/API_torch.md`` is what ``tools/gen_api_docs_torch.py`` writes
today: rendered in a fresh interpreter (which loads no JAX module), it
equals the committed page."""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RENDER = """
import json, sys
from tools.gen_api_docs_torch import render
text = render()
print(json.dumps({"text": text, "foreign": sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "pulser_tpu")
)}))
"""


def test_api_page_regenerates_unchanged():
    out = subprocess.run(
        [sys.executable, "-c", _RENDER],
        capture_output=True,
        text=True,
        timeout=120,
        cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["foreign"] == []
    with open(os.path.join(ROOT, "docs", "API_torch.md")) as f:
        want = f.read()
    assert got["text"] == want, "run python tools/gen_api_docs_torch.py"
    for name in ("WeightedAnalogDevice", "HamiltonianData", "sesolve_rk4"):
        assert name in got["text"], name
