"""Reference values of the six tutorials, computed by ``pulser_tpu``.

``chip_smoke.py`` runs the port's tutorials (``docs/tutorials_torch``)
on the card and holds the values of
``tools/build_tutorials_torch.py::KEY_VALUES`` against the ones this
script writes: the JAX package's tutorials (``docs/tutorials/src``), run
cell by cell on the CPU after ``np.random.seed(SEED)``, in single
precision, the quantum-jump batch on the row-batched kernel (Pallas
interpreter), as ``tools/noisy10_reference.py`` runs NOISY10. Seeded
draws then match the card's bit for bit where the port draws as the
JAX package does.

Run from the repository root (about a minute on a CPU)::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/tutorial_references.py \\
        > tests/goldens/tutorials_reference.json
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from tools import build_tutorials_torch as B  # noqa: E402
from tools.build_tutorials import SRC as JAX_SRC, parse_cells  # noqa: E402

#: The numpy seed set before each tutorial, here and on the card.
SEED = 1234

#: The JAX package's single-chip route for the quantum-jump batch (the
#: row-batched kernel, interpreted), as the port takes it.
JAX_ENV = {
    "PULSER_TPU_PALLAS_INTERPRET": "1",
    "PULSER_TPU_MCWF_ROWS": "1",
    "PULSER_TPU_DISABLE_SHARDING": "1",
}


def jax_namespace(name: str) -> dict:
    """Runs the JAX package's tutorial ``name`` cell by cell and returns
    its namespace. The caller sets :data:`JAX_ENV`, the precision and
    the numpy seed."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ns: dict = {"__name__": f"tutorial_{name}"}
    for kind, text in parse_cells(os.path.join(JAX_SRC, name + ".py")):
        if kind != "code":
            continue
        with contextlib.redirect_stdout(io.StringIO()):
            exec(compile(text, f"{name}.py", "exec"), ns)  # noqa: S102
        plt.close("all")
    return ns


def main() -> None:
    os.environ.update(JAX_ENV)
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    out: dict = {"seed": SEED, "tutorials": {}}
    for name in B.names():
        np.random.seed(SEED)
        ns = jax_namespace(name)
        out["tutorials"][name] = B.encode(B.KEY_VALUES[name](ns))
        print(f"{name}: done", file=sys.stderr, flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
