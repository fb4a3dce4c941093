"""The benchmark of pulser_tpu_torch on one NVIDIA card.

Run from the root of a checkout::

    python gpubench/run.py --workload afm16.sweep --seed 1 --seconds 20 --trace 0

It prints one JSON line last: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, traced, ``breakdown``; then the numbers
the check compared, each with its limit. Without a CUDA card it exits 2
and prints no result. See ``gpubench/harness/main.py``.
"""

import os
import sys
import time

T_PROCESS = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# One process, one thread of host math: steadier runs on a host whose
# cores other machines share (and faster: the host's arrays are small)
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from gpubench.harness.main import run

    sys.exit(run(sys.argv[1:], t_process=T_PROCESS, root=ROOT))
