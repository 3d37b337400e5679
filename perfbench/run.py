"""Benchmark of the port's detector datapath on one H100: the driver's entry.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Prints the run's result as one JSON
object on the last line of standard output (``--trace 0``: the cell's
end-to-end metrics; ``--trace 1``: its per-layer metrics and the trace's
breakdown), and the numbers compared with the reference, each beside its
limit, as the last lines of standard error.  Exits non-zero, printing no
result, without a CUDA device.  Every cache of the program lies at a
fixed path inside the checkout (``build/``).
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# one host thread for numpy's and torch's CPU work: the inputs' synthesis is
# single-threaded by design, and the host issuing the forward shares its cores
for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv_compute_cache")):
    os.environ[var] = str(ROOT / "build" / "perfbench" / sub)
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

if __name__ == "__main__":
    from perfbench import harness

    sys.exit(harness.main(sys.argv[1:], t_start=T_START))
