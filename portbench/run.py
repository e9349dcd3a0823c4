"""The benchmark of the PyTorch port (``src/repro_torch``), one run of one
cell:

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

run from the root of a checkout. It prints the cell's metrics and whether
the window's answers held against the plain reference as the last line of
its standard output (``pbench/harness.py``). Build and kernel caches stay
in fixed directories inside the checkout.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [os.path.join(ROOT, "src"), HERE]

from pbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
