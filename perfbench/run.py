"""Run one cell of the port's benchmark once, on this machine's card.

    python3 perfbench/run.py --workload logreg_paper.w64 --seed 7 \
        --seconds 30 --trace 0

Run from the root of a checkout.  The last line of standard output is the
run's result, one JSON object; standard error ends with each number that
decided ``correct``, beside its limit.  Exits 2 without a CUDA card (or
without the program), 3 when JAX or the JAX package was loaded.  The
program's kernels build into ``build/torch_kernels`` inside the checkout,
once; the run's rows go under ``TMPDIR`` and are removed.
"""
import os
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path.pop(0)
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
# every build and kernel cache at a fixed place inside the checkout
os.environ["REPRO_TORCH_BUILD_DIR"] = os.path.join(ROOT, "build",
                                                   "torch_kernels")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["USE_FLAX"] = "0"

from perfbench.harness import bench  # noqa: E402

if __name__ == "__main__":
    sys.exit(bench.main(sys.argv[1:], t_start=T_START))
