"""The benchmark's command: one run of one cell of `BENCHMARK.json`.

    python3 portbench/run.py --workload gpt2-124m.train --seed 7 \\
        --seconds 20 --trace 0

(or `python3 -m portbench.run ...` from the checkout's root).  The last
line of standard output is the result's JSON object; the numbers that
decided `correct` are the last lines of standard error.  The process
start is the start of `setup_s`.  Build and kernel caches go under the
checkout: the program's CUDA libraries to `vitrs_tpu_torch/_build/` (its
own fixed directory), anything Triton, PyTorch extensions or CUDA's JIT
would cache to `.portbench_cache/`.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _environment():
    cache = os.path.join(ROOT, ".portbench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)
    # run as a script, this folder heads sys.path: the package's root
    # takes its place, so that its modules import as portbench.*
    sys.path[:] = [ROOT] + [p for p in sys.path
                            if os.path.abspath(p or ".") not in (HERE, ROOT)]


if __name__ == "__main__":
    _environment()
    from portbench import harness
    sys.exit(harness.main(sys.argv[1:], T_START))
