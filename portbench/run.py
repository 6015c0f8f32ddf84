"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It needs as many CUDA cards as the cell asks for, and exits with another
code than 0, printing no result, where it finds fewer.  The program's
kernel builds and every cache it writes stay under ``build/`` in the
checkout.
"""

import time

T_IMPORT = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

if __name__ == "__main__":
    sys.path[:] = [p for p in sys.path
                   if os.path.abspath(p or os.curdir) != HERE]
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(ROOT, "build", "portbench", sub)
    from portbench.harness import main
    sys.exit(main(sys.argv[1:], T_IMPORT))
