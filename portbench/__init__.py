"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

One cell (a model configuration under a traffic mix, named in the
repository's ``BENCHMARK.json``) runs once per process:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that defines the yardstick lives here, apart from the program:
the traffic generator and its mixes (``traffic/``), the configurations
(``configs/``), the plain float32 reference (``reference/``), the work
counts and peaks (``work.py``), the trace reduction (``devtrace.py``), one
reader per per-layer metric (``metrics/<name>.py``) and the comparison
that decides ``correct`` (``check.py``).  Nothing here imports ``jax`` or
the JAX package, and ``reference/`` imports nothing of the port.
"""
