"""Managed serving runtime: continuous batching over a paged KV cache.

The MDMP loop applied to serving: the scheduler's batching decisions are
the declared "messages", serve/metrics.py's step-latency counters are the
runtime instrumentation, and core/cost_model.py::decide_serve_schedule
turns iteration-k measurements into the iteration-(k+1) schedule.
"""

from repro_torch.serve.engine import ServeEngine                    # noqa: F401
from repro_torch.serve.kv_cache import PagedCacheConfig, PageTable  # noqa: F401
from repro_torch.serve.metrics import ServeMetrics                  # noqa: F401
from repro_torch.serve.scheduler import Request, ServeScheduler     # noqa: F401
