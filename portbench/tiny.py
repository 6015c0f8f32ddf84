"""Cells at a size that a CPU test holds: the benchmark's own cells with
their widths, depth, vocabulary and traffic cut down, run on the CPU
through the same harness (``harness.execute``).  The model pads 6 query
heads to 8 over 2 key and value heads, as phi4-mini's pads 24 to 32 over
8."""

from __future__ import annotations

import copy
import time

import torch

from portbench import harness

#: a test run's window: some tens of finished requests on the CPU
SECONDS = 0.3


def confs(dtype: str = "float32") -> dict[str, tuple[dict, dict, dict]]:
    """name -> (cell, configuration, mix) of the benchmark's cells cut to
    test size."""
    spec = harness.load_spec()
    out = {}
    for cell in spec["workloads"]:
        cell, conf, mix = harness.cell_inputs(spec, cell["name"])
        conf, mix = copy.deepcopy(conf), copy.deepcopy(mix)
        a = conf["arch"]
        a.update(n_layers=2, d_model=64, head_dim=16, vocab_size=512,
                 dtype=dtype, n_heads=6, n_kv_heads=2, d_ff=96,
                 tp_multiple=8)
        mix.update(slots=4, clients=4, page_size=4, max_seq=24, block=8,
                   warmup_prompt=3, warmup_output=2, check_requests=6,
                   ramp_s=0.0, trace_slices=2, trace_slice_s=0.0)
        mix["prompt"].update(mean=6.0, max=12)
        mix["output"].update(mean=5.0)
        out[cell["name"]] = (cell, conf, mix)
    return out


def run(name: str, seed: int = 7, *, dtype: str = "float32",
        trace: bool = False, seconds: float = SECONDS, guard: bool = False
        ) -> tuple[dict | None, list]:
    """One run of a test-size cell on the CPU: (result line, standard
    error lines)."""
    cell, conf, mix = confs(dtype)[name]
    rc = harness.RunContext(cell=cell, conf=conf, mix=mix, seed=seed,
                            seconds=seconds, trace=trace,
                            device=torch.device("cpu"),
                            t_start=time.perf_counter())
    return harness.execute(harness.load_spec(), rc, guard=guard)
