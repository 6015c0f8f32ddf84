"""The traced run's device timeline, from ``torch.profiler``.

A traced slice runs between ``start`` and ``stop``; ``reduce`` turns the
profiler's events into what the per-layer readers and the result line
take, and ``merge`` sums the slices of one run: the device's operations (kernels, copies, fills) with their times,
the seconds in which one ran (``busy_s``, their union), the slice's
length (``window_s``), the operations that took most time, and the idle
gaps by what the host was doing (the innermost host operation open at
the gap's middle).
"""

from __future__ import annotations

import bisect

import torch
from torch.profiler import ProfilerActivity, profile, record_function

MARK = "portbench.traced"
#: gaps shorter than this are counted in the idle share and not labelled
LABEL_GAP_S = 20e-6


def kind_of(name: str) -> str:
    """The kind of a profiled kernel, by its name (as ``chip_smoke.py``'s
    classifier when the benchmark was defined)."""
    return ("grouped expert FFN backward" if "ffn_bwd" in name
            else "grouped expert FFN" if "ffn_up" in name
            or "ffn_down" in name
            else "flash carry step" if "flash_fwd" in name
            and "true>" in name
            else "flash block backward" if "flash_bwd_wgmma" in name
            and "true>" in name
            else "flash backward" if "flash_bwd" in name
            or "flash_dsum" in name or "to_bf16_kernel" in name
            else "flash forward" if "flash_" in name
            else "paged attention" if "paged" in name
            else "GEMM" if any(t in name for t in ("nvjet", "gemm", "xmma",
                                                   "cutlass", "Kernel2"))
            else "copies" if "copy" in name or "Memcpy" in name
            else "other elementwise, sorts and reductions")


class Tracer:
    """One traced slice of a run."""

    def __init__(self):
        self.prof = None
        self._mark = None
        #: "idle", then "on" while the slice runs, then "off"
        self.state = "idle"

    @staticmethod
    def warm() -> None:
        """Start and stop the profiler once, in set-up: its first start
        initialises the device tracer."""
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self._mark = record_function(MARK)
        self._mark.__enter__()
        self.state = "on"

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self.prof.stop()
        self.state = "off"

    @property
    def active(self) -> bool:
        return self.state == "on"

    def reduce(self) -> dict:
        """The slice's device timeline (see the module's docstring)."""
        dev, host, window = [], [], None
        for e in self.prof.profiler.kineto_results.events():
            start, dur = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
            if e.device_type().name == "CUDA":
                # the device's side of a host annotation is no operation
                note = getattr(e, "is_user_annotation", None)
                if e.name() != MARK and not (note is not None and note()):
                    dev.append((e.name(), start, dur))
            elif e.name() == MARK:
                window = (start, start + dur)
            else:
                host.append((start, start + dur, e.name()))
        if window is None:
            raise RuntimeError("the traced slice's mark is missing")
        w0, w1 = window
        ops: dict[str, float] = {}
        spans = []
        for name, s, d in dev:
            s0, s1 = max(s, w0), min(s + d, w1)
            if s1 > s0:
                ops[name] = ops.get(name, 0.0) + (s1 - s0)
                spans.append((s0, s1))
        spans.sort()
        busy, gaps, cur = 0.0, [], None
        edge = w0
        for s0, s1 in spans:
            if cur is None or s0 > cur[1]:
                if cur is not None:
                    busy += cur[1] - cur[0]
                gaps.append((edge, s0))
                cur = [s0, s1]
            else:
                cur[1] = max(cur[1], s1)
            edge = cur[1]
        if cur is not None:
            busy += cur[1] - cur[0]
        gaps.append((edge, w1))
        return {"ops": ops, "busy_s": busy, "window_s": w1 - w0,
                "idle": _label_gaps(gaps, host)}


def _label_gaps(gaps: list[tuple[float, float]],
                host: list[tuple[float, float, str]]) -> dict[str, float]:
    """Idle seconds by the innermost host operation open at each gap's
    middle ("python, no traced operation" where none is)."""
    host.sort()
    starts = [h[0] for h in host]
    out: dict[str, float] = {}
    for g0, g1 in gaps:
        if g1 - g0 <= 0:
            continue
        if g1 - g0 < LABEL_GAP_S:
            name = "gaps under 20 us"
        else:
            mid = 0.5 * (g0 + g1)
            name = "python, no traced operation"
            i = bisect.bisect_right(starts, mid) - 1
            while i >= 0:
                if host[i][1] >= mid:
                    name = host[i][2]
                    break
                i -= 1
        out[name] = out.get(name, 0.0) + (g1 - g0)
    return out


def merge(slices: list[dict]) -> dict:
    """The reductions of several slices as one: times summed by operation,
    by idle cause, busy and in all."""
    out = {"ops": {}, "busy_s": 0.0, "window_s": 0.0, "idle": {}}
    for r in slices:
        for key in ("ops", "idle"):
            for name, s in r[key].items():
                out[key][name] = out[key].get(name, 0.0) + s
        out["busy_s"] += r["busy_s"]
        out["window_s"] += r["window_s"]
    return out


def breakdown(reduced: dict) -> dict[str, list]:
    """The ten device operations that took most time, each named "<kind>:
    <kernel>", and the ten largest idle causes, as the result line's
    ``breakdown``."""
    ops = sorted(reduced["ops"].items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(reduced["idle"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[f"{kind_of(n)}: {n}"[:160], s] for n, s in ops],
            "idle_gaps": [[n[:160], s] for n, s in idle]}


def time_of(reduced: dict, pred) -> float:
    """Seconds of the slice's device operations whose name ``pred``
    accepts."""
    return sum(s for n, s in reduced["ops"].items() if pred(n))
