"""Serving a closed loop of clients through the program's ``ServeEngine``.

Set-up builds the model with the benchmark's weights and the engine, with
its page pool sized to the mix's share of the card's memory (what the
weights leave of it, less a reserve for the step's own buffers), and
serves one short request a slot (its warm-up captures the decode step in
a CUDA graph).  Then ``clients`` clients each send a request of the mix's
stream and, whenever one of theirs finishes, the next (the engine's
``on_done`` hook submits it), all in one ``ServeEngine.run``.  The loop
runs ``ramp_s`` seconds to reach its steady mix of requests in every
phase, which counts as set-up, then the window is measured for
``--seconds`` seconds, from quantum end to quantum end (a traced run
until its slices are done too), and the run is stopped there from the
engine's quantum hook.

Every time comes from this process's clock, stamped by the engine's
metrics hooks (``Stamps``): a request's submission, its first output token
on the host, its end; the output tokens each quantum folded.  The rate is
every output token of the window's quanta over the window; the tails are
over every request that finished in the window.  The engine's own summary
is not read.  A traced run profiles ``trace_slices`` slices of
``trace_slice_s`` seconds spread evenly over the window.
"""

from __future__ import annotations

import time
from collections import Counter

import numpy as np
import torch

from portbench import check as compare
from portbench import devtrace, load, traffic

from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.metrics import ServeMetrics


class WindowClosed(Exception):
    """Raised from the quantum hook to end ``ServeEngine.run`` once the
    window has closed."""


class Stamps(ServeMetrics):
    """The engine's metrics with the benchmark's own clock beside them.
    Quantum ``k`` is the ``k``-th ``note_quantum``; the tokens and ends
    folded after it are its own."""

    def __init__(self):
        super().__init__()
        self.sent: dict[int, float] = {}
        self.first: dict[int, float] = {}
        self.done: dict[int, float] = {}
        #: the quantum whose fold stamped each end
        self.done_q: dict[int, int] = {}
        self.quantum = -1
        #: output tokens that quantum k's fold produced, by k
        self.tokens: list[int] = []
        #: time of each note_quantum, and each quantum's device run (the
        #: engine's wall time of it), useful slot-steps and C
        self.noted: list[float] = []
        self.ran: list[float] = []
        self.useful: list[int] = []
        self.chunks: list[int] = []
        self.on_quantum = None
        self.on_finish = None

    def restart(self) -> None:
        """Count quanta from 0 again (after set-up's warm-up)."""
        self.quantum = -1
        self.done_q.clear()
        for seq in (self.tokens, self.noted, self.ran, self.useful,
                    self.chunks):
            seq.clear()

    def on_submit(self, rid: int, n_prompt: int, n_new: int) -> None:
        super().on_submit(rid, n_prompt, n_new)
        self.sent[rid] = time.perf_counter()

    def on_first_token(self, rid: int) -> None:
        super().on_first_token(rid)
        self.first.setdefault(rid, time.perf_counter())

    def on_generated(self, rid: int, n: int = 1) -> None:
        super().on_generated(rid, n)
        if self.quantum >= 0:
            self.tokens[self.quantum] += n

    def on_done(self, rid: int) -> None:
        super().on_done(rid)
        self.done[rid] = time.perf_counter()
        self.done_q[rid] = self.quantum
        if self.on_finish is not None:
            self.on_finish(rid)

    def note_quantum(self, wall_s: float, chunk: int, useful_steps: int,
                     slots: int) -> None:
        super().note_quantum(wall_s, chunk, useful_steps, slots)
        now = time.perf_counter()
        if self.on_quantum is not None:
            # may raise WindowClosed: this quantum is then not counted
            self.on_quantum(now, len(self.noted))
        self.quantum = len(self.noted)
        self.noted.append(now)
        self.ran.append(wall_s)
        self.tokens.append(0)
        self.useful.append(useful_steps)
        self.chunks.append(chunk)


def p95(values: list[float]) -> float:
    """The 95th percentile by nearest rank: the smallest value with at
    least 95% of all values at or below it."""
    xs = sorted(values)
    return xs[max(0, -(-95 * len(xs) // 100) - 1)]


def summarize(records: list[tuple[int, float, float, float]], tokens: int,
              wall_s: float) -> dict[str, float]:
    """The window's end-to-end metrics: ``tokens`` output tokens over the
    window's ``wall_s``, and the 95th percentiles, over the requests that
    finished in the window ((output tokens, sent, first token, done) on one
    clock), of the time to the first token and of the time per later
    token."""
    ttft = [f - s for _, s, f, _ in records]
    tpot = [(d - f) / (n - 1) for n, _, f, d in records if n > 1]
    return {"serve_tok_s": tokens / wall_s,
            "ttft_p95_ms": p95(ttft) * 1e3 if ttft else float("nan"),
            "tpot_p95_ms": p95(tpot) * 1e3 if tpot else float("nan")}


def pool_pages(mix: dict, model, device: torch.device) -> int | None:
    """Pages of the mix's share of the card's memory, less what the model
    holds and the reserve; None (the engine's default, a full chain a
    slot) off a card."""
    if device.type != "cuda":
        return None
    a = model.cfg
    page_bytes = (2 * a.n_layers * mix["page_size"] * a.n_kv_heads
                  * a.d_head * model.dtype.itemsize)
    total = torch.cuda.get_device_properties(device).total_memory
    room = (mix["memory_share"] * total - torch.cuda.memory_allocated(device)
            - mix["reserve_gb"] * 1e9)
    return int(room // page_bytes)


def _ms(xs: list[float]) -> str:
    """min / median / max of ``xs`` seconds, in ms."""
    if not xs:
        return "-"
    q = sorted(xs)
    return (f"{q[0] * 1e3:.2f} / {q[len(q) // 2] * 1e3:.2f} / "
            f"{q[-1] * 1e3:.2f} ms")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(rc) -> dict:
    conf, mix, seed = rc.conf, rc.mix, rc.seed
    arch, device = conf["arch"], rc.device
    model = load.build_model(conf, seed, device)
    stamps = Stamps()
    eng = ServeEngine(model, slots=mix["slots"], max_seq=mix["max_seq"],
                      page_size=mix["page_size"],
                      n_pages=pool_pages(mix, model, device),
                      schedule=mix["schedule"], metrics=stamps)
    # each quantum's plan (steps, pos by slot), by quantum
    plans: list[tuple[np.ndarray, np.ndarray]] = []
    step_load = eng.step.load

    def load_plan(table, tokens, n_in, steps, pos):
        plans.append((steps.copy(), pos.copy()))
        step_load(table, tokens, n_in, steps, pos)

    eng.step.load = load_plan
    for prompt, n in traffic.warmup_requests(mix, arch["vocab_size"], seed):
        eng.submit(prompt, n)
    eng.run()
    del plans[:]
    stamps.restart()
    if rc.trace and device.type == "cuda":
        devtrace.Tracer.warm()

    stream = traffic.serve_stream(mix, arch["vocab_size"], seed)
    asked: dict[int, tuple[np.ndarray, int]] = {}

    def send(_rid=None):
        prompt, n = next(stream)
        asked[eng.submit(prompt, n)] = (prompt, n)

    # window: first counted quantum and its start; slices: (quanta, tracer)
    win: dict = {}
    slices: list[list] = []
    tracer_s = [0.0]
    starts = [(i + 0.5) * rc.seconds / mix["trace_slices"]
              - 0.5 * mix["trace_slice_s"]
              for i in range(mix["trace_slices"])] if rc.trace else []

    def on_quantum(now: float, k: int) -> None:
        # quanta 0..k-1 are folded; quantum k's steps have run
        if "k0" not in win:
            if now - loop_start >= mix["ramp_s"]:
                win.update(k0=k, t0=stamps.noted[k - 1] if k else loop_start)
            return
        t0 = win["t0"]
        # past the window's length: a traced run first finishes its slices
        done = stamps.noted[k - 1] - t0 >= rc.seconds and k > win["k0"]
        c0 = time.perf_counter()
        if slices and slices[-1][1].active and (done or now - t0 >= starts[
                len(slices) - 1] + mix["trace_slice_s"]):
            slices[-1][1].stop()
            slices[-1][0] = (slices[-1][0], k + 1)
        elif len(slices) < len(starts) and not (
                slices and slices[-1][1].active) and (
                done or now - t0 >= starts[len(slices)]):
            tr = devtrace.Tracer()
            tr.start()
            slices.append([k + 1, tr])
        tracer_s[0] += time.perf_counter() - c0
        if done and len(slices) == len(starts) and not (
                slices and slices[-1][1].active):
            win.update(k1=k, t1=stamps.noted[k - 1])
            raise WindowClosed

    _sync(device)
    loop_start = time.perf_counter()
    stamps.on_quantum = on_quantum
    stamps.on_finish = send
    for _ in range(mix["clients"]):
        send()
    try:
        eng.run()
        raise RuntimeError("the clients' stream ran dry before the window "
                           "closed")
    except WindowClosed:
        pass
    stamps.on_quantum = stamps.on_finish = None
    if slices and slices[-1][1].active:
        slices[-1][1].stop()
        slices[-1][0] = (slices[-1][0], win["k1"] + 1)
    del eng.step.load         # the patch refers back to the step
    k0, k1 = win["k0"], win["k1"]
    wall = win["t1"] - win["t0"]
    results = eng.results
    finished = [rid for rid, q in stamps.done_q.items() if k0 <= q < k1]
    failed = sum(1 for rid in finished
                 if len(results.get(rid, ())) != asked[rid][1])
    # the host's time from one quantum's end to the next one's start
    host = [stamps.noted[k] - stamps.noted[k - 1] - stamps.ran[k]
            for k in range(max(k0, 1), k1)]
    records = [(len(results[rid]), stamps.sent[rid], stamps.first[rid],
                stamps.done[rid]) for rid in finished if rid in results]
    res = {
        "e2e": dict(summarize(records, sum(stamps.tokens[k0:k1]), wall),
                    setup_s=win["t0"] - rc.t_start),
        "attempted": len(finished), "failed": failed,
        "peak_bytes": (torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else 0),
        "notes": [f"window: {k1 - k0} quanta, C by quanta "
                  f"{dict(sorted(Counter(stamps.chunks[k0:k1]).items()))}, "
                  f"{sum(stamps.tokens[k0:k1])} output tokens in "
                  f"{wall:.3f} s, {len(finished)} requests finished, "
                  f"{len(asked)} sent, pool {eng.cache_cfg.n_pages} pages; "
                  f"a quantum's run {_ms(stamps.ran[k0:k1])}, the host "
                  f"between quanta {_ms(host)}"],
    }
    if slices:
        hp = model.flat["layers/w_q"].shape[-1] // arch["head_dim"]
        traced = [p for (a, b), _ in slices for p in plans[a:b]]
        res["trace"] = devtrace.merge([tr.reduce() for _, tr in slices])
        res["obs"] = {
            "arch": arch, "itemsize": model.dtype.itemsize, "hp": hp,
            "slots": mix["slots"],
            # the window's quanta, less the profiler's own starts and stops
            "window_wall_s": wall - tracer_s[0],
            "window_plans": plans[k0:k1],
            "useful": sum(stamps.useful[k0:k1]),
            "output_tokens": sum(stamps.tokens[k0:k1]),
            # the traced slices' quanta
            "plans": traced,
            "traced_steps": sum(int(s.max(initial=0)) for s, _ in traced),
        }
    # the check's sample: the longest finished request and others drawn
    # from the seed, with what the engine served them
    done = sorted(rid for rid in results if rid in asked)
    rng = np.random.default_rng(seed)
    pick = []
    if done:
        longest = max(done, key=lambda r: len(asked[r][0]) + asked[r][1])
        others = [done[i] for i in rng.permutation(len(done))
                  if done[i] != longest]
        pick = [longest] + others[:mix["check_requests"] - 1]
    res["sample"] = [(torch.from_numpy(asked[r][0].astype(np.int64)),
                      torch.from_numpy(results[r].astype(np.int64)))
                     for r in pick]
    return res


def check(rc, res: dict) -> dict[str, float]:
    return compare.serve_gaps(rc.conf["arch"], rc.seed, rc.device,
                              res["sample"])
