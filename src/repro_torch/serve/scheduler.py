"""Continuous-batching scheduler — admission, preemption, shedding.

Pure host logic (numpy only): the engine owns the device arrays, the
scheduler decides WHAT each quantum does.  Every engine step advances
each active slot by one token — a slot still consuming its prompt is
"chunked prefill", a slot past it is decoding — so the prefill:decode
mix of a step is exactly the mix of slot phases, and the scheduler
controls it through admission.

The request lifecycle under load:

  submit      — feasibility first: a request whose page need exceeds the
                whole pool (or the table width) can never run and is
                rejected with the typed ``RequestRejected`` instead of
                livelocking admission; a full pending queue
                (``max_queue``) or a cost-model TTFT estimate beyond the
                request's SLO sheds it with ``RequestShed`` —
                backpressure and graceful degradation, never a crash.
  admit       — watermark-based OPTIMISTIC admission: only the prompt's
                pages are committed up front (decode pages are claimed
                on demand as positions cross page boundaries), so
                occupancy rises well above the old upfront
                prompt+max_new reservation.  ``admission="commit"``
                keeps the conservative reservation (the seed baseline).
  preempt     — the backstop for optimistic admission: when the pool
                exhausts mid-decode (``PagePoolExhausted``), the engine
                picks a victim (most pages held, then least progress)
                and either swaps its page chain to host, drops it for
                prefill-replay (``continuation`` — the drain() idiom),
                or stalls the growing slot for a quantum — the policy
                is a managed decision (``managed.resolve_preempt``,
                ``DecisionRecord(op="preempt_policy")``).
  retire      — finished requests return slot + pages to the free lists
                at quantum boundaries (continuous mode refills them
                immediately).

The batching knobs (mode + scheduling quantum C) come from
``managed.resolve_serve_schedule``: seeded from the alpha-beta serve
model, re-resolved mid-run with the measured step/dispatch seconds from
serve/metrics.py.  Every resolve lands in the MDMP decision log.  (The
reference can also pin a ``ScheduleTuner``'s measured winner; the port's
tuner comes with a later slice.)

  static      — admit a wave, run it to completion, admit the next wave
                (the unmanaged baseline = the seed Generator's behaviour:
                every request pads to the wave's longest).
  continuous  — refill freed slots from the queue at every quantum
                boundary; pages released by finished requests are reused
                immediately (kv_cache.py free list).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any

import numpy as np

from repro_torch.core import managed
from repro_torch.serve.kv_cache import PageTable
from repro_torch.serve.metrics import ServeMetrics


class RequestRejected(RuntimeError):
    """The request can NEVER be served by this pool/table geometry —
    rejected at submit() instead of livelocking admission forever."""


class RequestShed(RequestRejected):
    """The request was shed by admission control: the pending queue is
    full (backpressure) or the queue-wait estimate exceeds its TTFT SLO.
    Typed so callers degrade gracefully — overload never crashes."""


@dataclasses.dataclass(frozen=True)
class Request:
    rid: int
    prompt: np.ndarray            # [P] int32
    max_new: int
    ttft_slo_s: float | None = None   # per-request TTFT target

    @property
    def total_steps(self) -> int:
        """Engine steps to finish: feed P prompt tokens, sample max_new
        (the P-th input's output is the first generated token)."""
        return len(self.prompt) + self.max_new - 1


@dataclasses.dataclass
class RequestState:
    req: Request
    slot: int
    consumed: int = 0             # engine steps done (= cache positions)
    last_out: int = 0             # last sampled token (chain seed)
    generated: list[int] = dataclasses.field(default_factory=list)
    committed: int = 0            # pages committed at admission

    @property
    def done(self) -> bool:
        return self.consumed >= self.req.total_steps


@dataclasses.dataclass(frozen=True)
class QuantumPlan:
    """Device inputs for one dispatched quantum of C engine steps."""
    tokens: np.ndarray            # [slots, C] int32 input-token buffer
    n_in: np.ndarray              # [slots] provided input tokens (>= 1)
    pos: np.ndarray               # [slots] starting positions
    steps: np.ndarray             # [slots] valid steps this quantum
    chunk: int


class ServeScheduler:
    def __init__(self, slots: int, *, schedule: str = "auto",
                 chunk: int | None = None,
                 axis_name: str = "serve", cache_cfg: Any = None,
                 admission: str = "watermark", watermark: int = 0,
                 slo_ttft_s: float | None = None,
                 max_queue: int | None = None,
                 model_step_s: float | None = None):
        if schedule not in ("auto", "static", "continuous"):
            raise ValueError(f"unknown schedule {schedule!r}")
        if admission not in ("watermark", "commit"):
            raise ValueError(f"unknown admission {admission!r}")
        self.slots = slots
        self.schedule = schedule
        self._pinned_chunk = chunk
        self.axis_name = axis_name
        self.cache_cfg = cache_cfg
        self.admission = admission
        self.watermark = int(watermark)
        self.slo_ttft_s = slo_ttft_s
        self.max_queue = max_queue
        self.model_step_s = model_step_s
        self.pending: deque[Request] = deque()
        self.active: dict[int, RequestState] = {}
        self._free_slots = list(range(slots - 1, -1, -1))
        self._committed_pages = 0
        #: rid -> pages an evicted (swapped) request needs back before
        #: re-admission (set by the engine's swap path)
        self.restore_pages: dict[int, int] = {}
        self.mode: str | None = None
        self.chunk: int | None = None
        self.decision = None

    # -- the managed decision ------------------------------------------------

    def decide(self, n_params: int, dtype_bytes: int, *,
               measured_step_s: float | None = None,
               measured_dispatch_s: float | None = None) -> None:
        """(Re-)resolve the batching mode and quantum from the queue's
        statistics — seeded from the cost model, corrected by measured
        step latencies, logged in the MDMP decision trail."""
        reqs = list(self.pending) + [s.req for s in self.active.values()]
        if not reqs:
            return
        prompts = [len(r.prompt) for r in reqs]
        news = [r.max_new for r in reqs]
        pin_mode = None if self.schedule == "auto" else self.schedule
        pin_chunk = self._pinned_chunk
        self.decision = managed.resolve_serve_schedule(
            self.axis_name, self.slots, float(np.mean(prompts)),
            float(np.mean(news)), float(n_params),
            dtype_bytes=dtype_bytes, max_prompt=float(np.max(prompts)),
            measured_step_s=measured_step_s,
            measured_dispatch_s=measured_dispatch_s,
            schedule=pin_mode, chunk=pin_chunk)
        self.mode = self.decision.mode
        self.chunk = self.decision.chunk

    # -- queue wait / SLO estimates ------------------------------------------

    def step_s_hint(self, metrics: ServeMetrics | None = None
                    ) -> float | None:
        """Best available per-engine-step seconds: measured if any quanta
        have run, else the roofline seed the engine installed."""
        step = metrics.step_s_estimate() if metrics is not None else None
        return step if step is not None else self.model_step_s

    def estimate_queue_wait_s(self, metrics: ServeMetrics | None = None
                              ) -> float | None:
        """Head-of-line wait for a NEW request: the backlog's remaining
        engine steps spread over the slots at the current step rate —
        the instrumented queue statistic the shed decision prices."""
        step = self.step_s_hint(metrics)
        if step is None:
            return None
        backlog = sum(rs.req.total_steps - rs.consumed
                      for rs in self.active.values())
        backlog += sum(r.total_steps for r in self.pending)
        return backlog * step / max(1, self.slots)

    def estimate_ttft_s(self, req: Request,
                        metrics: ServeMetrics | None = None
                        ) -> float | None:
        wait = self.estimate_queue_wait_s(metrics)
        step = self.step_s_hint(metrics)
        if wait is None or step is None:
            return None
        return wait + len(req.prompt) * step

    # -- queue ---------------------------------------------------------------

    def submit(self, req: Request, metrics: ServeMetrics | None = None
               ) -> None:
        """Admission control at the queue door: feasibility (typed
        ``RequestRejected``), backpressure and SLO shedding (typed
        ``RequestShed``) — then enqueue."""
        if len(req.prompt) < 1 or req.max_new < 1:
            raise ValueError(f"request {req.rid} needs a prompt and "
                             f"max_new >= 1: {req}")
        cfg = self.cache_cfg
        if cfg is not None:
            need = cfg.pages_needed(req.total_steps)
            if need > cfg.max_pages_per_seq:
                raise RequestRejected(
                    f"request {req.rid} needs {need} pages "
                    f"> {cfg.max_pages_per_seq}-page table (max_seq)")
            if need > cfg.n_pages:
                raise RequestRejected(
                    f"request {req.rid} needs {need} pages > the whole "
                    f"{cfg.n_pages}-page pool — it can never be admitted")
        if self.max_queue is not None \
                and len(self.pending) >= self.max_queue:
            if metrics is not None:
                metrics.on_shed(req.rid, "queue_full")
            raise RequestShed(
                f"request {req.rid} shed: pending queue at max_queue="
                f"{self.max_queue}")
        slo = req.ttft_slo_s if req.ttft_slo_s is not None \
            else self.slo_ttft_s
        if slo is not None:
            est = self.estimate_ttft_s(req, metrics)
            if est is not None and est > slo:
                if metrics is not None:
                    metrics.on_shed(req.rid, "slo")
                raise RequestShed(
                    f"request {req.rid} shed: estimated TTFT "
                    f"{est * 1e3:.1f}ms > SLO {slo * 1e3:.1f}ms")
        self.pending.append(req)
        if metrics is not None:
            metrics.on_submit(req.rid, len(req.prompt), req.max_new)

    def has_work(self) -> bool:
        return bool(self.pending or self.active)

    # -- admission -----------------------------------------------------------

    def admit(self, pt: PageTable,
              hold: frozenset[int] | set[int] = frozenset()
              ) -> list[RequestState]:
        """Move queued requests into free slots (page-budget permitting).
        Static mode only admits into an EMPTY batch — the wave barrier.

        Watermark admission commits only the pages the head request needs
        to START (its prompt — or its restored chain for a swapped-out
        victim); decode growth is claimed on demand, the preemption path
        is the backstop.  Commit admission reserves prompt+max_new up
        front (the conservative seed behaviour, kept as a baseline).

        ``hold`` rids stop admission at the head of the queue: a freshly
        evicted victim must not re-enter the batch before the quantum
        that its pages were freed FOR has dispatched, or eviction and
        re-admission chase each other without progress."""
        if self.mode == "static" and self.active:
            return []
        newly: list[RequestState] = []
        while self.pending and self._free_slots:
            req = self.pending[0]
            if req.rid in hold:
                break                     # evicted this round: not yet
            if self.admission == "commit":
                need = pt.cfg.pages_needed(len(req.prompt) + req.max_new)
                if self._committed_pages + need > pt.usable_pages:
                    break                 # no page budget: wait for frees
            else:
                need = max(pt.cfg.pages_needed(len(req.prompt)),
                           self.restore_pages.get(req.rid, 0))
                if pt.free_pages < need + self.watermark:
                    break                 # below the watermark: wait
            self.pending.popleft()
            slot = self._free_slots.pop()
            rs = RequestState(req=req, slot=slot, committed=need)
            self.active[slot] = rs
            self._committed_pages += need
            newly.append(rs)
        return newly

    # -- preemption ----------------------------------------------------------

    def select_victim(self, pt: PageTable,
                      prefer_not: int | None = None) -> int | None:
        """Pick the slot to evict when the pool exhausts: most pages held
        first (frees the most), then least progress (cheapest to replay),
        then lowest slot — deterministic.  ``prefer_not`` (the slot that
        needs to grow) only loses its immunity when it is the sole
        candidate."""
        cands = [(pt.pages_held(s), -rs.consumed, -s)
                 for s, rs in self.active.items()
                 if pt.pages_held(s) > 0 and s != prefer_not]
        if not cands and prefer_not in self.active \
                and pt.pages_held(prefer_not) > 0:
            return prefer_not
        if not cands:
            return None
        return -max(cands)[2]

    def preempt(self, slot: int, pt: PageTable) -> RequestState:
        """Evict ``slot``: release its page chain, free the slot, and
        hand its state back to the engine (which swaps or rebuilds it).
        The victim is NOT requeued here — the policy decides how."""
        rs = self.active.pop(slot)
        pt.release(slot)
        self._free_slots.append(slot)
        self._committed_pages -= rs.committed
        return rs

    def requeue_front(self, req: Request) -> None:
        """Put a preempted request at the head of the queue so it
        re-admits as soon as its pages are available again."""
        self.pending.appendleft(req)

    @staticmethod
    def continuation(rs: RequestState) -> Request | None:
        """Rebuild an evicted request as a prompt+generated continuation
        (prefill REPLAYS the progress; greedy decoding continues the
        exact chain — total_steps is conserved: (P+g)+(N-g)-1 = P+N-1).
        Returns None when the request is already finished
        (``generated == max_new``): rebuilding it would need max_new=0,
        which submit rejects — retire it instead."""
        if len(rs.generated) >= rs.req.max_new:
            return None
        if not rs.generated:
            return rs.req
        return Request(
            rid=rs.req.rid,
            prompt=np.concatenate(
                [rs.req.prompt, np.asarray(rs.generated, np.int32)]),
            max_new=rs.req.max_new - len(rs.generated),
            ttft_slo_s=rs.req.ttft_slo_s)

    # -- failover ------------------------------------------------------------

    def drain(self, pt: PageTable,
              results: dict[int, np.ndarray] | None = None
              ) -> list[tuple[Request, list[int]]]:
        """Evacuate this (dead) replica's work for re-admission elsewhere.

        Every in-flight request's page chain returns to the free list and
        the request is rebuilt as a continuation (``continuation``);
        a request whose generated prefix already equals max_new is
        RETIRED into ``results`` instead of rebuilt (the max_new=0 rebuild
        used to trip submit's check on re-admission).  Pending requests
        pass through unchanged.  Returns [(request, generated_prefix)] in
        admission order; the caller stitches prefix + survivor output.
        """
        out: list[tuple[Request, list[int]]] = []
        for slot, rs in sorted(self.active.items()):
            pt.release(slot)
            req = self.continuation(rs)
            if req is None:
                if results is not None:
                    results[rs.req.rid] = np.asarray(rs.generated,
                                                     np.int32)
                continue
            out.append((req, list(rs.generated)))
        out.extend((req, []) for req in self.pending)
        self.active.clear()
        self.pending.clear()
        self._free_slots = list(range(self.slots - 1, -1, -1))
        self._committed_pages = 0
        return out

    # -- quantum planning / retirement ---------------------------------------

    def plan_quantum(self, chunk: int) -> QuantumPlan:
        c = max(1, int(chunk))
        tokens = np.zeros((self.slots, c), np.int32)
        n_in = np.ones(self.slots, np.int32)
        pos = np.zeros(self.slots, np.int32)
        steps = np.zeros(self.slots, np.int32)
        for slot, rs in self.active.items():
            p = len(rs.req.prompt)
            steps[slot] = min(c, rs.req.total_steps - rs.consumed)
            pos[slot] = rs.consumed
            if rs.consumed < p:           # chunked prefill: prompt inputs
                n = min(int(steps[slot]), p - rs.consumed)
                n_in[slot] = n
                tokens[slot, :n] = rs.req.prompt[rs.consumed:rs.consumed + n]
            else:                         # decoding: chain from last sample
                n_in[slot] = 1
                tokens[slot, 0] = rs.last_out
        return QuantumPlan(tokens=tokens, n_in=n_in, pos=pos, steps=steps,
                           chunk=c)

    def complete_quantum(self, plan: QuantumPlan, out: np.ndarray,
                         pt: PageTable, metrics: ServeMetrics
                         ) -> list[RequestState]:
        """Fold the quantum's sampled tokens back into request state;
        retire finished requests (slots + pages return to the free
        lists)."""
        finished: list[RequestState] = []
        for slot, rs in list(self.active.items()):
            n = int(plan.steps[slot])
            if n == 0:
                continue
            p = len(rs.req.prompt)
            before = len(rs.generated)
            for t in range(n):
                g = rs.consumed + t       # global engine-step index
                if g >= p - 1 and len(rs.generated) < rs.req.max_new:
                    rs.generated.append(int(out[slot, t]))
            delta = len(rs.generated) - before
            if delta:
                if before == 0:
                    metrics.on_first_token(rs.req.rid)
                metrics.on_generated(rs.req.rid, delta)
            rs.last_out = int(out[slot, n - 1])
            rs.consumed += n
            if rs.done:
                metrics.on_done(rs.req.rid)
                finished.append(rs)
                del self.active[slot]
                self._free_slots.append(slot)
                self._committed_pages -= rs.committed
                pt.release(slot)
        return finished
