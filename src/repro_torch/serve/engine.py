"""Serving engine — the step loop over the paged cache (port of
``repro.serve.engine``).

One dispatched quantum advances every decode slot by up to C tokens:
slots still inside their prompt consume prompt tokens (chunked prefill),
slots past it feed their own last sample back (decode).  The reference
compiles the quantum as one ``lax.scan`` over ``Model.decode_step_paged``
(``build_paged_step``, one jitted function per C).  The port's
``build_paged_step`` is one decode step written against static device
buffers (the plan, the step counter, the sampled tokens) and the cache
pools, every write in place; on a card ``warmup`` captures it once in a
CUDA graph and each step of a quantum is one replay, so a quantum costs
one H2D of the plan, a replay a step and one D2H of the tokens.  C only
sets how often the graph is replayed, so a re-tuned C captures nothing.
On the CPU, and over a mesh of processes (whose collectives go through
gloo and host buffers, which a graph cannot hold), the same step runs
eagerly; ``quantum_mode`` says which.  C — the scheduling quantum — is
the managed knob, chosen by ``managed.resolve_serve_schedule`` from the
serve cost model and corrected online from serve/metrics.py's measured
step latencies.

The cache is the paged pool of serve/kv_cache.py: per-layer page pools,
one host-side page table, pages recycled through the free list as
requests retire.  The pools are updated in place (the reference donates
them).  Over a mesh every rank runs the same engine on the same
requests: the table holds global page ids, and each rank's pools hold
its shard of the pages (sharded over the cache axes, rank r owning ids
[r*Np_loc, (r+1)*Np_loc)); a sharded pool preempts by recompute only,
since a swapped chain would come back on other ranks' pages.  The
engine serves every token-only decoder family (dense, MoE, SSM, hybrid):
SSM state is slot-indexed and masked, so "paging" is slot reuse there,
and those families preempt by recompute (a swap moves page chains, not
slot state).

Overload is a managed condition, not a crash.  Admission is optimistic
(watermark mode commits only the prompt's pages), and when the pool
exhausts mid-decode (``PagePoolExhausted``) the engine preempts: pick a
victim, then either SWAP its page chain to host (D2H in
``overlap.drain_chunk_bytes``-metered page slices, restored on
re-admission), DROP it for prefill-replay (``scheduler.continuation``),
or stall the growing slot one quantum — whichever
``managed.resolve_preempt`` prices cheapest.  Greedy decoding makes both
eviction paths token-equal to the no-overload run.  The ``burst`` and
``pool_squeeze`` fault kinds drive this machinery deterministically.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from repro_torch.core import cost_model, managed, overlap
from repro_torch.core.faults import FaultPlan
from repro_torch.kernels import counters
from repro_torch.models import attention
from repro_torch.models.model import Model
from repro_torch.obs.calibrate import Recalibrator
from repro_torch.obs.tracer import get_tracer
from repro_torch.serve.kv_cache import (PagedCacheConfig, PagePoolExhausted,
                                        PageTable)
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.scheduler import (QuantumPlan, Request,
                                         RequestRejected, ServeScheduler)


class PlanBuffer:
    """Static int32 plan buffers on the device, filled together by one
    host-to-device copy: ``views`` of one device buffer, in the given
    shapes (a 0-d view for ``()``), and their host twins (``host``),
    pinned on a card, where an event says when the last copy out of them
    is done; on the CPU the twins are the views themselves.  A captured
    step reads the views, so they keep their addresses."""

    def __init__(self, shapes: list[tuple[int, ...]],
                 device: torch.device):
        self._shapes = shapes
        self._sizes = [math.prod(s) for s in shapes]
        self.buf = torch.zeros(sum(self._sizes), dtype=torch.int32,
                               device=device)
        on_card = device.type == "cuda"
        self._host = (self.buf if device.type == "cpu" else torch.zeros(
            self.buf.shape, dtype=torch.int32, pin_memory=on_card))
        self._copied = torch.cuda.Event() if on_card else None
        self.views = self._split(self.buf)

    def _split(self, buf: torch.Tensor) -> list[torch.Tensor]:
        return [t.view(shape)
                for t, shape in zip(buf.split(self._sizes), self._shapes)]

    def host(self) -> list[np.ndarray]:
        """The host twins of ``views`` as arrays to fill before ``send``
        (this waits for the last copy out of them)."""
        if self._copied is not None:
            self._copied.synchronize()
        return [v.numpy() for v in self._split(self._host)]

    def send(self) -> None:
        """The host twins into the views: one copy, in stream order."""
        if self._host is self.buf:
            return
        self.buf.copy_(self._host, non_blocking=True)
        if self._copied is not None:
            self._copied.record()


class PagedStep:
    """One decode step of a quantum against static buffers (the port of
    the reference's scan body; ``build_paged_step`` makes it).

    The plan lives in one int32 device buffer (a ``PlanBuffer``), in
    views: ``table`` [slots, max_pages], ``tokens`` [slots, max_chunk],
    ``n_in``, ``steps``, ``pos`` and ``last`` [slots], and ``t`` [1], the
    step counter; the sampled tokens go to ``out`` [slots, max_chunk].
    ``load`` fills them with one copy, each step then reads and writes
    only them and the cache pools, in place, so the step can be captured
    in a CUDA graph (``capture``) and replayed (``replay``) any number of
    times a quantum; ``run_eager`` runs it from Python."""

    def __init__(self, model: Model, cache: dict[str, torch.Tensor], *,
                 slots: int, max_pages: int, max_chunk: int):
        self.model = model
        self.cache = cache
        self.slots, self.max_chunk = slots, max_chunk
        # the pools' identity: a graph holds their addresses
        self._ptrs = counters.addresses(cache.values())
        self._plan = PlanBuffer([(slots, max_pages), (slots, max_chunk)]
                                + [(slots,)] * 4 + [(1,)], model.device)
        (self.table, self.tokens, self.n_in, self.steps, self.pos,
         self.last, self.t) = self._plan.views
        self.out = torch.zeros((slots, max_chunk), dtype=torch.int32,
                               device=model.device)
        self.graph = None
        #: launch counters' change over one step, added on every replay
        self.replay_launches: dict[tuple, int] = {}

    def load(self, table: np.ndarray, tokens: np.ndarray, n_in: np.ndarray,
             steps: np.ndarray, pos: np.ndarray) -> None:
        """Copy a quantum's plan into the buffers with one H2D and reset
        ``t`` to 0 and ``last`` to each slot's first input token.  Refuses
        pools rebound since the step was built (swap-in and the steps
        write them in place; a captured step writes the old ones)."""
        if counters.addresses(self.cache.values()) != self._ptrs:
            raise RuntimeError("the serving cache's pools were rebound; a "
                               "captured step writes the ones it was "
                               "built on")
        if int(steps.max(initial=0)) > self.max_chunk:
            raise ValueError(f"a quantum of {int(steps.max())} steps; the "
                             f"buffers hold {self.max_chunk}")
        w = min(tokens.shape[1], self.max_chunk)
        h_table, h_tok, h_n_in, h_steps, h_pos, h_last, h_t = \
            self._plan.host()
        h_table[:] = table
        h_tok[:] = 0
        h_tok[:, :w] = tokens[:, :w]
        h_n_in[:] = n_in
        h_steps[:] = steps
        h_pos[:] = pos
        h_last[:] = tokens[:, 0]
        h_t[:] = 0
        self._plan.send()

    @torch.no_grad()
    def run_eager(self) -> None:
        """One step from Python: slot b feeds ``tokens[b, t]`` while t <
        n_in[b] and its last sample after; slots with t >= steps[b] are
        inactive (no cache write, no position advance)."""
        idx = self.t.long().expand(self.slots, 1)
        tok = torch.where(self.t < self.n_in,
                          self.tokens.gather(1, idx)[:, 0], self.last)
        act = self.t < self.steps
        nxt, cache = self.model.decode_step_paged(self.cache, self.table,
                                                  tok, self.pos, act)
        if cache is not self.cache:
            raise RuntimeError("decode_step_paged returned another cache")
        self.pos.add_(act.to(torch.int32))
        self.last.copy_(torch.where(act, nxt, self.last))
        self.out.scatter_(1, idx, nxt[:, None])
        self.t.add_(1)

    def capture(self) -> None:
        """Run one step eagerly on a side stream, then capture the step in
        a CUDA graph (``counters.capture``; call it with every slot
        inactive, so the eager step changes no state).  A failed capture
        raises."""
        _, self.graph, _, self.replay_launches = counters.capture(
            self.run_eager, self.model.device)

    def replay(self) -> None:
        """One step: the captured graph, and the launches it holds added
        to the kernels' counters."""
        counters.replay(self.graph, self.replay_launches)

    def read(self, chunk: int) -> np.ndarray:
        """The sampled tokens [slots, chunk] (one D2H, which waits for the
        quantum's steps); columns past the buffers' width are zeros."""
        w = min(chunk, self.max_chunk)
        got = self.out[:, :w].to("cpu", copy=True).numpy()
        if w == chunk:
            return got
        return np.pad(got, ((0, 0), (0, chunk - w)))


def build_paged_step(model: Model, cache: dict[str, torch.Tensor], *,
                     slots: int, max_pages: int, max_chunk: int
                     ) -> PagedStep:
    """The decode quantum's step over ``cache`` (the engine's pools, which
    it writes in place): the port of the reference's ``build_paged_step``.
    The reference jits one scan per C; here C only counts the steps a
    quantum runs, so one step object, sized for the longest quantum
    (``max_chunk``), serves every C."""
    return PagedStep(model, cache, slots=slots, max_pages=max_pages,
                     max_chunk=max_chunk)


class ServeEngine:
    """Continuous-batching serving loop over the paged cache."""

    def __init__(self, model: Model, *,
                 slots: int = 4, max_seq: int = 256, page_size: int = 8,
                 n_pages: int | None = None, schedule: str = "auto",
                 chunk: int | None = None,
                 metrics: ServeMetrics | None = None,
                 fault_plan: FaultPlan | None = None,
                 admission: str = "watermark", watermark: int = 0,
                 preempt: str = "auto",
                 slo_ttft_s: float | None = None,
                 max_queue: int | None = None, burst_new: int = 8):
        if preempt not in ("auto", "swap", "recompute", "none"):
            raise ValueError(f"unknown preempt policy {preempt!r}")
        n_sh = attention.cache_shards(model.ctx)
        if preempt == "swap" and n_sh > 1:
            raise ValueError(
                "preempt='swap' moves a page chain of one pool; a pool "
                f"sharded over {n_sh} ranks preempts by recompute")
        #: the families whose whole per-request state is the page chain
        self._swappable = (model.cfg.family in ("dense", "moe")
                           and n_sh == 1)
        if preempt == "swap" and not self._swappable:
            raise ValueError(f"preempt='swap' moves page chains; the "
                             f"{model.cfg.family} family's slot state "
                             "preempts by recompute")
        self.model = model
        self.device = model.device
        self.slots = slots
        pages_per_seq = max(1, math.ceil(max_seq / page_size))
        if n_pages is None:
            n_pages = slots * pages_per_seq
        n_pages = ((n_pages + n_sh - 1) // n_sh) * n_sh
        self.cache_cfg = PagedCacheConfig(
            slots=slots, page_size=page_size, n_pages=n_pages,
            max_pages_per_seq=pages_per_seq)
        self.pt = PageTable(self.cache_cfg)
        self.metrics = metrics or ServeMetrics()
        self._n_params = model.cfg.param_count()
        self._dtype_bytes = model.dtype.itemsize
        self.scheduler = ServeScheduler(
            slots, schedule=schedule, chunk=chunk,
            cache_cfg=self.cache_cfg, admission=admission,
            watermark=watermark, slo_ttft_s=slo_ttft_s,
            max_queue=max_queue,
            model_step_s=cost_model.serve_step_time(
                self._n_params, slots, dtype_bytes=self._dtype_bytes))
        self._schedule = schedule
        self._preempt = preempt
        self._n_sh = n_sh
        self._burst_new = int(burst_new)
        self._cache_specs = model.paged_cache_specs(slots, n_pages,
                                                    page_size)
        # bytes per pool page, summed across the pools (each pool is
        # layer-stacked [L, Np + 1, page, KV, hd], so a page spans layers;
        # the slot-indexed SSM state is no page's)
        self._page_bytes = sum(
            math.prod(shape) // shape[1] * dtype.itemsize
            for name, (shape, dtype) in self._cache_specs.items()
            if name in ("kp", "vp"))
        self._rid = 0
        # the online-correction trigger (obs.Recalibrator): fire once as
        # soon as 3 quanta are measured, then again whenever the per-step
        # seconds drift >25% off the value the schedule was last resolved
        # against
        self.recal = Recalibrator(threshold=0.25, warmup=3)
        self.fault_plan = fault_plan
        self._quantum_idx = 0     # lifetime quantum counter (fault clock)
        #: decode steps run on the device (warmup included) — each one
        #: launches the paged-attention kernel once per layer
        self.decode_steps = 0
        self._warm = False
        self.results: dict[int, np.ndarray] = {}
        #: rid -> (n_pages, host page rows per pool, consumed, last_out,
        #: generated) for swapped-out victims awaiting re-admit
        self._swapped: dict[int, tuple] = {}
        #: rid -> tokens generated before a recompute eviction (stitched
        #: in front of the continuation's output at retirement)
        self._gen_prefix: dict[int, list[int]] = {}
        #: rids evicted since the last dispatched quantum; admission holds
        #: them at the queue head so eviction cannot chase re-admission
        self._hold: set[int] = set()
        self.cache = {name: torch.zeros(shape, dtype=dtype,
                                        device=self.device)
                      for name, (shape, dtype) in self._cache_specs.items()}
        # the reference's _step_fn keeps one jitted quantum per C; the
        # port's one step serves every C, up to a chain's whole length
        self.step = build_paged_step(
            model, self.cache, slots=slots, max_pages=pages_per_seq,
            max_chunk=pages_per_seq * page_size)
        #: "graph": each step of a quantum is one replay of the step
        #: captured at warm-up (a card, every mesh axis of size 1);
        #: "eager": the step runs from Python (the CPU, or a mesh of
        #: processes, whose collectives go through host buffers)
        self.quantum_mode = ("graph" if self.device.type == "cuda" and all(
            n == 1 for n in model.ctx.axis_sizes.values()) else "eager")

    # -- device state --------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self) -> None:
        """Build the kernels and warm the device libraries outside the
        measured loop: one decode step with every slot inactive writes
        only the pools' trailing page and leaves all state as it was.  In
        graph mode the step is then captured (``PagedStep.capture``)."""
        z = np.zeros(self.slots, np.int32)
        self.step.load(self.pt.table, z[:, None], z + 1, z, z)
        if self.quantum_mode == "graph":
            self.step.capture()
        else:
            self.step.run_eager()
        self.decode_steps += 1
        self._sync()
        self._warm = True

    def _run_quantum(self, plan: QuantumPlan) -> np.ndarray:
        """Run one quantum on the device: the plan in one copy, then one
        step (a graph replay, or the step from Python) for each step of the
        longest slot's count: steps past it would change nothing.  Returns
        the sampled tokens [slots, C] (one host sync)."""
        st = self.step
        st.load(self.pt.table, plan.tokens, plan.n_in, plan.steps, plan.pos)
        advance = st.replay if self.quantum_mode == "graph" else st.run_eager
        for _ in range(int(plan.steps.max())):
            advance()
            self.decode_steps += 1
        return st.read(plan.chunk)

    # -- queue ---------------------------------------------------------------

    def submit(self, prompt: np.ndarray, max_new: int,
               ttft_slo_s: float | None = None) -> int:
        rid = self._rid
        self._rid += 1
        req = Request(rid=rid, prompt=np.asarray(prompt, np.int32).ravel(),
                      max_new=int(max_new), ttft_slo_s=ttft_slo_s)
        self.submit_request(req)
        return rid

    def submit_request(self, req: Request) -> None:
        """Submit a pre-built request, preserving its rid — the failover
        path: a drained replica's requests re-admit here with their
        generated prefix folded into the prompt.  Infeasible requests
        raise the typed ``RequestRejected`` and shed ones ``RequestShed``
        (scheduler.submit) — the rid is consumed either way."""
        self._rid = max(self._rid, req.rid + 1)
        self.scheduler.submit(req, self.metrics)

    def drain(self) -> list[tuple[Request, list[int]]]:
        """Evacuate a dead replica: free every in-flight request's page
        chain and hand back [(request, generated_prefix)] rebuilt for a
        survivor (scheduler.drain).  Finished requests retire into
        ``self.results``; the caller stitches prefix + survivor output
        for the rest.  Swapped-out host state is dropped — the original
        request is still queued and replays from scratch elsewhere."""
        out = self.scheduler.drain(self.pt, self.results)
        self._swapped.clear()
        self.scheduler.restore_pages.clear()
        for rid, pre in list(self._gen_prefix.items()):
            if rid in self.results:
                self.results[rid] = np.concatenate(
                    [np.asarray(pre, np.int32), self.results[rid]])
                del self._gen_prefix[rid]
        return [(req, self._gen_prefix.pop(req.rid, []) + prefix)
                for req, prefix in out]

    # -- overload faults -----------------------------------------------------

    def _inject_burst(self, n: int) -> None:
        """A ``burst@q:n`` event: n synthetic arrivals at this quantum
        boundary, prompts seeded from the quantum index so the flood is
        identical across runs.  Shed/rejected arrivals are recorded by
        admission control and dropped — overload degrades, never kills."""
        rng = np.random.default_rng(0xB0 + 997 * self._quantum_idx)
        for _ in range(max(0, n)):
            plen = int(rng.integers(4, 17))
            prompt = rng.integers(1, 1000, size=plen).astype(np.int32)
            try:
                self.submit(prompt, self._burst_new)
            except RequestRejected:
                pass

    def _apply_overload_events(self) -> None:
        if self.fault_plan is None:
            return
        for ev in self.fault_plan.serve_overload(self._quantum_idx):
            if ev.kind == "burst":
                self._inject_burst(int(ev.arg))
            else:                             # pool_squeeze@q:frac
                self.pt.squeeze(float(ev.arg))

    # -- preemption (the optimistic-admission backstop) ----------------------

    def _swap_chunk_pages(self, page_bytes: int) -> int:
        """Pages per metered transfer slice: the drain's chunk meter
        applied to eviction traffic."""
        step = self.scheduler.step_s_hint(self.metrics) or 1e-3
        bw = self.metrics.swap_bw_estimate() or cost_model.PCIE_BW
        cb = overlap.drain_chunk_bytes(step, bw)
        return max(1, cb // max(1, page_bytes))

    def _swap_out(self, slot: int) -> None:
        """Evict ``slot`` by draining its resident KV pages to host in
        page-sliced chunks; the original request requeues at the front and
        restores (``_swap_in``) once admission finds its pages again."""
        sch, pt = self.scheduler, self.pt
        rs = sch.active[slot]
        keep = pt.cfg.pages_needed(rs.consumed)
        ids = torch.as_tensor(pt.chain(slot)[:keep], dtype=torch.long,
                              device=self.device)
        t0 = time.perf_counter()
        host: dict[str, torch.Tensor] = {}
        nbytes = 0
        with get_tracer().span("serve.swap_out", op="preempt_policy",
                               axis="serve", track="serve",
                               buffer="kv_pages", slot=slot) as sp:
            for name, leaf in self.cache.items():
                page_bytes = leaf[:, 0].numel() * leaf.element_size()
                ppc = self._swap_chunk_pages(page_bytes)
                parts = [leaf.index_select(1, ids[i:i + ppc]).cpu()
                         for i in range(0, len(ids), ppc)]
                rows = (torch.cat(parts, dim=1) if parts else
                        leaf.new_zeros(leaf.shape[:1] + (0,)
                                       + leaf.shape[2:]).cpu())
                host[name] = rows
                nbytes += rows.numel() * rows.element_size()
            if sp is not None:
                sp.note(nbytes=nbytes)
        self.metrics.note_swap(nbytes, time.perf_counter() - t0)
        rs = sch.preempt(slot, pt)
        self._swapped[rs.req.rid] = (len(ids), host, rs.consumed,
                                     rs.last_out, list(rs.generated))
        sch.restore_pages[rs.req.rid] = keep
        sch.requeue_front(rs.req)
        self._hold.add(rs.req.rid)
        self.metrics.on_preempt(rs.req.rid, "swap")

    def _swap_in(self, rs) -> None:
        """Restore a swapped victim into its new slot: reallocate a page
        chain for its consumed positions and push the host rows back
        (H2D, same chunk meter), then resume decoding mid-chain."""
        data = self._swapped.pop(rs.req.rid, None)
        if data is None:
            return
        n_ids, host, consumed, last_out, generated = data
        pt = self.pt
        pt.ensure(rs.slot, consumed)
        new_ids = torch.as_tensor(pt.chain(rs.slot)[:n_ids],
                                  dtype=torch.long, device=self.device)
        t0 = time.perf_counter()
        nbytes = 0
        with get_tracer().span("serve.swap_in", op="preempt_policy",
                               axis="serve", track="serve",
                               buffer="kv_pages", slot=rs.slot) as sp:
            for name, rows in host.items():
                if not len(new_ids):
                    continue
                leaf = self.cache[name]
                page_bytes = leaf[:, 0].numel() * leaf.element_size()
                ppc = self._swap_chunk_pages(page_bytes)
                for i in range(0, len(new_ids), ppc):
                    leaf[:, new_ids[i:i + ppc]] = \
                        rows[:, i:i + ppc].to(self.device)
                nbytes += rows.numel() * rows.element_size()
            self._sync()
            if sp is not None:
                sp.note(nbytes=nbytes)
        self.metrics.note_swap(nbytes, time.perf_counter() - t0)
        rs.consumed = consumed
        rs.last_out = last_out
        rs.generated = list(generated)
        self.scheduler.restore_pages.pop(rs.req.rid, None)

    def _drop_recompute(self, slot: int) -> None:
        """Evict ``slot`` by releasing its pages outright; the request
        requeues as a prompt+generated continuation whose prefill REPLAYS
        the lost KV (greedy decoding keeps the token chain equal)."""
        sch = self.scheduler
        with get_tracer().span("serve.recompute_evict",
                               op="preempt_policy", axis="serve",
                               track="serve", buffer="kv_pages",
                               slot=slot):
            rs = sch.preempt(slot, self.pt)
            rid = rs.req.rid
            cont = sch.continuation(rs)
            if cont is None:                  # already finished: retire
                self._retire(rid, rs.generated)
                return
            if rs.generated:
                self._gen_prefix[rid] = (self._gen_prefix.get(rid, [])
                                         + list(rs.generated))
            sch.requeue_front(cont)
            self._hold.add(rid)
        self.metrics.on_preempt(rid, "recompute")

    def _retire(self, rid: int, generated: list[int]) -> None:
        pre = self._gen_prefix.pop(rid, [])
        self.results[rid] = np.asarray(list(pre) + list(generated),
                                       np.int32)

    def _cap_to_resident(self, plan, stalled: list[int]) -> int:
        """The WAIT policy: clamp each stalled slot's quantum steps to
        the positions its already-allocated chain can hold.  Returns the
        batch's total steps after clamping."""
        for s in stalled:
            rs = self.scheduler.active[s]
            fit = (self.pt.pages_held(s) * self.cache_cfg.page_size
                   - rs.consumed)
            plan.steps[s] = max(0, min(int(plan.steps[s]), fit))
        return int(plan.steps.sum())

    def _handle_exhaustion(self, plan, stalled: list[int]) -> bool:
        """React to ``PagePoolExhausted`` on this quantum's page growth.
        Returns True when a victim was evicted (the caller re-admits and
        re-plans), False when ``plan.steps`` were capped in place and the
        clamped quantum should dispatch (wait)."""
        sch, pt = self.scheduler, self.pt
        can_wait = self._cap_to_resident(plan, stalled) > 0
        if self._preempt == "none":
            # the unmanaged baseline: no eviction machinery — stall while
            # anything progresses, die when nothing can
            if not can_wait:
                raise RuntimeError(
                    "serve queue stalled: page pool exhausted and "
                    f"preemption is disabled ({self.cache_cfg})")
            return False
        victim = sch.select_victim(pt, prefer_not=stalled[0])
        if victim is None or len(sch.active) == 1:
            # no victim — or evicting the SOLE slot, which can never
            # help: its continuation needs at least the pages it holds
            # now, so eviction would only trade a stall for a thrash
            if can_wait:
                return False
            raise RuntimeError(
                "serve queue stalled: page pool exhausted with no "
                f"evictable victim ({self.cache_cfg})")
        vrs = sch.active[victim]
        victim_pages = pt.pages_held(victim)
        step = sch.step_s_hint(self.metrics)
        # soonest a retirement frees pages naturally — only meaningful
        # when the clamped batch still progresses toward one
        wait_s = None
        if can_wait and step is not None:
            rem = [rs.req.total_steps - rs.consumed
                   for s, rs in sch.active.items() if s not in stalled]
            if rem:
                wait_s = min(rem) * step
        policy = None if self._preempt == "auto" else self._preempt
        d = managed.resolve_preempt(
            sch.axis_name, victim_pages, self._page_bytes, vrs.consumed,
            self._n_params, batch_slots=self.slots,
            dtype_bytes=self._dtype_bytes, measured_step_s=step,
            measured_pcie_bw=self.metrics.swap_bw_estimate(),
            wait_s=wait_s, allow_swap=self._swappable, policy=policy)
        if d.policy == "wait":
            return False
        if d.policy == "swap":
            self._swap_out(victim)
        else:
            self._drop_recompute(victim)
        return True

    # -- the step loop -------------------------------------------------------

    def run(self) -> dict[int, np.ndarray]:
        """Serve the queue to completion; returns rid -> generated tokens.
        The schedule decision (and any online correction) is visible in
        ``managed.decision_log()`` as ``op="serve_schedule"`` records,
        and every pool-exhaustion event as ``op="preempt_policy"``."""
        sch = self.scheduler
        if not sch.has_work() and not (
                self.fault_plan and self.fault_plan.unfired()):
            return {}
        sch.decide(self._n_params, self._dtype_bytes)
        if sch.chunk is None:       # queue was empty (pure fault drive)
            return self.results
        if not self._warm:
            self.warmup()
        # warmup is over: TTFT measures serving from here
        self.metrics.rebase_pending()
        results = self.results
        while sch.has_work():
            self._apply_overload_events()
            for rs in sch.admit(self.pt, hold=self._hold):
                if rs.req.rid in self._swapped:
                    self._swap_in(rs)
            plan = sch.plan_quantum(sch.chunk)
            if int(plan.steps.sum()) == 0:
                # admit() ran just above with an empty batch and still
                # produced nothing: the head request can never fit
                raise RuntimeError(
                    "serve queue stalled: request exceeds the page pool "
                    f"({self.cache_cfg})")
            stalled = []
            for slot in sorted(sch.active):
                rs = sch.active[slot]
                try:
                    self.pt.ensure(slot,
                                   rs.consumed + int(plan.steps[slot]))
                except PagePoolExhausted:
                    stalled.append(slot)
            if stalled and self._handle_exhaustion(plan, stalled):
                continue              # victim evicted: re-admit, re-plan
            if int(plan.steps.sum()) == 0:
                continue              # whole batch stalled this quantum
            if self.fault_plan is not None:
                # the fault clock ticks on dispatched quanta; a
                # replica_death here leaves finished work in self.results
                # and in-flight state intact for drain()
                self.fault_plan.serve_quantum(self._quantum_idx)
            self._quantum_idx += 1
            useful = int(plan.steps.sum())
            t0 = time.perf_counter()
            # scale = useful slot-steps: dur/scale is measured seconds
            # per token, the unit resolve_serve_schedule predicts
            with get_tracer().span(
                    "serve.quantum", op="serve_schedule", axis="serve",
                    track="serve", chunk=plan.chunk, scale=useful,
                    quantum=self._quantum_idx - 1, reads="kv_pages"):
                out_np = self._run_quantum(plan)
            wall = self._agreed(time.perf_counter() - t0)
            self._hold.clear()    # a quantum dispatched: evictees may
            # re-enter admission on the next planning round
            self.metrics.note_quantum(wall, plan.chunk, useful,
                                      self.slots)
            self.recal.note(wall / max(1, plan.chunk))
            for rs in sch.complete_quantum(plan, out_np, self.pt,
                                           self.metrics):
                self._retire(rs.req.rid, rs.generated)
            self._maybe_retune()
        return results

    def _agreed(self, seconds: float) -> float:
        """The slowest rank's ``seconds`` over the mesh: every rank feeds
        its metrics, and so its schedule and preemption decisions, the
        same number, and so keeps issuing the same collectives."""
        ctx = self.model.ctx
        if all(n == 1 for n in ctx.axis_sizes.values()):
            return seconds
        t = torch.tensor([seconds], dtype=torch.float32, device=self.device)
        return float(managed.all_reduce_max(t, ctx.all_axes, ctx))

    def _maybe_retune(self) -> None:
        """The iteration-(k)->(k+1) correction: once enough quanta are
        measured, re-resolve the schedule with the observed step/dispatch
        seconds."""
        if self._schedule != "auto" or not self.recal.should_retune():
            return
        self.scheduler.decide(
            self._n_params, self._dtype_bytes,
            measured_step_s=self.metrics.step_s_estimate(),
            measured_dispatch_s=self.metrics.dispatch_s_estimate())
        # rebase on the measurement EWMA at resolve time; the next
        # retune needs a further >threshold sustained drift from here
        self.recal.rebase()
