"""Fault-tolerant training loop + the train step builder (port of
``repro.train.train_loop``).

The train step is per-rank code over the mesh (one process per rank):
every collective in the forward, the backward and the gradient sync is a
managed op.  Gradient flow:

  * FSDP-sharded params: the fsdp_gather's gradient reduce-scatters each
    layer's gradient in that layer's backward — MDMP's as-ready "send on
    last write" (core/overlap.py);
  * replicated params (and the pod axis): explicit all-reduces over
    exactly the mesh axes absent from each param's spec (``sync_grads``),
    with optional int8 error-feedback compression on the thin cross-pod
    link.

The step differentiates ``Model.loss_sp`` with autograd — the
flash-attention backward is the CUDA kernel on a card — then takes one
AdamW step that updates the model's parameters IN PLACE (the reference
donates its buffers and returns new ones).  With ``pipeline`` the pod
axis runs as pipeline stages instead (parallel/pipeline.py).  The
reference compiles the step into one program; on one card the port
captures it in a CUDA graph at its first call and replays it from then on
(``TrainStep``), and issues it op by op from Python elsewhere.

Fault tolerance: periodic async checkpoints, restore-and-retry on a
failed step (``fault_hook`` and the deterministic ``fault_plan`` of
core/faults.py inject failures), straggler detection from the step-time
EWMA, the managed (Young/Daly) checkpoint cadence, the schedule tuner
riding in the checkpoint, and the elastic resume on a different mesh.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import tempfile
import time
from typing import Any, Callable

import torch

from repro_torch import checkpoint as ckpt_lib
from repro_torch.core import instrument, managed, overlap
from repro_torch.core import tuner as tuner_lib
from repro_torch.core.faults import FaultPlan
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.kernels import counters
from repro_torch.models import layers as model_layers
from repro_torch.models import transformer
from repro_torch.models.model import (Model, flatten_specs,
                                      unflatten_specs)
from repro_torch.obs.calibrate import Recalibrator
from repro_torch.obs.tracer import get_tracer
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.parallel import compression
from repro_torch.parallel import pipeline as pipe
from repro_torch.parallel.sharding import (LOGICAL_RULES, MeshCtx,
                                           ParamSpec, shard_of)


# ---------------------------------------------------------------------------
# Gradient post-processing: reduce over the axes a param is NOT sharded on
# ---------------------------------------------------------------------------


def _missing_axes(spec: ParamSpec, all_axes: tuple[str, ...]
                  ) -> tuple[str, ...]:
    present = {LOGICAL_RULES[l] for l in spec.logical}
    return tuple(ax for ax in all_axes if ax not in present)


def sync_grads(grads: Any, spec_tree: Any, ctx: MeshCtx, *,
               compress_pod: bool = False, error_state: Any = None
               ) -> tuple[Any, Any]:
    """Sum each grad over the mesh axes absent from its spec: the
    FSDP/TP-sharded dims were already reduced by the collectives'
    gradients.  The pod-axis reduction of a grad above 4096 elements
    optionally runs as the int8 error-feedback sum (the thin inter-pod
    pipe).  Returns (grads, error state), both in ``grads``' structure."""
    specs = flatten_specs(spec_tree)
    errs = flatten_specs(error_state) if error_state is not None else {}
    out, out_err = {}, {}
    for name, g in flatten_specs(grads).items():
        err = errs.get(name)
        for ax in _missing_axes(specs[name], ctx.all_axes):
            if ax == "pod" and compress_pod and g.numel() > 4096:
                g, err = compression.compressed_psum(g, ax, ctx, err)
            else:
                g = managed.managed_all_reduce(g, ax, ctx)
        out[name] = g
        out_err[name] = (err if err is not None
                         else torch.zeros((), dtype=g.dtype, device=g.device))
    return unflatten_specs(out), unflatten_specs(out_err)


def _replication_factor(spec: ParamSpec, ctx: MeshCtx) -> int:
    n = 1
    for ax in _missing_axes(spec, ctx.all_axes):
        n *= ctx.axis_sizes[ax]
    return n


# ---------------------------------------------------------------------------
# Train step builder
# ---------------------------------------------------------------------------


def build_train_step(model: Model, opt_cfg: AdamWConfig, *,
                     compress_pod: bool = False,
                     pipeline: str = "none",
                     pipe_microbatches: int | None = None,
                     global_batch: int | None = None,
                     seq_len: int | None = None
                     ) -> "TrainStep":
    """Returns ``step(opt_state, batch) -> (opt_state, metrics)``, a
    ``TrainStep`` (a captured CUDA graph on one card, eager elsewhere).

    ``batch`` holds the GLOBAL tokens and labels [B, S] on the model's
    device; each rank takes its rows (``ctx.shard_batch``).  The step
    updates this rank's parameter shards and ``opt_state`` in place;
    metrics are 0-d tensors (loss, grad_norm, lr), the same on every
    rank, read without a host sync.  ``cfg.accum_steps`` > 1 splits the
    local batch into that many microbatches along B and averages their
    gradients, as the reference.

    ``pipeline`` turns the pod axis into pipeline STAGES instead of
    hierarchical DP: "gpipe" | "1f1b" | "interleaved" pin a schedule,
    "auto" lets the managed runtime pick (cost model and decision log,
    ``managed.resolve_pipeline_schedule``); the batch then replicates
    across pods and streams through the stages as ``pipe_microbatches``
    microbatches (default: the decision's M).  ``global_batch`` /
    ``seq_len`` feed the cost model's compute and bytes estimates.
    ``compress_pod`` sums the pod axis's gradients as int8 with error
    feedback; as in the reference, the error state is not carried from
    one step to the next."""
    cfg, ctx = model.cfg, model.ctx
    use_pipe = pipeline != "none"
    if use_pipe and not ctx.has_pod:
        raise ValueError(f"pipeline={pipeline!r} needs a 'pod' mesh axis "
                         f"(stages); got axes {tuple(ctx.axis_sizes)}")
    batch_axes = ("data",) if use_pipe else ctx.batch_axes
    accum = max(1, cfg.accum_steps)
    names = list(flatten_specs(model.params()))
    spec_tree = model.param_specs()
    rep = [_replication_factor(sp, ctx)
           for sp in flatten_specs(spec_tree).values()]
    n_devices = 1
    for n in ctx.axis_sizes.values():
        n_devices *= n

    sched = None
    if use_pipe:
        if not (model.scan_layers and cfg.moe is None
                and cfg.encoder is None and cfg.vision is None
                and accum == 1):
            raise ValueError("pipeline training needs a uniform scanned "
                             "decoder stack")
        n_stage = ctx.pods
        # cost-model inputs: one rank's full-batch forward compute
        # (~2 flops/param/token over its layer share) and the boundary
        # activation block
        gb = global_batch if global_batch is not None else 8
        sl = seq_len if seq_len is not None else 128
        b_loc = max(1, gb // max(1, ctx.dp))
        tokens_loc = b_loc * sl
        batch_fwd_s = (2.0 * cfg.param_count() / n_stage * tokens_loc
                       / managed.get_config().hw.peak_flops)
        batch_bytes = (b_loc * (sl // max(1, ctx.tp)) * cfg.d_model
                       * model.dtype.itemsize)
        # M must tile the local batch: restrict the candidates (and any
        # explicit M) to divisors of b_loc up front
        cand_micro = tuple(m for m in (1, 2, 4, 8, 16, 32, 64)
                           if b_loc % m == 0)
        if pipe_microbatches is not None and b_loc % pipe_microbatches:
            raise ValueError(f"--microbatches {pipe_microbatches} must "
                             f"divide the local batch {b_loc}")
        decision = managed.resolve_pipeline_schedule(
            "pod", n_stage, batch_fwd_s, batch_bytes,
            n_layers=cfg.n_layers, candidate_micro=cand_micro,
            mode=ctx.mdmp_mode,
            schedule=None if pipeline == "auto" else pipeline,
            n_micro=pipe_microbatches)
        sched = pipe.build_schedule(decision.schedule, decision.n_micro,
                                    n_stage, decision.virtual)

    def grads_of(batch: dict) -> tuple[torch.Tensor, list[torch.Tensor]]:
        leaves = list(flatten_specs(model.params()).values())
        loss, _ = model.loss_sp(batch)
        # the summed loss is replicated on every rank, and the gradient of
        # each all-reduce is an all-reduce: the raw gradient is n_devices
        # times too large, so differentiate loss / n_devices (as the
        # reference)
        return loss.detach(), list(torch.autograd.grad(loss / n_devices,
                                                       leaves))

    def pipe_loss_and_grads(batch: dict) -> tuple[torch.Tensor, dict]:
        """Loss and grads through the managed pipeline over the pod axis.
        Grads come back per-stage partial (each rank only differentiates
        its own chunks); sync_grads' pod all-reduce assembles the tree."""
        n_virtual = sched.n_stage * sched.virtual
        m = sched.n_micro
        tokens, labels = batch["tokens"], batch["labels"]
        b_loc, sl = tokens.shape
        if b_loc % m:
            raise ValueError(f"local batch {b_loc} over {m} microbatches")
        toks = tokens.reshape(m, b_loc // m, sl)
        labs = labels.reshape(m, b_loc // m, sl)
        proto = torch.empty((b_loc // m, sl // max(1, ctx.tp), cfg.d_model),
                            dtype=model.dtype, device="meta")

        def chunk_fn(p, q, mb, x):
            if q == 0:
                x = model._assemble_input_sp(
                    p, {"tokens": toks[mb]}).to(x.dtype)
            chunk = pipe.chunk_slice(p["layers"], cfg.n_layers, n_virtual,
                                     q)
            # the B unit already recomputes the chunk: no remat inside
            y, _, _, _ = transformer.stack_sp(x, chunk, cfg, ctx,
                                              causal=True, remat=False,
                                              **model._stack_kw(x))
            return y

        def loss_fn(p, y, mb):
            x = model_layers.rms_norm(y, p["final_ln"], cfg.norm_eps)
            loss_sum, count = model_layers.lm_loss_sp(
                x, model._unembed(p), labs[mb], cfg, ctx)
            for ax in ("data", "model"):
                if ax in ctx.axis_sizes:
                    loss_sum = managed.managed_all_reduce(loss_sum, ax, ctx)
                    count = managed.managed_all_reduce(count, ax, ctx)
            return loss_sum / torch.clamp(count, min=1.0)

        # the loss sums over data and model replicate it there; the
        # backward seed divides their product away (as grads_of divides
        # by n_devices); over pod only the last stage adds
        return pipe.pipeline_value_and_grad(
            chunk_fn, loss_fn, model.params(), proto, sched, "pod", ctx,
            mean=True, grad_seed_scale=1.0 / (ctx.dp * ctx.tp),
            reduce_grads=False)

    def step(opt_state: dict, batch: dict) -> tuple[dict, dict]:
        batch = ctx.shard_batch(batch, batch_axes)
        if use_pipe:
            loss, grad_tree = pipe_loss_and_grads(batch)
        else:
            if accum > 1:
                b = batch["tokens"].shape[0]
                if b % accum:
                    raise ValueError(f"batch {b} over {accum} microbatches")
                mb = b // accum
                loss, grads = grads_of({k: v[:mb] for k, v in batch.items()})
                for i in range(1, accum):
                    l, g = grads_of({k: v[i * mb:(i + 1) * mb]
                                     for k, v in batch.items()})
                    loss = loss + l
                    grads = [a + c for a, c in zip(grads, g)]
                loss = loss / accum
                grads = [g / accum for g in grads]
            else:
                loss, grads = grads_of(batch)
            grad_tree = unflatten_specs(dict(zip(names, grads)))
            del grads
        grad_tree, _ = sync_grads(grad_tree, spec_tree, ctx,
                                  compress_pod=compress_pod)
        # the replication-aware global norm
        ssq = torch.zeros((), dtype=torch.float32, device=loss.device)
        for g, r in zip(flatten_specs(grad_tree).values(), rep):
            ssq = ssq + torch.sum(torch.square(g.float())) / r
        for ax in ctx.all_axes:
            ssq = managed.managed_all_reduce(ssq, ax, ctx)
        gnorm = torch.sqrt(ssq)
        _, opt_state, metrics = adamw_update(model.params(), grad_tree,
                                             opt_state, opt_cfg, gnorm=gnorm)
        metrics["loss"] = loss
        return opt_state, metrics

    return TrainStep(model, step, pipelined=use_pipe)


class TrainStep:
    """The training step as one program: the port of the reference's
    jitted, state-donating step (``build_train_step`` makes it).

    ``step(opt_state, batch) -> (opt_state, metrics)``: the model's
    parameters and ``opt_state`` are updated in place, metrics are 0-d
    tensors.  ``step_mode`` says how a call runs:

      * "graph" on a card where every mesh axis has size 1, the step is
        not pipelined and no ``instrument`` recorder is active: the step
        is bound to the parameters, ``opt_state`` and static buffers in
        the batch's shapes (``load`` copies each batch in).  The first
        call of a binding runs the step eagerly on a side stream (a real
        step: it builds the kernels and warms the libraries) and captures
        it in a CUDA graph, which runs nothing; every later call replays
        the graph.  A call whose parameters, moments, step counter or
        batch shapes are not the bound ones (a restored checkpoint, a new
        batch shape) drops the graph and its memory pool and binds again,
        as the reference's jit compiles again for a new shape;
      * "eager" elsewhere (the CPU, meta tensors, a mesh of processes, the
        pipelined step, under a recorder): every op is issued from Python
        on the arguments themselves.

    A replay runs no Python, so the kernels' launch counters are advanced
    by what the capture counted (``replay_launches``); the decisions are
    logged by the first pass over a shape (the model resolves each shape
    once), the binding's warm-up step, as the reference logs them once per
    trace."""

    def __init__(self, model: Model, body: Callable[[dict, dict],
                                                    tuple[dict, dict]], *,
                 pipelined: bool):
        self.model = model
        self._body = body
        self._pipelined = pipelined
        #: the bound optimizer state and the static batch buffers
        self.opt_state: dict | None = None
        self.batch: dict[str, torch.Tensor] | None = None
        self._binding: tuple | None = None
        #: bindings made (a new binding captures again in graph mode)
        self.bindings = 0
        self.graph: torch.cuda.CUDAGraph | None = None
        self._out: dict[str, torch.Tensor] | None = None
        #: launch counters' change over one step, added on every replay
        self.replay_launches: dict[tuple, int] = {}
        #: replays run (every call in graph mode but a binding's first)
        self.replays = 0

    @property
    def step_mode(self) -> str:
        ctx = self.model.ctx
        if (self.model.device.type == "cuda" and not self._pipelined
                and all(int(n) == 1 for n in ctx.axis_sizes.values())
                and instrument.ACTIVE is None):
            return "graph"
        return "eager"

    def __call__(self, opt_state: dict, batch: dict) -> tuple[dict, dict]:
        if self.step_mode == "eager":
            return self._body(opt_state, batch)
        self.load(opt_state, batch)
        if self.graph is None:
            metrics = self.capture()
        else:
            self.replay()
            # the next replay overwrites the graph's outputs
            metrics = {k: v.clone() for k, v in self._out.items()}
        return opt_state, metrics

    def _binding_of(self, opt_state: dict, batch: dict) -> tuple:
        leaves = (list(flatten_specs(self.model.params()).values())
                  + list(flatten_specs(opt_state["mu"]).values())
                  + list(flatten_specs(opt_state["nu"]).values())
                  + [opt_state["step"]])
        return (counters.addresses(leaves),
                tuple((k, tuple(v.shape), v.dtype)
                      for k, v in sorted(batch.items())))

    def load(self, opt_state: dict, batch: dict) -> None:
        """Bind the step to ``opt_state`` and ``batch``'s shapes unless it
        is bound to them already, then copy ``batch`` into the static
        buffers.  A new binding drops the captured graph."""
        binding = self._binding_of(opt_state, batch)
        if binding != self._binding:
            self.release()
            self._binding = binding
            self.opt_state = opt_state
            self.batch = {k: torch.empty_like(v, device=self.model.device)
                          for k, v in batch.items()}
            self.bindings += 1
        for k, v in batch.items():
            self.batch[k].copy_(v)

    def release(self) -> None:
        """Drop the binding, the captured graph and the graph's memory
        pool (the step's temporaries, held between replays); the next
        call binds and captures again."""
        self._binding = self.graph = self._out = None
        self.opt_state = self.batch = None
        self.replay_launches = {}
        if self.model.device.type == "cuda":
            torch.cuda.empty_cache()

    def run_eager(self) -> dict:
        """One step from Python over the bound state and the static
        buffers; returns its metrics."""
        _, metrics = self._body(self.opt_state, self.batch)
        return metrics

    def capture(self) -> dict:
        """The binding's first step, run eagerly on a side stream, then the
        step captured in a CUDA graph on that stream (the capture launches
        nothing).  The launch counters are set back to where they were
        before the capture and their change is kept for ``replay``.
        Returns the first step's metrics.  A failed capture raises; one
        cause is a live autograd graph of an earlier forward through the
        parameters on the default stream (a loss the caller keeps), whose
        AccumulateGrad nodes make the capture wait on that stream."""
        metrics, graph, out, self.replay_launches = counters.capture(
            self.run_eager, self.model.device)
        metrics = {k: v.clone() for k, v in metrics.items()}
        self.graph, self._out = graph, out
        return metrics

    def replay(self) -> None:
        """One step: the captured graph, and the launches it holds added
        to the kernels' counters."""
        counters.replay(self.graph, self.replay_launches)
        self.replays += 1


# ---------------------------------------------------------------------------
# Fault-tolerant loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    keep: int = 3
    max_retries: int = 3
    straggler_factor: float = 3.0       # step > factor * EWMA -> straggler
    ewma: float = 0.9
    managed_cadence: bool = False       # Young/Daly-chosen ckpt interval
    mtbf_s: float = 1800.0              # assumed mean time between failures


class TrainLoop:
    """Drives (step fn, data, checkpoints) with restart-on-failure.

    ``fault_hook(step)`` (tests) may raise to simulate a node failure, and
    ``fault_plan`` injects the deterministic fault taxonomy of
    core/faults.py; the loop restores the latest readable checkpoint into
    the model and the optimizer state and retries.  Step times feed a
    straggler detector.

    With ``managed_cadence`` the checkpoint interval is a managed knob:
    ``managed.resolve_checkpoint`` re-resolves the Young/Daly optimum
    between steps from the EWMA step time and checkpoint/metrics.py's
    measured write bandwidth / snapshot cost, logging each pick as a
    ``DecisionRecord(op="ckpt_interval")``: after the first post-warm-up
    step, on a drift of the EWMA above 25%, and (unlike the reference,
    whose first decision may price the default bandwidth for the whole
    run) once more when the first save has been measured.  A ``tuner``
    persists the winner (it rides along inside the checkpoint's
    ``extra``), and on an elastic resume — a checkpoint written on a
    different mesh — its whole arrays are cut to this rank's shards and
    every persisted tuner winner is replayed onto the new topology in one
    ``tuner.replan_for_mesh`` pass (``self.replayed`` keeps the trail).
    The checkpoint's on-device snapshot doubles the state's device memory
    (checkpoint/ckpt.py)."""

    def __init__(self, step_fn: Callable, model: Model,
                 opt_cfg: AdamWConfig, data: SyntheticLMData,
                 loop_cfg: TrainLoopConfig,
                 fault_hook: Callable[[int], None] | None = None, *,
                 tuner: tuner_lib.ScheduleTuner | None = None,
                 fault_plan: FaultPlan | None = None):
        self.step_fn = step_fn
        self.model = model
        self.opt_cfg = opt_cfg
        self.data = data
        self.cfg = loop_cfg
        self.tuner = tuner
        self.fault_plan = fault_plan
        self.ckpt_metrics = ckpt_lib.CheckpointMetrics()
        self.mgr = ckpt_lib.CheckpointManager(loop_cfg.ckpt_dir,
                                              keep=loop_cfg.keep,
                                              metrics=self.ckpt_metrics)
        hooks = [h for h in (
            fault_hook,
            fault_plan.train_hook(ckpt_dir=loop_cfg.ckpt_dir,
                                  settle=self.mgr.wait)
            if fault_plan is not None else None) if h is not None]
        self.fault_hook = (
            (lambda step: [h(step) for h in hooks]) if hooks else None)
        self.ckpt_interval = max(1, loop_cfg.ckpt_every)
        # the step-time EWMA and the cadence's re-resolution trigger:
        # resolve from the first post-warm-up measurement, then on a
        # sustained drift above 25%
        self.recal = Recalibrator(threshold=0.25, warmup=1,
                                  alpha=loop_cfg.ewma)
        self.ckpt_decisions: list = []       # CheckpointDecision trail
        self.replayed: list[dict] = []       # elastic replan records
        self._resolved_step_s: float | None = None
        #: whether the last cadence decision priced a measured save
        self._priced_measured = False
        self._mesh_axis = "mesh"
        self._mesh_size = 1
        for n in model.ctx.axis_sizes.values():
            self._mesh_size *= int(n)
        self.stragglers: list[int] = []
        self.restarts = 0
        self.history: list[dict] = []

    # -- state management ----------------------------------------------------

    def init_state(self, seed: int = 0) -> tuple[dict, int]:
        """Fresh weights from ``seed`` and a zero optimizer state:
        (opt_state, 0)."""
        gen = torch.Generator(device=self.model.device).manual_seed(seed)
        self.model.init(gen)
        return adamw_init(self.model.params(), self.opt_cfg), 0

    @torch.no_grad()
    def resume_or_init(self, seed: int = 0) -> tuple[dict, int]:
        """The newest readable checkpoint restored into the model, or a
        fresh state: (opt_state, step).  A checkpoint of whole arrays
        (written on a mesh where this rank held all of each) restores onto
        any mesh: each rank takes its shards."""
        opt, _ = self.init_state(seed)
        params = self.model.params()
        specs = flatten_specs(self.model.param_specs())

        def reshard(key: str, arr: Any) -> Any:
            # params/<name>, opt/mu/<name>, opt/nu/<name>: a whole array
            # of the checkpoint cut to this rank's block
            spec = specs.get(key.split("/", 2 if key.startswith("opt/")
                                       else 1)[-1])
            if spec is None or tuple(arr.shape) != tuple(spec.shape):
                return arr
            return shard_of(arr, spec, self.model.ctx)

        t0 = time.monotonic()
        hit = ckpt_lib.restore_latest(self.cfg.ckpt_dir,
                                      {"params": params, "opt": opt},
                                      reshard=reshard)
        if hit is None:
            return opt, 0
        tree, extra, ck_step = hit
        self.ckpt_metrics.note_restore(ck_step, time.monotonic() - t0)
        live = flatten_specs(params)
        for name, arr in flatten_specs(tree["params"]).items():
            live[name].copy_(arr)
        step = int(extra.get("step", ck_step))
        if "data" in extra:
            # the data pipeline resumes WITH the model
            self.data, _ = SyntheticLMData.resume(self.data.cfg,
                                                  extra["data"])
        if self.tuner is not None and "tuner" in extra:
            self.tuner.load_entries(extra["tuner"])
            mesh_now = self._mesh_dict()
            mesh_then = {k: int(v)
                         for k, v in extra.get("mesh", mesh_now).items()}
            if mesh_then != mesh_now:
                # elastic resume: N-way winners replayed onto M ranks
                sizes = dict(mesh_now)
                sizes[self._mesh_axis] = self._mesh_size
                self.replayed += tuner_lib.replan_for_mesh(
                    self.tuner, sizes,
                    step_s=self._resolved_step_s or 0.1,
                    mtbf_s=self.cfg.mtbf_s)
        return tree["opt"], step

    def _mesh_dict(self) -> dict[str, int]:
        return {k: int(v) for k, v in self.model.ctx.axis_sizes.items()}

    def _batch(self, step: int) -> dict:
        g = self.data.global_batch_at(step)
        return {k: torch.from_numpy(v).to(self.model.device)
                for k, v in g.items()}

    # -- managed checkpoint cadence -------------------------------------------

    def _resolve_cadence(self, step_s: float, snapshot_bytes: int) -> None:
        """Re-resolve the Young/Daly interval from live measurements: the
        EWMA step time plus checkpoint/metrics.py's measured write
        bandwidth, snapshot cost and restore time.  Logged as a
        DecisionRecord(op="ckpt_interval"); the winner persists via the
        tuner (riding along inside the next checkpoint)."""
        m = self.ckpt_metrics
        d = managed.resolve_checkpoint(
            self._mesh_axis, step_s, snapshot_bytes,
            mtbf_s=self.cfg.mtbf_s,
            measured_write_bw=m.write_bw_estimate(),
            measured_ckpt_cost_s=m.ckpt_cost_s_estimate(),
            measured_restore_s=m.restore_s_estimate())
        self.ckpt_interval = max(1, int(d.interval))
        self.ckpt_decisions.append(d)
        self._priced_measured = m.write_bw_estimate() is not None
        self._resolved_step_s = step_s
        self.recal.rebase(step_s)
        # re-meter the async drain's D2H chunking to the current step time
        self.mgr.drain_chunk_bytes = overlap.drain_chunk_bytes(
            step_s, d.write_bw)
        if self.tuner is not None:
            entry = self.tuner.decide_ckpt(
                self._mesh_axis, self._mesh_size, snapshot_bytes, step_s,
                mtbf_s=self.cfg.mtbf_s, write_bw=m.write_bw_estimate(),
                ckpt_cost_s=m.ckpt_cost_s_estimate(),
                restore_s=m.restore_s_estimate())
            cost = m.ckpt_cost_s_estimate()
            if cost is not None:
                # realized overhead of the cadence we actually ran
                tau = self.ckpt_interval * step_s
                overhead = (cost / tau
                            + (0.5 * tau + (m.restore_s_estimate() or 0.0))
                            / self.cfg.mtbf_s)
                self.tuner.record(entry.key, d.mode, self.ckpt_interval,
                                  overhead)

    def _save(self, step: int, opt: dict) -> None:
        extra = {"step": step, "data": self.data.state_dict(step),
                 "mesh": self._mesh_dict()}
        if self.tuner is not None:
            extra["tuner"] = json.loads(self.tuner.to_json())
        self.mgr.save_async(step, {"params": self.model.params(),
                                   "opt": opt}, extra=extra)

    # -- the loop ------------------------------------------------------------

    def run(self, opt: dict, start_step: int = 0) -> dict:
        cfg = self.cfg
        tr = get_tracer()
        step = start_step
        retries = 0
        warmup_until = start_step + 2
        last_saved = start_step
        steps_executed = 0
        wall_t0 = time.monotonic()
        snapshot_bytes = sum(
            t.numel() * t.element_size() for t in
            flatten_specs({"params": self.model.params(),
                           "opt": opt}).values())
        while step < cfg.total_steps:
            batch = self._batch(step)
            t0 = time.monotonic()
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)
                with tr.span("train.step", track="compute", step=step):
                    opt, metrics = self.step_fn(opt, batch)
                    # float() waits for the device — the span measures
                    # the realized step, not the launch
                    loss = float(metrics["loss"])
                if not math.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at {step}")
            except Exception:               # noqa: BLE001 — restart path
                retries += 1
                self.restarts += 1
                if retries > cfg.max_retries:
                    raise
                self.mgr.wait()
                opt, step = self.resume_or_init()
                last_saved = step
                # the first post-restore steps re-warm: judging them
                # against the pre-fault EWMA flags every recovery
                warmup_until = step + 2
                continue
            retries = 0
            steps_executed += 1
            dt = time.monotonic() - t0
            in_warmup = step < warmup_until
            ewma_t = self.recal.value
            if (not in_warmup and ewma_t is not None
                    and dt > cfg.straggler_factor * ewma_t):
                self.stragglers.append(step)
            if not in_warmup:
                # warm-up steps feed neither the EWMA nor the detector
                self.recal.note(dt)
            self.history.append({"step": step, "loss": loss,
                                 "time_s": dt})
            # re-resolve on the EWMA's drift, and once the first save has
            # been measured if the last decision priced the default
            # write bandwidth
            if cfg.managed_cadence and (
                    self.recal.should_retune()
                    or (self.ckpt_decisions and not self._priced_measured
                        and self.ckpt_metrics.write_bw_estimate()
                        is not None)):
                self._resolve_cadence(self.recal.value, snapshot_bytes)
            step += 1
            if step - last_saved >= self.ckpt_interval \
                    or step == cfg.total_steps:
                # scale = the train seconds this cadence amortizes one
                # checkpoint over, so dur/scale is the measured overhead
                # fraction — the unit resolve_checkpoint predicts
                with tr.span("ckpt.save", op="ckpt_interval",
                             axis=self._mesh_axis, track="ckpt",
                             nbytes=snapshot_bytes,
                             scale=self.ckpt_interval
                             * max(self.recal.value or dt, 1e-9)):
                    self._save(step, opt)
                last_saved = step
        self.mgr.wait()
        return {"params": self.model.params(), "opt": opt, "step": step,
                "history": self.history, "stragglers": self.stragglers,
                "restarts": self.restarts,
                "steps_executed": steps_executed,
                "wall_s": time.monotonic() - wall_t0,
                "ckpt_interval": self.ckpt_interval,
                "replayed": self.replayed}
