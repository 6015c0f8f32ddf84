"""Serving CLI — the managed serving runtime on one CUDA card
(port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \\
        --reduced --device cpu

Runs on ``cuda`` unless ``--device cpu`` is given, and raises when no card
is there.  Weights are random, drawn from ``--seed`` (over a mesh each
rank draws its shards).  ``--mesh DxM`` above 1x1 runs one process per
rank under torchrun (the page pool sharded over the cache axes;
launch/mesh.py).  ``--schedule
static`` reproduces the unmanaged baseline (padded waves); ``continuous``
pins continuous batching; ``auto`` lets the managed runtime pick mode +
scheduling quantum from the serve cost model and correct it online.
Prompt lengths are MIXED (--prompt-len down to --min-prompt-len).

Overload knobs: ``--pages`` under-provisions the KV page pool so
optimistic admission needs its preemption backstop (``--preempt``);
``--slo-ttft`` / ``--max-queue`` turn on SLO shedding and queue
backpressure; ``--fault-plan 'burst@3:16'`` injects a deterministic
arrival flood.  ``--plan program|auto`` runs the whole-program planner
over the serving communication set (schedule + preempt knobs) and
installs the plan; ``--verify warn|strict`` (default ``warn``) runs the
static verifier over it; ``--trace PATH`` records every quantum, swap
and preemption to a Chrome-trace JSON with the calibration ledger.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs, obs
from repro_torch.core import instrument, managed
from repro_torch.core.faults import FaultPlan
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.launch import mesh as launch_mesh
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import RequestRejected


def main(argv: list[str] | None = None) -> dict:
    """Run the launch; returns the engine and each request's tokens (None
    for a request shed at the door)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--min-prompt-len", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--pages", type=int, default=None,
                    help="page-pool size (default slots*max_seq worth; "
                    "smaller values exercise the preemption backstop)")
    ap.add_argument("--schedule", default="auto",
                    choices=("static", "continuous", "auto"))
    ap.add_argument("--chunk", type=int, default=None,
                    help="pin the scheduling quantum C")
    ap.add_argument("--preempt", default="auto",
                    choices=("swap", "recompute", "auto"),
                    help="pool-exhaustion policy (auto = cost model)")
    ap.add_argument("--slo-ttft", type=float, default=None,
                    help="TTFT SLO in seconds (estimates beyond it shed)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="pending-queue bound (backpressure shedding)")
    ap.add_argument("--fault-plan", default=None,
                    help="e.g. 'burst@3:16;pool_squeeze@5:0.5'")
    ap.add_argument("--plan", default="local",
                    choices=("local", "program", "auto"),
                    help="communication planning scope: 'program'/'auto' "
                         "run the whole-program planner over the serving "
                         "comm set (schedule + preempt knobs) and install "
                         "the coordinated ProgramPlan before the run")
    ap.add_argument("--mdmp-mode", default="auto")
    ap.add_argument("--mesh", default="1x1",
                    help="DxM or PxDxM; above 1x1 under torchrun with a "
                         "matching WORLD_SIZE")
    ap.add_argument("--verify", default="warn",
                    choices=("off", "warn", "strict"),
                    help="static-verifier preflight (repro_torch.analysis):"
                         " 'warn' prints findings and logs a "
                         "DecisionRecord(op=\"lint\"); 'strict' exits "
                         "non-zero on any error")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record every quantum/swap/preemption to a "
                         "Chrome-trace JSON (open in ui.perfetto.dev), "
                         "print the predicted-vs-measured calibration "
                         "report, and embed the ledger in the file")
    args = ap.parse_args(argv)

    if args.trace:
        # install before the engine resolves anything so admission,
        # preflight and every quantum land on one ring
        obs.install_tracer(obs.Tracer())

    device = resolve_device(args.device)
    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get_config(args.arch))
    ctx = launch_mesh.mesh_ctx(args.mesh, device, args.mdmp_mode)
    say = print if launch_mesh.is_main() else (lambda *a, **k: None)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = Model(cfg, ctx, device=device).init(gen)

    plan = (FaultPlan.parse(args.fault_plan) if args.fault_plan
            else None)
    engine = ServeEngine(model, slots=args.slots,
                         max_seq=args.max_seq, page_size=args.page_size,
                         n_pages=args.pages, schedule=args.schedule,
                         chunk=args.chunk, fault_plan=plan,
                         preempt=args.preempt,
                         slo_ttft_s=args.slo_ttft,
                         max_queue=args.max_queue)
    prog = None
    if args.plan != "local" or args.verify != "off":
        # Lower the serving comm set once — the whole-program planner
        # (--plan) and the static-verifier preflight (--verify) both
        # consume it.
        from repro_torch.plan import CommOp, plan_program
        n_params = float(cfg.param_count())
        ib = instrument.itemsize(cfg.dtype)
        lo0 = min(args.min_prompt_len, args.prompt_len)
        mean_prompt = (lo0 + args.prompt_len) / 2.0
        mean_pages = max(1, (args.prompt_len + args.new_tokens
                             + args.page_size - 1) // args.page_size)
        ops = [
            CommOp(kind="serve", label="serve.schedule",
                   op_name="serve_schedule", axis="serve",
                   axis_size=args.slots,
                   nbytes=int(n_params) * ib, dtype_bytes=ib,
                   phase="serve",
                   meta={"batch_slots": args.slots,
                         "mean_prompt": mean_prompt,
                         "mean_new": float(args.new_tokens),
                         "max_prompt": float(args.prompt_len),
                         "n_params": n_params}),
            CommOp(kind="preempt", label="serve.preempt",
                   op_name="preempt_policy", axis="serve",
                   axis_size=args.slots,
                   nbytes=int(engine._page_bytes), dtype_bytes=ib,
                   phase="serve",
                   meta={"batch_slots": args.slots,
                         "page_bytes": int(engine._page_bytes),
                         "mean_pages": mean_pages,
                         "replay_tokens": args.prompt_len,
                         "n_params": n_params}),
        ]
        prog = plan_program(ops, notes=[f"launch.serve {args.arch}"])
        if args.plan != "local":
            kind = "coordinated" if prog.coordinated else "local"
            say(f"decision program_plan({kind} ops={len(prog.choices)} "
                f"topo={prog.topology} "
                f"local-concat={prog.local_solo_sum_s * 1e6:.1f}us "
                f"joint={prog.joint_cost_s * 1e6:.1f}us)")
            for line in prog.summary().splitlines()[1:]:
                say(f"  trail{line}")
            managed.install_plan(prog)
        if args.verify != "off":
            # Static-verifier preflight over the serving comm set under
            # the knobs this launch will run.
            from repro_torch import analysis
            graph = analysis.from_ops(
                f"serve:{args.arch}", axis_sizes={"serve": args.slots},
                declared=ops, plan=prog)
            analysis.preflight(graph, args.verify, out=say)
    rng = np.random.default_rng(0)
    lo = min(args.min_prompt_len, args.prompt_len)
    plens = rng.integers(lo, args.prompt_len + 1, size=args.requests)
    rids = []
    for p in plens:
        prompt = rng.integers(0, cfg.vocab_size - 1,
                              size=int(p)).astype(np.int32)
        try:
            rids.append(engine.submit(prompt, args.new_tokens))
        except RequestRejected as e:          # shed at the door
            say(f"shed: {e}")
            rids.append(None)

    t0 = time.perf_counter()
    out = engine.run()
    dt = time.perf_counter() - t0
    served = sum(len(v) for v in out.values())
    total = int(sum(int(plens[i]) for i, r in enumerate(rids)
                    if r is not None)) + served
    s = engine.metrics.summary()
    say(f"{total} tokens in {dt:.2f}s ({total / dt:.1f} tok/s end-to-end; "
          f"{s['useful_tok_s']:.1f} useful tok/s, occupancy "
          f"{s['occupancy']:.2f}, batch {args.slots} slots)")
    say(f"TTFT {s['mean_ttft_s'] * 1e3:.1f}ms  TPOT "
          f"{s['mean_tpot_s'] * 1e3:.2f}ms  quanta {s['quanta']}  "
          f"pages high-water {engine.pt.high_water}/"
          f"{engine.cache_cfg.n_pages}")
    say(f"overload: sheds {s['sheds']}  preempts {s['preempts']}  "
          f"swap {s['swap_bytes']} B  p99 TTFT "
          f"{s['p99_ttft_s'] * 1e3:.1f}ms")
    if args.slo_ttft is not None:
        met = engine.metrics.slo_met_tokens(args.slo_ttft)
        say(f"SLO-goodput: {met} tokens within "
              f"{args.slo_ttft * 1e3:.0f}ms TTFT "
              f"({met / dt:.1f} tok/s)")
    for rec in managed.decision_log():
        if rec.op == "serve_schedule":
            say(f"decision serve_schedule({rec.mode}, C={rec.chunks}) "
                  f"pred static={rec.predicted_bulk_s * 1e6:.1f}us/tok "
                  f"chosen={rec.predicted_interleaved_s * 1e6:.1f}us/tok")
        elif rec.op == "preempt_policy":
            say(f"decision preempt_policy({rec.mode}, "
                  f"pages={rec.chunks}, {rec.nbytes} B) "
                  f"pred recompute={rec.predicted_bulk_s * 1e3:.2f}ms "
                  f"chosen={rec.predicted_interleaved_s * 1e3:.2f}ms")
    for i, r in enumerate(rids[:4]):
        if r is not None and r in out:
            say(f"  req{i} (P={int(plens[i])}): {out[r].tolist()}")
    if args.trace:
        tr = obs.get_tracer()
        decisions = managed.decision_log()
        # decisions made inside the decode step (attention modes) have no
        # span of their own — the quantum span covers the work they chose
        obs.cover_with(tr.spans(), "serve.quantum",
                       (r.op for r in decisions))
        led = obs.CalibrationLedger()
        led.correlate(tr.spans(), decisions)
        say(led.report())
        if launch_mesh.is_main():
            obs.write_chrome_trace(
                args.trace, tr, decisions,
                other_data={"run": f"serve:{args.arch}",
                            "calibration": led.snapshot()})
        say(f"trace: {args.trace} ({tr.n_spans} spans, "
            f"{len(decisions)} decisions, "
            f"coverage {led.coverage() * 100:.0f}%)")
    return {"engine": engine,
            "tokens": [None if r is None else out.get(r) for r in rids]}


if __name__ == "__main__":
    main()
