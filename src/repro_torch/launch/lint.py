"""mdmplint CLI — run the static communication verifier standalone (port
of ``repro.launch.lint``).

    # lint a training launch (no devices needed — pure geometry):
    PYTHONPATH=src python -m repro_torch.launch.lint --target train \
        --arch granite-34b --reduced --mesh 2x2x2 --pipeline 1f1b \
        --batch 8 --seq 128

    # lint a serving launch:
    PYTHONPATH=src python -m repro_torch.launch.lint --target serve \
        --arch mamba2-130m --reduced --slots 4

    # lint a corpus case (tests/lint_corpus/*.json):
    PYTHONPATH=src python -m repro_torch.launch.lint \
        --case tests/lint_corpus/nonbijective_permute.json -v

Exit status 1 iff any error-severity diagnostic — the CI gate greps the
``MDMPxxx`` line prefixes and trusts the status.  ``--plan FILE`` loads
a stored ProgramPlan JSON (core/tuner.store_program_plan) instead of
re-planning, so the lint runs against the knobs a previous launch
actually installed.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch import analysis


def _mesh_axes(spec: str | None, pipeline: str) -> dict[str, int]:
    if spec:
        dims = tuple(int(x) for x in spec.split("x"))
        axes = (("pod", "data", "model") if len(dims) == 3
                else ("data", "model"))
        return dict(zip(axes, dims))
    if pipeline != "none":
        return {"pod": 2, "data": 1, "model": 1}
    return {"data": 2, "model": 1}


def _train_graph(args, hw, plan) -> analysis.CommGraph:
    from repro_torch import configs
    from repro_torch.plan import lower_train_ops, plan_program, train_geometry
    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get_config(args.arch))
    mesh_axes = _mesh_axes(args.mesh, args.pipeline)
    geo = train_geometry(cfg, mesh_axes=mesh_axes, batch=args.batch,
                         seq=args.seq, hw=hw, pipeline=args.pipeline)
    ops = lower_train_ops(
        mesh_axes=geo["mesh_axes"], grad_bytes=geo["grad_bytes"],
        pipeline=geo["pipeline"], attention=geo["attention"],
        moe=geo["moe"])
    if plan is None:
        plan = plan_program(ops, hw=hw,
                            notes=[f"launch.lint {args.arch}"])
    return analysis.from_ops(
        f"train:{args.arch}", axis_sizes=mesh_axes, declared=ops,
        plan=plan, hw=hw)


def _serve_graph(args, hw, plan) -> analysis.CommGraph:
    from repro_torch import configs
    from repro_torch.plan import CommOp, plan_program
    import numpy as np
    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get_config(args.arch))
    ib = int(np.dtype("float32").itemsize)
    n_params = float(cfg.param_count())
    # per-page KV bytes across layers — the same order the engine
    # allocates; lint only needs the magnitude, not the exact pool
    page_bytes = 2 * cfg.n_layers * args.page_size * cfg.d_model * ib
    mean_prompt = (args.prompt_len + 4) / 2.0
    mean_pages = max(1, (args.prompt_len + args.new_tokens
                         + args.page_size - 1) // args.page_size)
    ops = [
        CommOp(kind="serve", label="serve.schedule",
               op_name="serve_schedule", axis="serve",
               axis_size=args.slots, nbytes=int(n_params) * ib,
               dtype_bytes=ib, phase="serve",
               meta={"batch_slots": args.slots,
                     "mean_prompt": mean_prompt,
                     "mean_new": float(args.new_tokens),
                     "max_prompt": float(args.prompt_len),
                     "n_params": n_params}),
        CommOp(kind="preempt", label="serve.preempt",
               op_name="preempt_policy", axis="serve",
               axis_size=args.slots, nbytes=int(page_bytes),
               dtype_bytes=ib, phase="serve",
               meta={"batch_slots": args.slots,
                     "page_bytes": int(page_bytes),
                     "mean_pages": mean_pages,
                     "replay_tokens": args.prompt_len,
                     "n_params": n_params}),
    ]
    if plan is None:
        plan = plan_program(ops, hw=hw,
                            notes=[f"launch.lint serve {args.arch}"])
    return analysis.from_ops(
        f"serve:{args.arch}", axis_sizes={"serve": args.slots},
        declared=ops, plan=plan, hw=hw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.lint")
    ap.add_argument("--case", default=None,
                    help="lint-corpus JSON case instead of a launch "
                         "config")
    ap.add_argument("--target", default="train",
                    choices=("train", "serve"))
    ap.add_argument("--arch", default=None)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh", default=None, help="e.g. 2x2x2")
    ap.add_argument("--pipeline", default="none",
                    choices=("none", "gpipe", "1f1b", "interleaved",
                             "auto"))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--plan", default=None,
                    help="stored ProgramPlan JSON to lint against "
                         "(default: re-plan from the geometry)")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="print declared/traced side-by-side + fix "
                         "hints")
    args = ap.parse_args(argv)

    from repro_torch.core import managed
    hw = managed.get_config().hw
    plan = None
    if args.plan:
        from repro_torch.plan import ProgramPlan
        with open(args.plan) as f:
            plan = ProgramPlan.from_dict(json.load(f))

    if args.case:
        with open(args.case) as f:
            case = json.load(f)
        graph = analysis.from_corpus(case, hw=hw)
        if plan is not None:
            graph.plan = plan
    else:
        if not args.arch:
            ap.error("--arch is required without --case")
        graph = (_train_graph(args, hw, plan) if args.target == "train"
                 else _serve_graph(args, hw, plan))

    diags = analysis.run_all(graph)
    out = analysis.render(diags, verbose=args.verbose)
    if out:
        print(out)
    print(analysis.summary(diags, graph.name))
    return analysis.exit_code(diags)


if __name__ == "__main__":
    sys.exit(main())
