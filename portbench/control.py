"""The readings that the limits of ``correct`` are set from, on the card at
a cell's own size, in one process: the program's numbers over many seeds
(the lower readings) and the control's (the reference with its weight
products in float8, the nearest precision below the configurations'
bfloat16; the upper readings).  The benchmark's own runs never run this.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--seconds <s>]

One JSON line a seed.  Each seed runs the cell as a run does, with a window
of ``--seconds`` (the benchmark's ``run_seconds`` unless given), and
compares as many requests as a run does.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _free() -> None:
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def main(argv: list[str]) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=None)
    args = p.parse_args(argv)
    import torch
    from portbench import check, harness
    spec = harness.load_spec()
    cell, conf, mix = harness.cell_inputs(spec, args.workload)
    kind = harness.runner(mix)
    device = torch.device("cuda", 0)
    seeds = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    ctl = set(seeds(args.control_seeds))
    seconds = (spec["run_seconds"] if args.seconds is None
               else args.seconds)
    for seed in sorted(set(seeds(args.seeds)) | ctl):
        rc = harness.RunContext(cell=cell, conf=conf, mix=mix, seed=seed,
                                seconds=seconds, trace=False, device=device,
                                t_start=time.perf_counter())
        res = kind.run(rc)
        res.pop("obs", None)
        _free()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        out = {"seed": seed, "failed": res["failed"],
               "attempted": res["attempted"]}
        out.update(check.serve_gaps(conf["arch"], seed, device,
                                    res["sample"], control=seed in ctl))
        print(json.dumps(out), flush=True)
        del res
        _free()
    return 0


if __name__ == "__main__":
    sys.path[:] = [p for p in sys.path
                   if os.path.abspath(p or os.curdir) != HERE]
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    sys.exit(main(sys.argv[1:]))
