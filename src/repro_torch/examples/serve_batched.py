"""Batched serving example — the managed serving runtime end to end (port
of ``examples/serve_batched.py``).

Submits a queue of mixed-length requests to the ServeEngine (paged KV
cache and slot-indexed SSM state, continuous batching; serve/) instead of
hand-rolling a prefill/decode loop, prints each request's greedy
completion, and shows the serve-schedule decision the managed runtime
made for the queue.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched [arch] \\
        [--device cpu]

The arch is reduced (default mamba2-130m); its weights are random from
seed 0.  Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import managed
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.parallel.sharding import MeshCtx
from repro_torch.serve.engine import ServeEngine

PROMPT_LENS = (8, 3, 12, 5)
NEW_TOKENS = 16


def run(arch: str = "mamba2-130m", *, device: str = "cuda"
        ) -> tuple[ServeEngine, list[np.ndarray], dict[int, np.ndarray],
                   list[int]]:
    """Serve the four prompts on reduced ``arch``: (engine, prompts,
    results by rid, rids)."""
    cfg = configs.get_reduced(arch)
    dev = resolve_device(device)
    model = Model(cfg, MeshCtx({"data": 1, "model": 1}, mdmp_mode="auto"),
                  device=dev).init(torch.Generator(device=dev)
                                   .manual_seed(0))
    engine = ServeEngine(model, slots=2, max_seq=64, page_size=8,
                         schedule="auto")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size - 1, size=p).astype(np.int32)
               for p in PROMPT_LENS]
    rids = [engine.submit(p, NEW_TOKENS) for p in prompts]
    return engine, prompts, engine.run(), rids


def main(argv: list[str] | None = None) -> dict[int, np.ndarray]:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch", nargs="?", default="mamba2-130m",
                    choices=configs.list_archs())
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    engine, prompts, out, rids = run(args.arch, device=args.device)
    for i, rid in enumerate(rids):
        print(f"request {rid}: prompt={prompts[i].tolist()} "
              f"-> {out[rid].tolist()}")
    s = engine.metrics.summary()
    print(f"{s['useful_tok_s']:.1f} useful tok/s over {s['quanta']} quanta, "
          f"occupancy {s['occupancy']:.2f}")
    for rec in managed.decision_log():
        if rec.op == "serve_schedule":
            print(f"managed decision: serve_schedule({rec.mode}, "
                  f"C={rec.chunks})")
    return out


if __name__ == "__main__":
    main()
