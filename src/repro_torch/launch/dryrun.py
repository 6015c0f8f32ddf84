"""Multi-pod dry run: count one rank's step of every (arch x shape x mesh)
cell without a card (port of ``repro.launch.dryrun``).

For each cell this runs the REAL step (the train step for train_4k, the
prefill for prefill_32k, the contiguous decode step for decode_32k /
long_500k) ONCE on abstract (``meta``) tensors of the production mesh's
per-rank shapes, under launch/hlo.py's counter, and records

  * memory        — the step's peak live bytes on one rank,
  * flops / bytes — the roofline's device terms,
  * collective link bytes — from the transport's calls, by kind,

into a JSON artifact with the reference's record schema
(``benchmarks/roofline.py`` reads it).  ``lower_s`` is the seconds of
setting the cell up (the group, the model on meta tensors), ``compile_s``
those of the counted step.

The mesh: the reference compiles its SPMD module over 512 placeholder
XLA devices.  The port's code is per rank, so the placeholder devices are
a fake process group (``torch.distributed``'s ``fake`` backend, which
moves nothing) of 256 or 512 ranks, started here with rank 0 and the
world size, and a ``DeviceMesh`` over it gives ``MeshCtx.from_mesh`` its
groups.  The record is RANK 0's step.  The group is torn down before
``lower_cell`` returns, and no environment variable is set; if a process
group is already up, the dry run raises (it never joins a real one).

Abstract tensors stand for the card: every kernel wrapper takes its card
branch, refuses what the card refuses (the operand checks are the
card's) and counts one launch with its work function; no
plain version runs, nothing is allocated on a card or launched.  Sizes
that depend on data are counted at their shape's bound: the grouped
expert FFN and its backward at their capacity rows (what the reference's
jnp engine computes), the contiguous decode at the shape's full context (the cache's
every position, as its attention reads them).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b \\
      --shape train_4k [--multipod] [--out results/dryrun.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multipod]

Incremental: cells already ``ok`` in --out are skipped unless --force.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Iterator

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      shape_applicable)
from repro_torch.core import managed
from repro_torch.core.instrument import Spec
from repro_torch.launch import hlo
from repro_torch.launch.mesh import AXES, POD_AXES, parse_mesh
from repro_torch.models.model import DTYPES, Model
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.parallel.sharding import MeshCtx


def input_specs(cfg: ModelConfig, shape: ShapeConfig, kind: str) -> dict:
    """Specs of every GLOBAL model input of this cell (the reference's
    ``ShapeDtypeStruct`` stand-ins): tokens (and labels) [B, S] int32, and
    the audio model's frames / the vision model's patches."""
    b, s = shape.global_batch, shape.seq_len
    tok = Spec((b, s), torch.int32)
    out: dict = {}
    if kind == "train":
        out = {"tokens": tok, "labels": tok}
    elif kind == "prefill":
        out = {"tokens": tok}
    if kind in ("train", "prefill"):
        if cfg.encoder is not None:
            out["frames"] = Spec((b, cfg.encoder.n_frames, cfg.d_model),
                                 DTYPES[cfg.dtype])
        if cfg.vision is not None:
            out["patches"] = Spec((b, cfg.vision.n_patches, cfg.d_model),
                                  DTYPES[cfg.dtype])
    return out


def mesh_dims(multi_pod: bool, mesh_shape: str | None
              ) -> tuple[tuple[int, ...], tuple[str, ...], str]:
    """(dims, axis names, name) of the production mesh or of
    ``mesh_shape`` ("DxM" or "PxDxM")."""
    if mesh_shape:
        return (*parse_mesh(mesh_shape), mesh_shape)
    if multi_pod:
        return (2, 16, 16), POD_AXES, "2x16x16"
    return (16, 16), AXES, "16x16"


@contextlib.contextmanager
def fake_mesh(dims: tuple[int, ...], axes: tuple[str, ...],
              mdmp_mode: str = "bulk") -> Iterator[MeshCtx]:
    """Rank 0's ``MeshCtx`` of a mesh of ``dims``: over a fake process
    group of that many ranks (torn down on exit), or with no group at one
    rank."""
    n = math.prod(dims)
    if n == 1:
        yield MeshCtx(axis_sizes=dict(zip(axes, dims)), mdmp_mode=mdmp_mode)
        return
    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake process group; "
                           "one is already up in this process")
    # importing the module registers the "fake" backend
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        mesh = init_device_mesh("cpu", dims, mesh_dim_names=axes)
        yield MeshCtx.from_mesh(mesh, mdmp_mode=mdmp_mode)
    finally:
        dist.destroy_process_group()


def _abstract(spec: Spec) -> torch.Tensor:
    return torch.empty(tuple(spec.shape), dtype=spec.dtype, device="meta")


def count_step(cfg: ModelConfig, shape: ShapeConfig, ctx: MeshCtx,
               **model_kw: Any) -> hlo.OpCounter:
    """Build ``cfg``'s model and the step's arguments on abstract tensors
    (counted as its arguments), run the step of ``shape.kind`` once for
    the rank of ``ctx``, and return the counter.  ``model_kw`` goes to
    ``Model`` (``attn_engine="torch"`` pins the plain attention, as a
    test holds the kernel path against it)."""
    counter = hlo.OpCounter({id(g): ax for ax, g in ctx.groups.items()})
    with counter.recording():
        model = Model(cfg, ctx, device="meta", **model_kw)
        if shape.kind == "train":
            from repro_torch.train.train_loop import build_train_step
            ocfg = AdamWConfig(moment_dtype=cfg.moment_dtype)
            step = build_train_step(model, ocfg,
                                    global_batch=shape.global_batch,
                                    seq_len=shape.seq_len)
            opt = adamw_init(model.params(), ocfg)
            batch = {k: _abstract(v)
                     for k, v in input_specs(cfg, shape, "train").items()}
            counter.start()
            counter.stop(step(opt, batch))
        elif shape.kind == "prefill":
            from repro_torch.train.serve_loop import build_prefill_step
            step = build_prefill_step(model)
            batch = ctx.shard_batch({k: _abstract(v) for k, v in input_specs(
                cfg, shape, "prefill").items()})
            counter.start()
            counter.stop(step(batch))
        else:
            from repro_torch.train.serve_loop import build_decode_step
            step, specs = build_decode_step(model, shape)

            def alloc(entry):
                return {k: torch.empty(s, dtype=dt, device="meta")
                        for k, (s, dt) in entry.items()}
            cache = ([alloc(e) for e in specs] if isinstance(specs, list)
                     else alloc(specs))
            token = torch.empty((shape.global_batch,), dtype=torch.int32,
                                device="meta")
            # the position a 0-d int32 tensor, as the step takes it on the
            # card (the reference's traced [] int32); the owner test and
            # the masks run on the device whatever its value
            pos = torch.zeros((), dtype=torch.int32, device="meta")
            counter.start()
            counter.stop(step(cache, token, pos))
    return counter


def lower_cell(arch: str, shape_name: str, multi_pod: bool, *,
               mdmp_mode: str = "bulk", mesh_shape: str | None = None,
               accum_override: int | None = None,
               remat_override: bool | None = None,
               attn_impl: str | None = None,
               fsdp_dtype: str | None = None) -> dict:
    """Count one cell; returns the record dict.

    ``mesh_shape`` (e.g. "256x1", "64x4") re-roles the chips into another
    (data, model) split; ``mdmp_mode`` runs the managed collectives bulk
    or as interleaved rings; ``fsdp_dtype`` quantises the FSDP gather's
    payload (the reference's ``--fsdp-dtype``, set for this cell only)."""
    cfg = configs.get_config(arch)
    if accum_override is not None:
        cfg = dataclasses.replace(cfg, accum_steps=accum_override)
    if remat_override is not None:
        cfg = dataclasses.replace(cfg, remat=remat_override)
    if attn_impl:
        cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"status": "skipped", "reason": reason}

    dims, axes, mesh_name = mesh_dims(multi_pod, mesh_shape)
    mcfg = dataclasses.replace(managed.get_config(),
                               fsdp_gather_dtype=fsdp_dtype)
    t0 = time.monotonic()
    with fake_mesh(dims, axes, mdmp_mode) as ctx, managed.use_config(mcfg):
        counter = count_step(cfg, shape, ctx)
    t_count = counter.seconds
    t_setup = time.monotonic() - t0 - t_count

    rec = hlo.analyze_compiled(counter, math.prod(dims))
    rec.update({
        "status": "ok",
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "mdmp_mode": mdmp_mode,
        "kind": shape.kind,
        "lower_s": round(t_setup, 1),
        "compile_s": round(t_count, 1),
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    })
    print(f"[dryrun] {arch} {shape_name} {mesh_name}"
          f" OK  flops/chip={rec['flops_per_chip']:.3e}"
          f" hbm/chip={rec['hbm_bytes_per_chip']:.3e}"
          f" coll/chip={rec['collective_bytes_per_chip']:.3e}"
          f" peak_mem={rec['memory'].get('peak_bytes', 0) / 2**30:.2f}GiB"
          f" (setup {t_setup:.1f}s count {t_count:.1f}s)", flush=True)
    return rec


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="results/dryrun.json")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--mdmp-mode", default="bulk")
    ap.add_argument("--mesh-shape", default=None,
                    help="re-role the chips, e.g. 256x1 or 64x4")
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--attn-impl", default=None,
                    help="megatron | ulysses | ring")
    ap.add_argument("--fsdp-dtype", default=None,
                    help="quantised FSDP gather payload, e.g. float8_e4m3fn")
    ap.add_argument("--tag", default="",
                    help="suffix for the result key (perf experiments)")
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results: dict[str, Any] = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    archs = configs.list_archs() if (args.all or not args.arch) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multipod]

    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                mesh_name = args.mesh_shape or \
                    ("2x16x16" if mp else "16x16")
                key = f"{arch}|{shape_name}|{mesh_name}{args.tag}"
                if key in results and results[key].get("status") == "ok" \
                        and not args.force:
                    print(f"[dryrun] {key} cached, skipping")
                    continue
                try:
                    results[key] = lower_cell(
                        arch, shape_name, mp, mdmp_mode=args.mdmp_mode,
                        mesh_shape=args.mesh_shape,
                        accum_override=args.accum,
                        remat_override=(False if args.no_remat else None),
                        attn_impl=args.attn_impl,
                        fsdp_dtype=args.fsdp_dtype)
                    if args.tag:
                        results[key]["mesh"] = mesh_name + args.tag
                except Exception as e:     # record failures for triage
                    results[key] = {"status": "error",
                                    "error": f"{type(e).__name__}: {e}"}
                    print(f"[dryrun] {key} ERROR: {e}")
                    traceback.print_exc()
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=2)

    n_ok = sum(1 for r in results.values() if r.get("status") == "ok")
    n_skip = sum(1 for r in results.values() if r.get("status") == "skipped")
    n_err = sum(1 for r in results.values() if r.get("status") == "error")
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped (documented), "
          f"{n_err} errors -> {args.out}")
    return results


if __name__ == "__main__":
    main()
