"""The dry run (``repro_torch.launch.dryrun``) against the reference's
``lower_cell``.

The reduced phi4-mini, mamba2-130m and moonshot configs go through train,
prefill and decode on a fake 2x4 group (rank 0's step on meta tensors)
and through the reference's compile on its 2x4 mesh, in ONE subprocess
for the module (importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to
512 devices, so it has an environment of its own); it starts with the
module and runs while the port's cells are counted here.

What is held, and why the gaps that remain are what they are:

  * the records carry the reference's keys, and the same skip reasons;
  * collective link bytes by kind.  XLA:CPU runs a bf16 collective in
    f32, so the reference's bytes are the port's with bf16 elements
    counted at 4 bytes; and the reference's analyzer counts a tuple
    all-to-all by its largest element, one of its n blocks.  With those
    two conversions prefill and decode agree within ``COLL_RTOL`` (XLA
    combines and deduplicates a few small gathers and reductions).  A
    training step moves more in the port: ``torch.utils.checkpoint``
    re-runs each block's FSDP and sequence gathers in the recompute, and
    the bulk ``all_gather_matmul_multi`` backward gathers x once per
    weight, where XLA deduplicates identical gathers (``TRAIN_COLL``);
  * FLOPs with the kernels pinned to their plain versions: prefill
    exactly; decode exactly once the reference's one-hot embedding
    product (the port's lookup is a gather) is added; a training step
    within ``TRAIN_FLOPS``: XLA drops the remat recompute whose result the
    backward does not read and merges the flash backward's recomputed
    logits with the remat forward's, where the eager checkpoint recomputes
    the whole block;
  * the kernel path's FLOPs equal the plain path's less the masked work
    the work functions skip, computed from each launch's shapes, with the
    grouped FFN's backward counted as its kernel's work in place of the
    plain path's autograd products.
"""

import json
import math
import os
import pathlib
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import grouped_matmul as gm
from repro_torch.kernels import ops, paged_attention, ref
from repro_torch.launch import dryrun, hlo

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("phi4-mini-3.8b", "mamba2-130m", "moonshot-v1-16b-a3b")
SHAPES = {"train_4k": ShapeConfig("train_4k", 256, 8, "train"),
          "prefill_32k": ShapeConfig("prefill_32k", 256, 8, "prefill"),
          "decode_32k": ShapeConfig("decode_32k", 256, 8, "decode"),
          "long_500k": ShapeConfig("long_500k", 512, 1, "decode")}
CELLS = [(a, s) for a in ARCHS for s in ("train_4k", "prefill_32k",
                                         "decode_32k")]
#: prefill / decode link bytes by kind against the reference's
COLL_RTOL = 0.03
#: a training step's link bytes / FLOPs against the reference's: (lowest,
#: highest) ratio by kind
TRAIN_COLL = {"all-gather": (1.0, 2.5), "reduce-scatter": (1.0, 1.2),
              "all-reduce": (1.0, 1.2), "all-to-all": (1.0, 1.0),
              "collective-permute": (1.0, 1.0)}
TRAIN_FLOPS = (1.0, 1.10)

REFERENCE = r"""
import concurrent.futures, json, sys
import repro.launch.dryrun as dr
from repro import configs
from repro.configs.base import ShapeConfig
configs.get_config = configs.get_reduced
dr.SHAPES = {name: ShapeConfig(name, s, b, kind)
             for name, (s, b, kind) in json.loads(sys.argv[1]).items()}
cells = json.loads(sys.argv[2])
def run(cell):
    rec = dr.lower_cell(cell[0], cell[1], False, mesh_shape="2x4")
    return "|".join(cell), rec
# the compiles release the GIL: four at a time
with concurrent.futures.ThreadPoolExecutor(4) as ex:
    out = dict(ex.map(run, cells))
sys.stdout.write("\nRESULT " + json.dumps(out) + "\n")
"""


@pytest.fixture(scope="module", autouse=True)
def reference():
    """The reference's records, computed in a subprocess that starts with
    the module; ``reference()`` waits for them."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    cells = CELLS + [("phi4-mini-3.8b", "long_500k"),
                     ("moonshot-v1-16b-a3b", "long_500k")]
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE,
         json.dumps({k: (v.seq_len, v.global_batch, v.kind)
                     for k, v in SHAPES.items()}), json.dumps(cells)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    got = {}

    def wait():
        if not got:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
            got.update(json.loads(line[-1][len("RESULT "):]))
        return got

    yield wait
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


_PORT: dict = {}


def port(arch, shape, mesh="2x4", engine="auto"):
    """The port's record and counter of one reduced cell (memoised);
    ``engine="torch"`` pins the plain attention and grouped FFN."""
    key = (arch, shape, mesh, engine)
    if key not in _PORT:
        dims, axes, _ = dryrun.mesh_dims(False, mesh)
        with dryrun.fake_mesh(dims, axes) as ctx:
            counter = dryrun.count_step(
                configs.get_reduced(arch), SHAPES[shape], ctx,
                attn_engine=engine, moe_engine=engine)
        _PORT[key] = (hlo.analyze_compiled(counter, math.prod(dims)),
                      counter)
    return _PORT[key]


@pytest.fixture
def reduced(monkeypatch):
    """``lower_cell`` on the reduced configs at the test's shapes, as the
    reference's runs in its subprocess."""
    monkeypatch.setattr(configs, "get_config", configs.get_reduced)
    monkeypatch.setattr(dryrun, "SHAPES", SHAPES)


def _as_reference_reads(counter):
    """Link bytes by kind as the reference's analyzer reads its XLA:CPU
    module: bf16 elements at 4 bytes, a tuple all-to-all by one block."""
    out = {k: 0.0 for k in hlo.COLLECTIVES}
    for c in counter.calls:
        res = c.result_bytes * (4 / c.itemsize if c.itemsize == 2 else 1)
        if c.kind == "all-to-all":
            res /= c.n
        out[c.kind] += hlo._link_bytes(c.kind, res, c.n)
    return out


def _full_grid(launch):
    """The plain version's flops over every (query, key) pair (ragged kv
    zero-padded to its blocks of up to 512) for one kernel launch."""
    if launch.name == "grouped_expert_ffn":
        return launch.flops            # the plain FFN too computes every row
    (b, sq, h, hd), (_, skv, _, _) = launch.shapes[:2]
    blk = min(512, skv)
    per = {"flash_attention_fwd": 4, "flash_attention_carry": 4,
           "flash_attention_bwd": 10, "flash_attention_bwd_block": 10}
    return per[launch.name] * b * h * sq * (-(-skv // blk) * blk) * hd


# -- the port's own cells ------------------------------------------------------


@pytest.mark.parametrize("arch,shape", CELLS)
def test_kernel_path_is_the_plain_path_less_the_masked_work(arch, shape):
    rec, counter = port(arch, shape)
    plain, plain_counter = port(arch, shape, engine="torch")
    masked = sum(_full_grid(k) - k.flops for k in counter.kernels
                 if k.name != "grouped_expert_ffn_bwd")
    # the grouped FFN's backward is its kernel's work (grouped_bwd_work:
    # the first products again, dact, dh and the weight gradients) in
    # place of the plain path's autograd, whose products are twice its
    # forward's: the two forward launches of a layer (the forward and its
    # remat replay)
    fwd = [k for k in counter.kernels if k.name == "grouped_expert_ffn"]
    bwd = [k for k in counter.kernels if k.name == "grouped_expert_ffn_bwd"]
    assert len(bwd) == (len(fwd) // 2 if shape == "train_4k" else 0)
    for k in bwd:         # h, w1, [w1g,] w2, valid, dy: 8 products, or 5
        (g, c, d), (e, _, f) = k.shapes[:2]
        assert k.flops == gm.grouped_bwd_work(g * c, g, c, d, f, e, 2,
                                              len(k.shapes) == 6)[0]
    grouped = sum(k.flops for k in fwd)
    autograd = grouped if bwd else 0.0
    assert rec["flops_per_chip"] == \
        plain["flops_per_chip"] - masked - autograd + sum(k.flops
                                                          for k in bwd)
    assert plain_counter.kernels == []
    if shape == "train_4k" and arch != "mamba2-130m":
        assert masked > 0


@pytest.mark.parametrize("arch,shape", CELLS)
def test_one_rank_cells_count_their_kernels(arch, shape):
    rec, counter = port(arch, shape, mesh="1x1")
    cfg = configs.get_reduced(arch)
    assert rec["n_chips"] == 1
    assert rec["collective_bytes_per_chip"] == 0.0
    attn = 0 if cfg.family == "ssm" else cfg.n_layers
    want = {"train_4k": {"flash_attention_fwd": 2 * attn,
                         "flash_attention_bwd": attn},
            "prefill_32k": {"flash_attention_fwd": attn},
            "decode_32k": {}}[shape]
    if cfg.moe is not None and shape != "decode_32k":
        # with the remat recompute in training, and one backward a layer
        want["grouped_expert_ffn"] = cfg.n_layers * (
            2 if shape == "train_4k" else 1)
        if shape == "train_4k":
            want["grouped_expert_ffn_bwd"] = cfg.n_layers
    assert counter.launches() == {k: v for k, v in want.items() if v}
    m = rec["memory"]
    assert m["peak_bytes"] == m["argument_bytes"] + m["temp_bytes"] > 0
    if shape == "train_4k":           # params and moments updated in place
        assert m["alias_bytes"] > 0.9 * m["argument_bytes"]


def test_full_width_phi4_step_predicts_the_cards_launches():
    """phi4-mini-3.8b uncut, B=2 x S=1024 at one rank: 64 forward (32
    layers and their recompute) and 32 backward flash launches a step,
    phase 5's measured counts; 32 forward in its prefill."""
    from repro_torch.models.model import Model

    cfg = configs.get_config("phi4-mini-3.8b")
    counts = {}
    for kind in ("train", "prefill"):
        with dryrun.fake_mesh((1, 1), ("data", "model")) as ctx:
            counts[kind] = dryrun.count_step(
                cfg, ShapeConfig(kind, 1024, 2, kind), ctx)
    assert counts["train"].launches() == {"flash_attention_fwd": 64,
                                          "flash_attention_bwd": 32}
    assert counts["prefill"].launches() == {"flash_attention_fwd": 32}
    # bf16 weights, f32 moments and the int32 tokens and labels
    n = sum(p.numel() for p in Model(cfg, device="meta").parameters())
    m = counts["train"].memory
    assert m["argument_bytes"] == 10 * n + 4 + 2 * 2 * 1024 * 4
    assert m["alias_bytes"] == 10 * n + 4
    assert m["peak_bytes"] > 1.3 * m["argument_bytes"]


def test_no_plain_version_runs(monkeypatch, reduced):
    """The dry run takes the card's branch everywhere: every plain
    attention version, the grouped FFN's plain forward and backward and
    the plain paged partials raise."""
    def refuse(*a, **k):
        raise AssertionError("a plain version ran in the dry run")

    for mod, name in ((fa, "flash_attention_torch"),
                      (fa, "flash_attention_bwd_torch"),
                      (fa, "flash_attention_step_torch"),
                      (fa, "flash_attention_bwd_block_torch"),
                      (ops, "flash_attention_torch"),
                      (ops, "flash_attention_bwd_block_torch"),
                      (ops, "_lse_dense"), (ref, "flash_attention_ref"),
                      (paged_attention, "paged_attention_torch"),
                      (paged_attention, "paged_attention_partials_torch"),
                      (gm, "grouped_expert_ffn_torch"),
                      (gm, "grouped_expert_ffn_bwd_torch")):
        monkeypatch.setattr(mod, name, refuse)
    for arch in ("phi4-mini-3.8b", "moonshot-v1-16b-a3b"):
        for shape in ("train_4k", "prefill_32k"):
            rec = dryrun.lower_cell(arch, shape, False, mesh_shape="2x4")
            assert rec["status"] == "ok"


def test_dry_run_leaves_no_group_and_no_environment(reduced):
    env = dict(os.environ)
    dryrun.lower_cell("phi4-mini-3.8b", "decode_32k", False,
                      mesh_shape="2x4")
    assert not dist.is_initialized()
    assert dict(os.environ) == env
    # it never joins a group that is up: it raises
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        with pytest.raises(RuntimeError, match="already up"):
            dryrun.lower_cell("phi4-mini-3.8b", "decode_32k", False,
                              mesh_shape="1x2")
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


ROOFLINE_KEYS = ("status", "arch", "shape", "mesh", "kind", "n_chips",
                 "params", "active_params", "flops_per_chip",
                 "hbm_bytes_per_chip", "collective_bytes_per_chip")


def test_cli_records_skips_errors_and_its_cache(tmp_path, capsys,
                                                monkeypatch):
    """``main`` at the production mesh: a sub-quadratic long decode is ok
    with every key the roofline reads, a full-attention one is skipped
    with the reason, nemotron's head_dim-192 prefill is ok (the flash
    kernels take head_dim 192); a cell that raises is recorded as an
    error with its exception and is not cached; a second run takes the ok
    cells from its cache."""
    out = tmp_path / "dryrun.json"
    argv = ["--arch", "mamba2-130m", "--shape", "long_500k", "--out",
            str(out)]
    dryrun.main(argv)
    dryrun.main(["--arch", "phi4-mini-3.8b", "--shape", "long_500k",
                 "--out", str(out)])
    dryrun.main(["--arch", "nemotron-4-340b", "--shape", "prefill_32k",
                 "--out", str(out)])

    def refuse(arch, shape_name, *args, **kwargs):
        raise ValueError(f"no kernel for {arch} {shape_name}")

    with monkeypatch.context() as m:
        m.setattr(dryrun, "lower_cell", refuse)
        dryrun.main(["--arch", "granite-34b", "--shape", "decode_32k",
                     "--out", str(out)])
    recs = json.loads(out.read_text())
    ok = recs["mamba2-130m|long_500k|16x16"]
    for key in ROOFLINE_KEYS:
        assert key in ok
    assert ok["status"] == "ok" and ok["n_chips"] == 256
    assert ok["memory"]["peak_bytes"] > 0
    assert recs["phi4-mini-3.8b|long_500k|16x16"] == {
        "status": "skipped", "reason": (
            "full-attention arch: 500k decode state is O(seq)-quadratic; "
            "skipped per assignment rules")}
    nemo = recs["nemotron-4-340b|prefill_32k|16x16"]
    for key in ROOFLINE_KEYS:
        assert key in nemo
    assert nemo["status"] == "ok" and nemo["n_chips"] == 256
    assert nemo["flops_per_chip"] > 0 and nemo["hbm_bytes_per_chip"] > 0
    assert nemo["memory"]["peak_bytes"] > 0
    assert recs["granite-34b|decode_32k|16x16"] == {
        "status": "error", "error": "ValueError: no kernel for granite-34b "
                                    "decode_32k"}
    capsys.readouterr()
    dryrun.main(argv)
    text = capsys.readouterr().out
    assert "cached, skipping" in text
    assert "done: 2 ok, 1 skipped (documented), 1 errors" in text
    assert not dist.is_initialized()


# -- against the reference (its subprocess started with the module) --------------


def test_skip_reasons_equal_reference(reference, reduced):
    got = reference()
    for arch in ("phi4-mini-3.8b", "moonshot-v1-16b-a3b"):
        rec = dryrun.lower_cell(arch, "long_500k", False, mesh_shape="2x4")
        assert rec == got[f"{arch}|long_500k"]
        assert rec["status"] == "skipped"
    assert dryrun.lower_cell("mamba2-130m", "long_500k", False,
                             mesh_shape="2x4")["status"] == "ok"


@pytest.mark.parametrize("arch", ARCHS)
def test_record_keys_equal_reference(reference, reduced, arch):
    want = reference()[f"{arch}|prefill_32k"]
    rec = dryrun.lower_cell(arch, "prefill_32k", False, mesh_shape="2x4")
    assert set(rec) == set(want)
    assert set(rec["memory"]) == set(want["memory"])
    assert set(rec["collective_detail"]) == set(want["collective_detail"])
    for key in ("status", "arch", "shape", "mesh", "mdmp_mode", "kind",
                "n_chips", "params", "active_params"):
        assert rec[key] == want[key], key


@pytest.mark.parametrize("arch,shape", CELLS)
def test_counts_equal_reference(reference, arch, shape):
    want = reference()[f"{arch}|{shape}"]
    rec, counter = port(arch, shape)
    plain, _ = port(arch, shape, engine="torch")
    assert rec["n_chips"] == want["n_chips"] == 8

    # link bytes by kind, as the reference's analyzer reads them
    got = _as_reference_reads(counter)
    for kind, ref_bytes in want["collective_detail"][
            "bytes_per_kind"].items():
        if shape == "train_4k":
            lo, hi = TRAIN_COLL[kind]
            assert lo * ref_bytes <= got[kind] <= hi * ref_bytes + 1e-9, kind
        else:
            assert got[kind] == pytest.approx(ref_bytes, rel=COLL_RTOL), kind

    # FLOPs with the kernels pinned to their plain versions
    ref_flops = want["flops_per_chip"]
    if shape == "prefill_32k":
        assert plain["flops_per_chip"] == pytest.approx(ref_flops, rel=1e-9)
    elif shape == "decode_32k":
        cfg = configs.get_reduced(arch)
        # the reference's one-hot embedding product [B, V_loc] @ [V_loc,
        # D_loc] (vocab over 'model' = 4, d_model over 'data' = 2)
        onehot = 2 * 8 * (cfg.padded_vocab // 4) * (cfg.d_model // 2)
        assert plain["flops_per_chip"] + onehot == \
            pytest.approx(ref_flops, rel=1e-9)
    else:
        lo, hi = TRAIN_FLOPS
        assert lo * ref_flops <= plain["flops_per_chip"] <= hi * ref_flops
