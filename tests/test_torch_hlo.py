"""The op-stream analyzer (``repro_torch.launch.hlo``) against the
reference's HLO analyzer, and the kernels' work functions.

  * the ring algebra equals ``repro.launch.hlo._link_bytes``, and each
    transport primitive's operand bytes convert to the result bytes the
    algebra reads;
  * FLOPs: 8 + 3 chained 128^2 products and a 2-layer MLP's forward and
    backward count exactly what ``analyze_hlo_text`` of the reference's
    compiled module counts;
  * the eager byte rule: views cost 0, an op reads its operands and
    writes its result, an in-place slice update costs the slice twice;
    peak, argument, output and alias bytes of the live storages;
  * each kernel launch counts its work function and no aten op of its
    plain version, and the abstract (meta) branch refuses what the card
    refuses (head_dim 192, a type, a non-contiguous operand);
  * the work functions equal the formulas of ``chip_smoke.py``'s bounds
    as they stood before the bounds were moved onto them, at the phases'
    shapes.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.launch import hlo as ref_hlo
from repro_torch.core import instrument, transport
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import grouped_matmul as gm
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as paged
from repro_torch.kernels import stencil
from repro_torch.launch import dryrun, hlo
from repro_torch.launch.mesh import AXES
from repro_torch.models import layers


def _meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


# -- the ring algebra and the transport's primitives ----------------------------


@pytest.mark.parametrize("kind", hlo.COLLECTIVES)
@pytest.mark.parametrize("n", [1, 2, 16, 256])
def test_link_bytes_equal_reference(kind, n):
    for result in (0, 1, 123, 1600, 1 << 30):
        assert hlo._link_bytes(kind, result, n) == \
            ref_hlo._link_bytes(kind, result, n)


@pytest.fixture(scope="module")
def mesh():
    """Rank 0 of a fake 2x4 group (torn down after the module)."""
    with dryrun.fake_mesh((2, 4), AXES) as ctx:
        yield ctx
    assert not dist.is_initialized()


def _transport_calls(ctx):
    x = _meta(8, 16, dtype=torch.bfloat16)
    g = ctx.group("model")
    return {
        "psum": (lambda: transport.all_reduce(x, g), 256),
        "all_gather": (lambda: transport.all_gather(x, g), 4 * 256),
        "reduce_scatter": (lambda: transport.reduce_scatter(x, g), 256 / 4),
        "all_to_all": (lambda: transport.all_to_all(list(x.chunk(4)), g),
                       256),
        "ppermute": (lambda: transport.p2p_start(
            [(x, 1, 0)], [(torch.empty_like(x), 3, 0)], g), 256),
    }


@pytest.mark.parametrize("primitive", sorted(hlo.HLO_KIND))
def test_transport_operands_convert_to_result_bytes(mesh, primitive):
    """The transport records operands; the algebra reads results: an
    all-gather's result is n operands, a reduce-scatter's 1/n of its
    operand, the rest their operands' bytes."""
    call, result = _transport_calls(mesh)[primitive]
    counter = hlo.count(call)
    kind = hlo.HLO_KIND[primitive]
    (c,) = counter.calls
    assert (c.kind, c.n, c.result_bytes, c.itemsize) == (kind, 4, result, 2)
    detail = hlo.analyze_ops(counter)["collective_detail"]
    assert detail["counts"][kind] == 1
    assert detail["bytes_per_kind"][kind] == \
        ref_hlo._link_bytes(kind, result, 4)
    assert hlo.result_bytes(primitive, 256, 4) == result
    # the result goes through device memory once, as the reference's rule
    assert counter.hbm_bytes == result


def test_transport_meta_results_are_contiguous(mesh):
    """A message comes back contiguous from every backend; so does a
    meta call's result, whatever its operand's strides."""
    x = _meta(16, 8).t()
    g = mesh.group("model")

    def body():
        return (transport.all_reduce(x, g), transport.all_gather(x, g)[0],
                transport.all_to_all([x, x, x, x], g)[0])

    out = {}
    instrument.analyze_region(lambda: out.setdefault("v", body()))
    assert all(t.is_contiguous() for t in out["v"])


# -- FLOPs against the reference's compiled modules -----------------------------


def test_chained_products_equal_reference_scan():
    """The reference's own scan (tests/test_substrates.py): 8 + 3 chained
    128^2 products, 11 * 2 * 128^3 flop."""
    def f(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        out, _ = jax.lax.scan(body, x, None, length=8)
        out, _ = jax.lax.scan(body, out, None, length=3)
        return out

    sds = jax.ShapeDtypeStruct((128, 128), jnp.float32)
    want = ref_hlo.analyze_hlo_text(
        jax.jit(f).lower(sds, sds).compile().as_text())["flops"]

    def g(x, w):
        for _ in range(8 + 3):
            x = torch.tanh(x @ w)
        return x

    got = hlo.analyze_ops(hlo.count(g, _meta(128, 128), _meta(128, 128)))
    assert got["flops"] == want == 11 * 2 * 128 ** 3


def test_mlp_forward_and_backward_flops_equal_reference():
    """A 2-layer MLP's loss and weight gradients: the port's autograd ops
    count exactly the dots of the reference's compiled value_and_grad."""
    b, d, h, o = 64, 128, 256, 32

    def f(w1, w2, x, y):
        return jnp.sum((jnp.tanh(x @ w1) @ w2) * y)

    sds = [jax.ShapeDtypeStruct(s, jnp.float32)
           for s in ((d, h), (h, o), (b, d), (b, o))]
    compiled = jax.jit(jax.value_and_grad(f, argnums=(0, 1))).lower(
        *sds).compile()
    want = ref_hlo.analyze_hlo_text(compiled.as_text())["flops"]

    def step(w1, w2, x, y):
        loss = ((torch.tanh(x @ w1) @ w2) * y).sum()
        return loss, torch.autograd.grad(loss, (w1, w2))

    counter = hlo.count(step, _meta(d, h, grad=True), _meta(h, o, grad=True),
                        _meta(b, d), _meta(b, o))
    assert counter.flops == want == 2 * (2 * b * d * h + 3 * b * h * o)


# -- the eager byte rule and the live storages ---------------------------------


@pytest.mark.parametrize("view", [
    lambda x: x.view(-1), lambda x: x.reshape(8, 32), lambda x: x.t(),
    lambda x: x.transpose(0, 1), lambda x: x[None].expand(3, 16, 16),
    lambda x: x[2:5], lambda x: x[:, 1], lambda x: x.unsqueeze(0),
    lambda x: x.as_strided((4, 4), (16, 1)), lambda x: x.detach(),
    lambda x: x.permute(1, 0), lambda x: x.narrow(0, 1, 3)])
def test_views_cost_no_bytes(view):
    counter = hlo.count(view, _meta(16, 16))
    assert counter.hbm_bytes == 0.0 and counter.flops == 0.0
    assert counter.memory["temp_bytes"] == 0


def test_an_op_reads_its_operands_and_writes_its_result():
    a, b = _meta(64, 32), _meta(64, 32, dtype=torch.bfloat16)
    counter = hlo.count(lambda x, y: x + y.float(), a, b)
    # y.float(): bf16 in, f32 out; the add: two f32 in, one f32 out
    assert counter.hbm_bytes == 64 * 32 * (2 + 4) + 64 * 32 * 4 * 3
    # the f32 copy dies inside the step: the peak holds it beside the sum
    assert counter.memory["temp_bytes"] == 2 * 64 * 32 * 4
    assert counter.memory["output_bytes"] == 64 * 32 * 4


def test_in_place_slice_updates_cost_the_slice_read_and_written():
    """The reference's dynamic-update-slice rule: a cache position written
    in place costs the slice twice, not the whole cache; the cache is an
    argument updated in place (alias bytes)."""
    cache, new = _meta(8, 512, 4, 16), _meta(8, 4, 16)
    counter = hlo.count(lambda c, x: c[:, 7].copy_(x), cache, new)
    assert counter.hbm_bytes == 2 * 8 * 4 * 16 * 4
    idx = torch.tensor([3, 9])                 # host indices, as a table's

    def put(c, x):
        c[:, idx] = x
        return c

    counter = hlo.count(put, cache, _meta(8, 2, 4, 16))
    assert counter.hbm_bytes == 2 * 8 * 2 * 4 * 16 * 4
    assert counter.memory["alias_bytes"] == 8 * 512 * 4 * 16 * 4
    assert counter.memory["temp_bytes"] == 0


def test_peak_follows_the_live_storages():
    def step(x):
        t = [x * 2.0 for _ in range(3)]         # three live temporaries
        s = t[0] + t[1] + t[2]
        del t
        return s.sum()

    counter = hlo.count(step, _meta(1024))
    m = counter.memory
    assert m["argument_bytes"] == 4096
    assert m["peak_bytes"] == m["argument_bytes"] + m["temp_bytes"]
    assert m["temp_bytes"] == 3 * 4096 + 2 * 4096   # + t0+t1, then s
    assert m["output_bytes"] == 4 and m["alias_bytes"] == 0


def test_cpu_tensors_are_host_work():
    counter = hlo.count(lambda x: (x @ x).sum(), torch.ones(32, 32))
    assert (counter.flops, counter.hbm_bytes, counter.ops) == (0.0, 0.0, 0)


# -- the kernels: one launch by its work function, on the card's branch ---------


def _kernel_calls():
    q = _meta(2, 64, 4, 64, dtype=torch.bfloat16)
    k = _meta(2, 96, 2, 64, dtype=torch.bfloat16)
    lse, st = _meta(2, 64, 4), _meta(2, 64, 4)
    acc = _meta(2, 64, 4, 64)
    qd = _meta(3, 4, 64, dtype=torch.bfloat16)
    pages = _meta(16, 8, 2, 64, dtype=torch.bfloat16)
    table = _meta(3, 5, dtype=torch.int32)
    lens = _meta(3, dtype=torch.int32)
    h = _meta(4, 16, 32, dtype=torch.bfloat16)
    u, halo = _meta(16, 8), _meta(2, 8)
    w = dict(causal=True, window=0, q_offset=32)
    return {
        "flash_attention_fwd": (
            lambda: fa.flash_attention_fwd(q, k, k, **w),
            fa.flash_work("fwd", 2, 64, 96, 4, 2, 64, 2, **w)),
        "flash_attention_bwd": (
            lambda: fa.flash_attention_bwd(q, k, k, q, lse, q, **w),
            fa.flash_work("bwd", 2, 64, 96, 4, 2, 64, 2, **w)),
        "flash_attention_carry": (
            lambda: fa.flash_attention_carry(q, k, k, st, st, acc,
                                             q_offset=100, k_offset=40,
                                             window=30),
            fa.flash_work("carry", 2, 64, 96, 4, 2, 64, 2, q_offset=100,
                          k_offset=40, window=30)),
        "flash_attention_bwd_block": (
            lambda: fa.flash_attention_bwd_block(q, k, k, q, lse, st,
                                                 causal=False),
            fa.flash_work("bwd_block", 2, 64, 96, 4, 2, 64, 2,
                          causal=False)),
        "paged_attention": (
            lambda: paged.paged_attention(qd, pages, pages, table, lens,
                                          window=24),
            paged.paged_work([40] * 3, 24, 4, 2, 64, 8, 2)),
        "grouped_expert_ffn": (
            lambda: gm.grouped_expert_ffn(
                h, _meta(2, 32, 48, dtype=torch.bfloat16),
                _meta(2, 32, 48, dtype=torch.bfloat16),
                _meta(2, 48, 32, dtype=torch.bfloat16),
                _meta(4, dtype=torch.int32), mlp="swiglu"),
            gm.grouped_work(4 * 16, 4, 16, 32, 48, 2, 2, True)),
        "jacobi_step": (
            lambda: stencil.jacobi_step(u, u, lo=u[:1], hi=u[:1]),
            stencil.stencil_work(16, 8, 4, 1, 2)),
        "jacobi_ksweep": (
            lambda: stencil.jacobi_ksweep_parts(halo, u, halo, halo, u,
                                                halo, 2, 0, 0),
            stencil.stencil_work(16, 8, 4, 2, 4, 4)),
    }


@pytest.mark.parametrize("name", sorted(_kernel_calls()))
def test_kernel_launch_counts_its_work_function(name):
    call, (flops, nbytes) = _kernel_calls()[name]
    counter = hlo.count(call)
    assert counter.launches() == {name: 1}
    # no aten op of the plain version: the launch is the step's only work
    assert counter.ops == 0
    assert (counter.flops, counter.hbm_bytes) == (flops, nbytes)
    assert flops > 0 and nbytes > 0


def test_attended_pairs_count_the_mask():
    for sq, skv, causal, window, qo, ko in [
            (64, 64, True, 0, 0, 0), (64, 96, True, 0, 32, 0),
            (37, 50, True, 9, 100, 70), (64, 64, False, 0, 0, 0),
            (8, 8, True, 0, 0, 64), (16, 300, False, 20, 0, 0)]:
        q = np.arange(sq)[:, None] + qo
        kp = np.arange(skv)[None, :] + ko
        mask = np.ones((sq, skv), bool)
        if causal:
            mask &= q >= kp
        if window:
            mask &= q - kp < window
        assert fa.attended_pairs(sq, skv, causal=causal, window=window,
                                 q_offset=qo, k_offset=ko) == mask.sum()
    assert fa.attended_pairs(1024, 1024, causal=True) == 1024 * 1025 // 2


def test_abstract_flash_refuses_head_dim_192_as_the_card_does():
    """On meta tensors under a recorder the flash entries take what the
    card takes: nemotron-4-340b's head_dim (18432 / 96 = 192) is counted,
    one launch of each kernel with its work; a head_dim the kernels are
    not built for (96) is refused with the card's message."""
    lse = _meta(1, 64, 4)

    def calls(hd):
        q = _meta(1, 64, 4, hd, dtype=torch.bfloat16)
        m = _meta(1, 64, 4, hd)
        return (("flash_attention_fwd",
                 lambda: fa.flash_attention_fwd(q, q, q)),
                ("flash_attention_bwd",
                 lambda: fa.flash_attention_bwd(q, q, q, q, lse, q)),
                ("flash_attention_carry",
                 lambda: fa.flash_attention_carry(q, q, q, lse, lse, m)),
                ("flash_attention_bwd_block",
                 lambda: fa.flash_attention_bwd_block(q, q, q, q, lse, lse,
                                                      causal=True)))

    for name, call in calls(192):
        counter = hlo.count(call)
        assert counter.launches() == {name: 1}
        assert counter.flops > 0
    for _, call in calls(96):
        with pytest.raises(ValueError, match=r"head_dim in \(16, 64, 128, "
                                             r"192\); got 96"):
            hlo.count(call)


def test_abstract_branches_refuse_types_and_strides():
    q = _meta(1, 64, 4, 64, dtype=torch.float16)
    with pytest.raises(TypeError, match="f32 or bf16"):
        hlo.count(lambda: fa.flash_attention_fwd(q, q, q))
    kt = _meta(1, 4, 64, 64).transpose(1, 2)        # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        hlo.count(lambda: fa.flash_attention_fwd(_meta(1, 64, 4, 64), kt,
                                                 kt))
    h = _meta(2, 8, 16, dtype=torch.float16)
    w1, w2 = (_meta(2, 16, 8, dtype=torch.float16),
              _meta(2, 8, 16, dtype=torch.float16))
    with pytest.raises(TypeError, match="f32 or bf16"):
        hlo.count(lambda: gm.grouped_expert_ffn_cuda(
            h, w1, None, w2, _meta(2, dtype=torch.int32), "gelu"))
    u = _meta(16, 8).t()
    with pytest.raises(ValueError, match="contiguous"):
        hlo.count(lambda: stencil.jacobi_step(u, u))
    qd = _meta(2, 4, 64, dtype=torch.float16)
    pages = _meta(4, 8, 2, 64, dtype=torch.float16)
    with pytest.raises(TypeError, match="f32 or bf16"):
        hlo.count(lambda: paged.paged_attention(
            qd, pages, pages, _meta(2, 4, dtype=torch.int32),
            _meta(2, dtype=torch.int32)))


def test_grouped_entry_makes_operands_contiguous():
    """An FSDP-gathered expert weight is a moved view; the entry hands the
    kernel contiguous operands (the card refuses strided ones)."""
    h = _meta(2, 8, 16)
    w1 = _meta(2, 16, 24)
    w2 = _meta(2, 16, 24).transpose(1, 2)           # [2, 24, 16], strided
    counter = hlo.count(lambda: gm.grouped_expert_ffn(
        h, w1, None, w2, _meta(2, dtype=torch.int32), mlp="gelu"))
    assert counter.launches() == {"grouped_expert_ffn": 1}
    assert counter.hbm_bytes > gm.grouped_work(16, 2, 8, 16, 24, 2, 4,
                                               False)[1]


def test_meta_takes_the_card_side():
    """Abstract tensors stand for the card: the attention predicate and
    the f32 logits take the CUDA branch (mm.dtype, no f32 copy of the
    unembedding)."""
    q = _meta(1, 16, 4, 64, dtype=torch.bfloat16)
    assert ops.flash_attention_applicable(q, q, q)
    assert not ops.flash_attention_applicable(*(q.new_empty(
        q.shape, device="cpu"),) * 3)
    x2 = _meta(32, 64, dtype=torch.bfloat16)
    w = _meta(64, 128, dtype=torch.bfloat16)
    counter = hlo.count(lambda: layers._LogitsF32.apply(x2, w))
    assert counter.ops == 1 and counter.flops == 2 * 32 * 64 * 128
    assert counter.hbm_bytes == (32 * 64 + 64 * 128) * 2 + 32 * 128 * 4
    counter = hlo.count(lambda: ops.flash_attention(q, q, q))
    assert counter.launches() == {"flash_attention_fwd": 1}


# -- the work functions hold today's bounds -------------------------------------

HBM_BW, PEAK = 3.35e12, {"bfloat16": 989e12, "float32": 67e12}


def _old_paged_bound(lens, window, h, kvh, hd, page, dtype_name, itemsize):
    b = len(lens)
    need = sum(min(int(n), window) if window else int(n) for n in lens)
    pmax = max(1, -(-int(max(lens)) // page))
    nbytes = (need * kvh * hd * 2 * itemsize + 2 * b * h * hd * itemsize
              + 4 * b * (1 + pmax))
    flops = 4.0 * h * hd * need
    t_bytes, t_ops = nbytes / HBM_BW, flops / PEAK[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _old_flash_bounds(b, s, h, kvh, hd, itemsize):
    pairs = b * h * s * (s + 1) // 2
    q_bytes = b * s * h * hd * itemsize
    kv_bytes = 2 * b * s * kvh * hd * itemsize
    lse_bytes = b * s * h * 4
    out = {}
    for name, flops, nbytes in (
            ("fwd", 4.0 * pairs * hd, 2 * q_bytes + kv_bytes + lse_bytes),
            ("bwd", 10.0 * pairs * hd,
             4 * q_bytes + 2 * kv_bytes + lse_bytes)):
        t_ops, t_bytes = flops / PEAK["bfloat16"], nbytes / HBM_BW
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def _old_block_bwd_bound(b, s, h, kvh, hd, itemsize):
    pairs = b * h * s * (s + 1) // 2
    nbytes = (2 * b * s * h * hd * itemsize + 2 * b * s * kvh * hd * itemsize
              + 2 * b * s * h * 4 + (b * s * h * hd + 2 * b * s * kvh * hd) * 4)
    t_ops, t_bytes = 10.0 * pairs * hd / PEAK["bfloat16"], nbytes / HBM_BW
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _old_stencil_bound(m, n, itemsize, sweeps, u_ghost=0, f_ghost=0):
    nbytes = ((m + u_ghost) + (m + f_ghost) + m) * n * itemsize
    flops = 5.0 * m * max(n - 2, 0) * sweeps
    t_bytes, t_ops = nbytes / HBM_BW, flops / PEAK["float32"]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _old_grouped_bound(kept, c, d, f, e, itemsize, gated=True):
    mults = 2 if gated else 1
    t_ops = 2.0 * (mults + 1) * d * f * kept / PEAK["bfloat16"]
    nbytes = ((kept * d + (mults + 1) * e * d * f) * itemsize
              + e * c * d * itemsize + 4 * e)
    t_bytes = nbytes / HBM_BW
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _old_carry_bounds(b, s, h, kvh, hd, itemsize):
    pairs = b * h * s * (s + 1) // 2
    nbytes = (b * s * h * hd * itemsize + 2 * b * s * kvh * hd * itemsize
              + 2 * (b * s * h * hd * 4 + 2 * b * s * h * 4))
    t_ops, t_bytes = 4.0 * pairs * hd / PEAK["bfloat16"], nbytes / HBM_BW
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _bound(flops, nbytes, dtype_name):
    t_bytes, t_ops = nbytes / HBM_BW, flops / PEAK[dtype_name]
    return max(t_bytes, t_ops) * 1e3


@pytest.mark.parametrize("h,kvh,b,lo,hi", [(32, 8, 8, 64, 289),
                                           (32, 8, 32, 2048, 8193),
                                           (48, 1, 8, 64, 289),
                                           (16, 16, 8, 64, 289)])
def test_paged_work_holds_the_phase_bound(h, kvh, b, lo, hi):
    """Phase 2's four paged shapes (hd 128, 16-token pages, bf16)."""
    lens = [int(x) for x in np.random.default_rng(b + h).integers(
        lo, hi, size=b)]
    for window in (0, 100):
        want = _old_paged_bound(lens, window, h, kvh, 128, 16, "bfloat16",
                                2)
        flops, nbytes = paged.paged_work(lens, window, h, kvh, 128, 16, 2)
        assert _bound(flops, nbytes, "bfloat16") == want[0]


def test_flash_work_holds_the_phase_bounds():
    """Phase 2's training shape (B 2, S 1024, 32/8 heads, hd 128) and the
    ring's prefill call (1 x 8192)."""
    b, s, h, kvh, hd = 2, 1024, 32, 8, 128
    old = _old_flash_bounds(b, s, h, kvh, hd, 2)
    for name in ("fwd", "bwd"):
        got = fa.flash_work(name, b, s, s, h, kvh, hd, 2, causal=True)
        assert _bound(*got, "bfloat16") == old[name][0]
    got = fa.flash_work("bwd_block", b, s, s, h, kvh, hd, 2, causal=True)
    assert _bound(*got, "bfloat16") == _old_block_bwd_bound(b, s, h, kvh, hd,
                                                            2)[0]
    got = fa.flash_work("carry", 1, 8192, 8192, 32, 8, 128, 2, causal=True)
    assert _bound(*got, "bfloat16") == _old_carry_bounds(1, 8192, 32, 8, 128,
                                                         2)[0]


def test_stencil_and_grouped_work_hold_the_phase_bounds():
    n = 16386
    assert _bound(*stencil.stencil_work(n, n, 4, 1, 2, 0), "float32") == \
        _old_stencil_bound(n, n, 4, 1, 2, 0)[0]
    for k in (2, 4, 8):
        assert _bound(*stencil.stencil_work(n, n, 4, k, 2 * k, 2 * k),
                      "float32") == _old_stencil_bound(n, n, 4, k, 2 * k,
                                                       2 * k)[0]
    # moonshot's prefill call: 64 groups of 480, d 2048, f 1408
    for kept in (24576, 23871.25, 30720):
        assert _bound(*gm.grouped_work(kept, 64, 480, 2048, 1408, 64, 2),
                      "bfloat16") == _old_grouped_bound(kept, 480, 2048,
                                                        1408, 64, 2)[0]


def test_chip_smoke_bounds_read_the_work_functions():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_bounds", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs.flash_bounds(2, 1024, 32, 8, 128, 2) == \
        _old_flash_bounds(2, 1024, 32, 8, 128, 2)
    assert cs.block_bwd_bound(2, 1024, 32, 8, 128, 2) == \
        _old_block_bwd_bound(2, 1024, 32, 8, 128, 2)
    assert cs.carry_bounds(1, 8192, 32, 8, 128, 2) == \
        _old_carry_bounds(1, 8192, 32, 8, 128, 2)
    assert cs.stencil_bound(16386, 16386, 4, 8, 16, 16) == \
        _old_stencil_bound(16386, 16386, 4, 8, 16, 16)
    assert cs.grouped_bound(24000.5, 480, 2048, 1408, 64, 2) == \
        _old_grouped_bound(24000.5, 480, 2048, 1408, 64, 2)
    lens = [64, 100, 288, 17]
    assert cs.paged_bound(lens, 0, 32, 8, 128, 16, "bfloat16", 2) == \
        _old_paged_bound(lens, 0, 32, 8, 128, 16, "bfloat16", 2)
    assert math.isclose(cs.HBM_BW, HBM_BW) and cs.PEAK == PEAK
