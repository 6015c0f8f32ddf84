"""Grouped-expert FFN — hand-written CUDA kernels + plain PyTorch version
(port of ``repro.kernels.grouped_matmul``).

The MoE capacity buffers are [G, C, D] groups of padded rows (G = E
experts, or E_loc x tp (expert, source-rank) groups after the EP
all_to_all); only the first ``valid[g]`` rows of each group hold real
tokens, the rest are padding sized by the capacity factor.  Group g uses
expert ``g // (G / E)``.

The CUDA kernels ``csrc/grouped_matmul.cu`` (Hopper, ``sm_90a``) replace
the reference's Pallas TPU kernel ``grouped_expert_ffn_pallas``.  Two
launches (the first products and the activation into a workspace, then
the down-projection), in one of two engines that ``grouped_plan`` picks
from the shapes alone:

  * ``wgmma`` — bf16 with D and F multiples of 64 (moonshot's MoE layers):
    persistent tensor-core GEMMs over the live 128-row tiles only, fed by
    TMA.  The activation is stored as two bf16 planes, act_hi and act_lo
    = act - act_hi, and the f32 down-projection of the reference runs as
    act_hi w2 + act_lo w2 in one f32 accumulator (w2 is bf16, so this is
    the f32 product within about 1e-5 of its size).  Its operands must start
    on 16-byte boundaries; the wrapper raises otherwise;
  * ``simt`` — f32, and bf16 shapes the tensor-core path cannot map: f32
    FMA tiles on the SIMT units, with an f32 workspace.

Both read the valid counts on the card, so a call never waits for the
host and can be captured in a CUDA graph.  The two launches stay apart:
a 128-row tile of act over F = 1408 is 720 KB in f32, beyond the 227 KB
of shared memory, and the workspace's round trip costs about 0.08 ms.
The bound counts the function's work whatever runs it: the three
products at the bf16 tensor-core rate against the weights, kept rows and
output over HBM, 0.430 ms at moonshot's prefill call (G = E = 64, C =
480, D 2048, F 1408, 24576 kept rows).  There the tensor-core engine
takes 1.12-1.24 ms over three runs on an NVIDIA H100 80GB HBM3 at
700 W, against 18.24 ms for the first port's SIMT kernel and 13.3 ms for
the plain version (chip_smoke.py phase 2; PERF.md; the design is in the
source's note).

``grouped_expert_ffn_torch`` is the plain version: rows masked by the
same predicate, then batched products in f32 (the reference's
``grouped_expert_ffn_jnp``).  ``grouped_expert_ffn`` is a
``torch.autograd.Function``: a CUDA tensor launches the kernels (or
raises), a CPU tensor takes the plain version, and ``engine="torch"``
pins the plain version on any device.  ``GROUPED_LAUNCHES`` counts kernel
calls, ``ENGINE_LAUNCHES`` the calls of each engine.

Its backward is ``grouped_expert_ffn_bwd``, which dispatches the same way:
the CUDA kernels of ``grouped_ffn_bwd_launch`` (three steps: u, the gate
and dact again with act, dU and dG; dh; the weight gradients over each
expert's kept rows), on the tensor cores where the forward's tensor-core
engine runs (``bwd_engine`` "mma": five persistent ``wgmma`` GEMMs fed by
TMA, act, dU and dG as bf16 hi/lo planes; step 1 is dact into an f32
workspace, then u beside the gate with act, dU and dG, each shaped as the
forward's launch A, and step 3 is two launches, [dw1 | dw1g] and dw2,
with TMA-store epilogues; ``grouped_bwd_plan`` gives each launch's
geometry and walk) and on SIMT otherwise, or
``grouped_expert_ffn_bwd_torch`` on
the CPU: the reference's backward (``jax.vjp`` of
``grouped_expert_ffn_jnp``) written out as formulas, every product in
f32.  No TPU kernel stands behind it.  ``GROUPED_BWD_LAUNCHES`` counts its
kernel calls, ``BWD_ENGINE_LAUNCHES`` the calls of each engine, and
``grouped_bwd_work`` is its work function.  At moonshot's training call
(G = E = 64, C = 240, D 2048, F 1408, swiglu, ~12,288 kept rows) the
tensor-core backward takes 2.34 ms on an NVIDIA H100 80GB HBM3 at 700 W,
against 5.89-5.98 ms for the ``mma.sync`` kernels it replaced, 0.71 ms of
bound and 1.82 ms for autograd through three bf16 ``bmm``
(``scripts/grouped_bwd_turns.py``; PERF.md).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import instrument
from repro_torch.kernels import build

#: kernel calls since the count was last set to 0
GROUPED_LAUNCHES = 0
#: kernel calls of each engine since the counts were last set to 0
ENGINE_LAUNCHES = {"wgmma": 0, "simt": 0}
#: backward kernel calls, and those of each engine, since last set to 0
GROUPED_BWD_LAUNCHES = 0
BWD_ENGINE_LAUNCHES = {"mma": 0, "simt": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ACT_CODE = {"swiglu": 0, "geglu": 1, "relu2": 2, "gelu": 3}
_ENGINE_CODE = {"simt": 0, "wgmma": 1}
_BWD_ENGINE_CODE = {"simt": 0, "mma": 1}
#: sqrt(2 / pi) and the cubic term of the tanh GELU
_GELU_K, _GELU_C = 0.7978845608028654, 0.044715
#: the tensor-core engine's D and F granularity: one 128-byte TMA box
TC_DEPTH = 64
#: the tensor-core backward's launches (``csrc/grouped_matmul.cu``,
#: namespace ``tc``): step 1's two ("dact", then "act": act, dU, dG),
#: step 2 ("dh") and step 3's two ("dw1": dw1 beside dw1g, "dw2"), and
#: each one's geometry, gated
#: (swiglu, geglu) and not: threads a CTA, output rows and columns a tile
#: (columns of each output tensor), the contraction a stage (D, F or kept
#: rows), stages of its ring and dynamic shared memory.  A variant is a
#: source edit of both; ``grouped_bwd_built`` reads the library's and the
#: card tests hold them equal
GROUPED_BWD_STEPS = ("dact", "act", "dh", "dw1", "dw2")
GROUPED_BWD_GEOMETRY = {
    ("dact", True): (384, 128, 256, 64, 4, 197696),
    ("dact", False): (384, 128, 256, 64, 4, 197696),
    ("act", True): (384, 128, 128, 64, 4, 197696),
    ("act", False): (384, 128, 256, 64, 4, 197696),
    ("dh", True): (384, 128, 256, 64, 3, 197680),
    ("dh", False): (384, 128, 256, 64, 3, 197680),
    ("dw1", True): (384, 128, 128, 32, 4, 230464),
    ("dw1", False): (384, 128, 256, 32, 4, 230464),
    ("dw2", True): (384, 128, 256, 32, 5, 230480),
    ("dw2", False): (384, 128, 256, 32, 5, 230480),
}


def gated(mlp: str) -> bool:
    return mlp in ("swiglu", "geglu")


def _act(mlp: str, u: torch.Tensor, g: torch.Tensor | None) -> torch.Tensor:
    """models/layers.py::activation, repeated here so the kernel layer does
    not import the model layer (GELU is the tanh approximation, as
    jax.nn.gelu's default)."""
    if mlp == "swiglu":
        return F.silu(u) * g
    if mlp == "geglu":
        return F.gelu(u, approximate="tanh") * g
    if mlp == "relu2":
        r = F.relu(u)
        return r * r
    if mlp == "gelu":
        return F.gelu(u, approximate="tanh")
    raise ValueError(mlp)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the oracles of the forward and backward kernels)
# ---------------------------------------------------------------------------


def grouped_expert_ffn_torch(h: torch.Tensor, w1: torch.Tensor,
                             w1_gate: torch.Tensor | None, w2: torch.Tensor,
                             valid: torch.Tensor, mlp: str) -> torch.Tensor:
    """h: [G, C, D] capacity groups; valid: [G] rows kept per group; w1
    (+w1_gate): [E, D, F]; w2: [E, F, D] with G % E == 0.  Returns
    [G, C, D] in h's type; rows >= valid are exactly zero.  The products
    take f32 copies of the operands (bf16 products are exact in f32), so
    an f32 copy of each expert weight exists only for the call."""
    n_g, c, d = h.shape
    e = w1.shape[0]
    rows = torch.arange(c, device=h.device)
    live = rows[None, :, None] < valid.to(h.device)[:, None, None]
    hm = torch.where(live, h, torch.zeros((), dtype=h.dtype,
                                          device=h.device))
    # the gpe groups of one expert are adjacent: [E, gpe * C, D]
    he = hm.reshape(e, (n_g // e) * c, d).float()
    u = torch.bmm(he, w1.float())
    act = _act(mlp, u, torch.bmm(he, w1_gate.float()) if gated(mlp)
               else None)
    out = torch.bmm(act, w2.float())
    return out.reshape(n_g, c, d).to(h.dtype)


def _act_grads(mlp: str, u: torch.Tensor, g: torch.Tensor | None,
               da: torch.Tensor):
    """act(u, g) and the cotangents of u and g from da = d out / d act:
    (act, du, dg), dg None for the ungated activations.  The derivatives
    of ``_act`` written out (the kernel's act_grads)."""
    if mlp == "swiglu":
        s = torch.sigmoid(u)
        silu = u * s
        return silu * g, da * g * (s * (1.0 + u * (1.0 - s))), da * silu
    if mlp == "relu2":
        r = torch.relu(u)
        return r * r, da * (2.0 * r), None
    if mlp not in ("geglu", "gelu"):
        raise ValueError(mlp)
    t = torch.tanh(_GELU_K * (u + _GELU_C * u * u * u))
    gelu = 0.5 * u * (1.0 + t)
    dgelu = 0.5 * (1.0 + t) + 0.5 * u * (1.0 - t * t) * _GELU_K * (
        1.0 + 3.0 * _GELU_C * u * u)
    if mlp == "geglu":
        return gelu * g, da * g * dgelu, da * gelu
    return gelu, da * dgelu, None


def grouped_expert_ffn_bwd_torch(h: torch.Tensor, w1: torch.Tensor,
                                 w1_gate: torch.Tensor | None,
                                 w2: torch.Tensor, valid: torch.Tensor,
                                 dy: torch.Tensor, mlp: str):
    """The backward of ``grouped_expert_ffn_torch`` at dy [G, C, D]:
    (dh, dw1, dw1g, dw2) in the operands' types, dw1g None when ungated.
    The reference's ``jax.vjp`` of ``grouped_expert_ffn_jnp`` written out,
    no autograd: u (and the gate) again, dact = dy w2^T, dU and dG from
    the activation's derivative, dh = dU w1^T (+ dG w1g^T), dw1 = h^T dU,
    dw1g = h^T dG, dw2 = act^T dy, every product in f32.  Rows at or past
    ``valid`` give dh exactly 0 and add nothing to any weight gradient (h
    and dy are masked there), and an expert's gradients sum over its
    groups."""
    n_g, c, d = h.shape
    e = w1.shape[0]
    rows = torch.arange(c, device=h.device)
    live = rows[None, :, None] < valid.to(h.device)[:, None, None]

    def masked(t):             # [G, C, D] -> the experts' rows [E, gpe C, D]
        t = torch.where(live, t, torch.zeros((), dtype=t.dtype,
                                             device=t.device))
        return t.reshape(e, (n_g // e) * c, d).float()

    he, dye = masked(h), masked(dy)
    w1f = w1.float()
    wgf = w1_gate.float() if gated(mlp) else None
    u = torch.bmm(he, w1f)
    gate = torch.bmm(he, wgf) if gated(mlp) else None
    da = torch.bmm(dye, w2.float().transpose(1, 2))
    act, du, dg = _act_grads(mlp, u, gate, da)
    dh = torch.bmm(du, w1f.transpose(1, 2))
    if dg is not None:
        dh = dh + torch.bmm(dg, wgf.transpose(1, 2))
    dh = torch.where(live, dh.reshape(n_g, c, d), 0.0).to(h.dtype)
    ht = he.transpose(1, 2)
    dw1 = torch.bmm(ht, du).to(w1.dtype)
    dw1g = None if dg is None else torch.bmm(ht, dg).to(w1_gate.dtype)
    dw2 = torch.bmm(act.transpose(1, 2), dye).to(w2.dtype)
    return dh, dw1, dw1g, dw2


# ---------------------------------------------------------------------------
# The CUDA kernel's wrapper
# ---------------------------------------------------------------------------


class Plan(NamedTuple):
    """How one call runs on the card."""
    engine: str          # "wgmma" (bf16 on the tensor cores) or "simt"
    ctas: int            # wgmma: persistent CTAs a launch, at most (the
                         # kernel takes no more than its tiles); simt: 0,
                         # a grid over every tile


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _tensor_cores(h: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor
                  ) -> bool:
    """bf16 with D and F multiples of ``TC_DEPTH``: the shapes and types
    the tensor-core engines (forward and backward) take."""
    d, f = h.shape[2], w1.shape[2]
    bf16 = torch.bfloat16
    return (h.dtype == w1.dtype == w2.dtype == bf16 and d % TC_DEPTH == 0
            and f % TC_DEPTH == 0)


def grouped_plan(h: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                 mlp: str, *, n_sm: int | None = None) -> Plan:
    """The plan the wrapper launches for these shapes and types: the
    tensor cores for bf16 with D and F multiples of ``TC_DEPTH``, SIMT
    otherwise.  Reads shapes and types only, never a value (nor ``valid``),
    so a call never waits for the card.  The tensor-core launches are
    persistent, one CTA per SM (``n_sm``, default h's card's count)."""
    if _tensor_cores(h, w1, w2):
        if n_sm is None:
            n_sm = _sm_count(h.device.index if h.device.index is not None
                             else torch.cuda.current_device())
        return Plan("wgmma", n_sm)
    return Plan("simt", 0)


def bwd_engine(h: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> str:
    """The engine of the backward for these shapes and types: the tensor
    cores ("mma") where the forward's tensor-core engine runs, SIMT
    otherwise.  Reads shapes and types only."""
    return "mma" if _tensor_cores(h, w1, w2) else "simt"


class BwdLaunch(NamedTuple):
    """One launch of the tensor-core backward: its geometry
    (``GROUPED_BWD_GEOMETRY``), the tiles of its walk in the order of the
    linear tile index (``walk`` names its axes, slowest first; tile t is
    (group or expert, first row, first column) of the launch's output),
    and its persistent CTAs: CTA b takes tiles b, b + grid, b + 2 grid..."""
    step: str
    threads: int
    rows: int
    cols: int
    depth: int
    stages: int
    smem: int
    walk: tuple[str, ...]
    tiles: tuple[tuple[int, int, int], ...]
    grid: int


class GroupedBwdPlan(NamedTuple):
    """How one tensor-core backward call runs on the card: its five
    launches in stream order."""
    launches: tuple[BwdLaunch, ...]


def _row_walk(n_row: int, n_col: int, n_g: int, gpe: int, rows: int,
              cols: int) -> list[tuple[int, int, int]]:
    """Steps 1 and 2 (the kernels' ``Walk``): row tiles fastest, then the
    groups of one expert, then column tiles, then experts, so the CTAs
    that run at once share an expert's block of weights in L2."""
    out = []
    for t in range(n_row * n_col * n_g):
        rt, t = t % n_row, t // n_row
        gi, t = t % gpe, t // gpe
        col, e = t % n_col, t // n_col
        out.append((e * gpe + gi, rt * rows, col * cols))
    return out


def _dw_walk(n_m: int, n_n: int, e: int, rows: int, cols: int
             ) -> list[tuple[int, int, int]]:
    """Step 3 (the kernel's ``DwWalk``): M tiles fastest, then N tiles,
    then experts, so the CTAs that run at once share one expert's kept
    rows in L2."""
    out = []
    for t in range(n_m * n_n * e):
        mt, t = t % n_m, t // n_m
        out.append((t // n_n, mt * rows, (t % n_n) * cols))
    return out


def grouped_bwd_plan(n_g: int, c: int, d: int, f: int, e: int, gated: bool,
                     n_sm: int = 132) -> GroupedBwdPlan:
    """The tensor-core backward's plan for h [n_g, c, d] over ``e``
    experts of [d, f] (gated: swiglu, geglu): step 1 over 128-row x 256-F
    tiles of dact, then 128-row x 128-F tiles (256 ungated) of act, dU and
    dG, of every group (the kernels skip a row tile at or past valid[g]),
    step 2 over 128-row x 256-D tiles of dh (one past valid[g]
    is written as zeros), step 3's [dw1 | dw1g] over 128-D x 128-F tiles
    (256-F ungated) and dw2 over 128-F x 256-D tiles of each expert, each
    tile contracting its expert's kept rows ``dw_stages`` at a time.
    Every launch is persistent: min(n_sm, tiles) CTAs.  Host arithmetic
    on the shapes and the SM count only (no ``valid``): it runs on the
    CPU and under the dry run's recorder."""
    if min(n_g, c, d, f, e, n_sm) < 1 or n_g % e:
        raise ValueError("grouped_bwd_plan takes positive sizes and G a "
                         "multiple of E")
    if d % TC_DEPTH or f % TC_DEPTH:
        raise ValueError(f"the tensor-core backward takes D and F multiples "
                         f"of {TC_DEPTH}; got {d}, {f}")
    gpe = n_g // e
    launches = []
    for step in GROUPED_BWD_STEPS:
        threads, rows, cols, depth, stages, smem = GROUPED_BWD_GEOMETRY[
            (step, bool(gated))]
        if step in ("dact", "act", "dh"):
            n_out = d if step == "dh" else f
            walk = ("expert", "column", "group", "row")
            tiles = _row_walk(-(-c // rows), -(-n_out // cols), n_g, gpe,
                              rows, cols)
        else:
            m_out, n_out = (d, f) if step == "dw1" else (f, d)
            walk = ("expert", "column", "row")
            tiles = _dw_walk(-(-m_out // rows), -(-n_out // cols), e, rows,
                             cols)
        launches.append(BwdLaunch(step, threads, rows, cols, depth, stages,
                                  smem, walk, tuple(tiles),
                                  max(1, min(n_sm, len(tiles)))))
    return GroupedBwdPlan(tuple(launches))


def dw_stages(valid, c: int, expert: int, gpe: int, depth: int = 32
              ) -> list[tuple[int, int, int]]:
    """The stages step 3 contracts for a tile of ``expert``, in order:
    (group, first row, kept rows) for each ``depth`` rows of each of its
    groups below valid[g] (clamped to [0, c]).  The kernel loads whole
    ``depth``-row boxes and zeroes rows [kept, depth) of a stage in shared
    memory before its products, so only kept rows reach a weight
    gradient; an expert with no kept row has no stage and stores zeros.
    The host twin of the kernel's loop, for the CPU tests."""
    out = []
    for g in range(expert * gpe, (expert + 1) * gpe):
        v = max(0, min(int(valid[g]), c))
        out += [(g, r0, min(depth, v - r0)) for r0 in range(0, v, depth)]
    return out


def _lib() -> ctypes.CDLL:
    lib = build.load("grouped_matmul")
    if lib.grouped_ffn_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.grouped_ffn_launch.argtypes = [i, i, i, p, p, p, p, p, p, p, i,
                                           i, i, i, i, i, i, p]
        lib.grouped_ffn_launch.restype = i
        lib.grouped_ffn_bwd_launch.argtypes = [i, i, i, p, p, p, p, p, p, p,
                                               p, p, p, p, i, i, i, i, i, i,
                                               p]
        lib.grouped_ffn_bwd_launch.restype = i
        out = ctypes.POINTER(ctypes.c_int)
        lib.grouped_tile_shape.argtypes = [i, i, out, out, out]
        lib.grouped_tile_shape.restype = i
        lib.grouped_bwd_geometry.argtypes = [i, i, i]
        lib.grouped_bwd_geometry.restype = i
        lib.grouped_error_string.argtypes = [i]
        lib.grouped_error_string.restype = ctypes.c_char_p
    return lib


def _check_shapes(h, w1, w1_gate, w2, valid, mlp) -> None:
    if mlp not in _ACT_CODE:
        raise ValueError(f"unknown activation {mlp!r}")
    if h.dim() != 3 or w1.dim() != 3 or w2.dim() != 3:
        raise ValueError("h, w1 and w2 must be 3-D")
    n_g, c, d = h.shape
    e, d1, f = w1.shape
    if d1 != d or tuple(w2.shape) != (e, f, d):
        raise ValueError(f"h {tuple(h.shape)}, w1 {tuple(w1.shape)}, w2 "
                         f"{tuple(w2.shape)} do not chain")
    if gated(mlp) != (w1_gate is not None):
        raise ValueError(f"{mlp} {'needs' if gated(mlp) else 'takes no'} "
                         "w1_gate")
    if w1_gate is not None and w1_gate.shape != w1.shape:
        raise ValueError(f"w1_gate {tuple(w1_gate.shape)} != w1 "
                         f"{tuple(w1.shape)}")
    if e < 1 or n_g % e:
        raise ValueError(f"{n_g} groups over {e} experts")
    if tuple(valid.shape) != (n_g,):
        raise ValueError(f"valid must be [{n_g}]; got {tuple(valid.shape)}")


def grouped_work(kept: float, n_g: int, c: int, d: int, f: int, e: int,
                 itemsize: int, gated: bool = True) -> tuple[float, float]:
    """(flops, bytes) of one call over ``n_g`` groups of ``c`` capacity
    rows that keeps ``kept`` rows, for ``e`` experts of [d, f] / [f, d]:
    the function's least work, however a kernel runs it.  Flops: the
    products (three for a gated FFN, two else), 2 per multiply-add of a
    kept row; bytes: the kept rows of h and the expert weights read once,
    the whole output written once, the valid counts read once."""
    mults = 2 if gated else 1
    nbytes = ((kept * d + (mults + 1) * e * d * f) * itemsize
              + n_g * c * d * itemsize + 4 * n_g)
    return 2.0 * (mults + 1) * d * f * kept, nbytes


def grouped_bwd_work(kept: float, n_g: int, c: int, d: int, f: int, e: int,
                     itemsize: int, gated: bool = True
                     ) -> tuple[float, float]:
    """(flops, bytes) of one backward call that keeps ``kept`` of its
    ``n_g`` x ``c`` capacity rows: the function's least work, however a
    kernel runs it.  Flops: u (and the gate) again, dact, dw2, dh (one
    product per first-layer weight) and dw1 (and dw1g), 2 per multiply-add
    of a kept row: 8 products gated, 5 ungated; bytes: the kept rows of h
    and dy and the expert weights read once, the weight gradients and the
    whole dh written once, the valid counts read once."""
    mults = 2 if gated else 1
    weights = (mults + 1) * e * d * f
    nbytes = ((2 * kept * d + 2 * weights + n_g * c * d) * itemsize
              + 4 * n_g)
    return 2.0 * (3 * mults + 2) * d * f * kept, nbytes


def _work(h, w1, valid, mlp: str, abstract: bool, fn=grouped_work):
    """A wrapper's launch, as the recorder reads it: ``grouped_work`` of
    the rows ``valid`` keeps, or of every capacity row where there are
    no counts to read (a dry run's meta tensors, as the reference's jnp
    engine computes every capacity row)."""
    def work():
        n_g, c, d = h.shape
        e, _, f = w1.shape
        kept = (n_g * c if abstract
                else int(valid.clamp(0, c).sum().item()))
        return fn(kept, n_g, c, d, f, e, h.element_size(), gated(mlp))
    return work


def _check_operands(h, w1, w1_gate, w2, valid) -> None:
    """What the kernels take — types, devices, contiguity — checked on the
    card and on abstract (meta) tensors alike."""
    weights = [w1, w2] + ([w1_gate] if w1_gate is not None else [])
    if h.dtype not in _DTYPE_CODE or any(w.dtype != h.dtype
                                         for w in weights):
        raise TypeError(f"the grouped-expert kernel takes f32 or bf16 "
                        f"operands of one type; got "
                        f"{[t.dtype for t in (h, *weights)]}")
    if any(t.device != h.device for t in (*weights, valid)):
        raise ValueError("inputs lie on several devices")
    if not all(t.is_contiguous() for t in (h, *weights)):
        raise ValueError("the grouped-expert kernel takes contiguous "
                         "tensors")


def _check_card(h, w1, w1_gate, w2, valid, mlp) -> None:
    """What the kernels need beyond ``_check_shapes``."""
    _check_shapes(h, w1, w1_gate, w2, valid, mlp)
    if h.device.type != "cuda":
        raise RuntimeError(f"no grouped-expert kernel for {h.device}")
    _check_operands(h, w1, w1_gate, w2, valid)


def _launch(h, w1, w1_gate, w2, valid, mlp, plan: Plan,
            out: torch.Tensor) -> None:
    """Both launches of ``plan``, writing ``out`` (h's type, or f32 for
    the tensor-core engine's readout before rounding)."""
    global GROUPED_LAUNCHES
    n_g, c, d = h.shape
    e, _, f = w1.shape
    if plan.engine == "wgmma":
        bad = [name for name, t in (("h", h), ("w1", w1), ("w1_gate", w1_gate),
                                    ("w2", w2))
               if t is not None and t.data_ptr() % 16]
        if bad:
            raise ValueError(f"the tensor-core grouped kernel loads by TMA: "
                             f"{', '.join(bad)} must start on a 16-byte "
                             f"boundary")
        # the activation as two bf16 planes, act_hi and act_lo
        ws = torch.empty((2, n_g, c, f), dtype=torch.bfloat16,
                         device=h.device)
    else:
        ws = torch.empty((n_g, c, f), dtype=torch.float32, device=h.device)
    counts = valid.to(torch.int32).contiguous()
    lib = _lib()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = lib.grouped_ffn_launch(
            _DTYPE_CODE[h.dtype], _ENGINE_CODE[plan.engine], _ACT_CODE[mlp],
            h.data_ptr(), w1.data_ptr(),
            None if w1_gate is None else w1_gate.data_ptr(), w2.data_ptr(),
            counts.data_ptr(), ws.data_ptr(), out.data_ptr(), n_g, c, d, f,
            e, plan.ctas, int(out.dtype != h.dtype), stream)
    if err != 0:
        raise RuntimeError(f"grouped_expert_ffn kernel launch failed: "
                           f"{lib.grouped_error_string(err).decode()}")
    GROUPED_LAUNCHES += 1
    ENGINE_LAUNCHES[plan.engine] += 1
    instrument.note_kernel("grouped_expert_ffn", (h, w1, w1_gate, w2, valid),
                           (out,), work=_work(h, w1, valid, mlp, False))


def grouped_expert_ffn_cuda(h: torch.Tensor, w1: torch.Tensor,
                            w1_gate: torch.Tensor | None, w2: torch.Tensor,
                            valid: torch.Tensor, mlp: str) -> torch.Tensor:
    """One call of the kernels (both launches) on CUDA tensors, by
    ``grouped_plan``; raises on anything they do not take."""
    if instrument.is_meta(h):
        _check_shapes(h, w1, w1_gate, w2, valid, mlp)
        _check_operands(h, w1, w1_gate, w2, valid)
        return instrument.meta_kernel(
            "grouped_expert_ffn", (h, w1, w1_gate, w2, valid),
            torch.empty_like(h), work=_work(h, w1, valid, mlp, True))
    _check_card(h, w1, w1_gate, w2, valid, mlp)
    out = torch.empty_like(h)
    _launch(h, w1, w1_gate, w2, valid, mlp, grouped_plan(h, w1, w2, mlp),
            out)
    return out


def tile_shape(engine: str, mlp: str) -> tuple[int, int, int]:
    """(rows, F columns of the up launch, D columns of the down launch) of
    one tile of ``engine`` for ``mlp``, as the built kernels define them."""
    rows, up, down = (ctypes.c_int() for _ in range(3))
    err = _lib().grouped_tile_shape(_ENGINE_CODE[engine], int(gated(mlp)),
                                    ctypes.byref(rows), ctypes.byref(up),
                                    ctypes.byref(down))
    if err != 0:
        raise ValueError(f"no tile shape for engine {engine!r}")
    return rows.value, up.value, down.value


def grouped_bwd_built(gated: bool) -> dict[str, tuple[int, ...]]:
    """The built tensor-core backward's geometry, read from the library:
    for each launch (``GROUPED_BWD_STEPS``) its threads, output rows and
    columns a tile, contraction a stage, stages, dynamic shared memory and
    the CTAs an SM keeps resident (the occupancy API on the compiled
    kernel; needs a card)."""
    lib = _lib()
    got = {step: tuple(lib.grouped_bwd_geometry(i, int(gated), what)
                       for what in range(7))
           for i, step in enumerate(GROUPED_BWD_STEPS)}
    if min(min(v) for v in got.values()) < 0:
        raise RuntimeError(f"grouped_bwd_geometry: {got}")
    return got


def down_product_f32(h: torch.Tensor, w1: torch.Tensor,
                     w1_gate: torch.Tensor | None, w2: torch.Tensor,
                     valid: torch.Tensor, mlp: str) -> torch.Tensor:
    """The tensor-core engine's f32 result before it is rounded to bf16
    (act_hi w2 + act_lo w2 as accumulated; rows past valid exactly 0), for
    checks that hold its second product to the reference's f32 product at
    f32 tolerances, which the bf16 output cannot show.  bf16 on a CUDA
    card, at shapes the tensor-core engine takes."""
    _check_card(h, w1, w1_gate, w2, valid, mlp)
    plan = grouped_plan(h, w1, w2, mlp)
    if plan.engine != "wgmma":
        raise ValueError(f"down_product_f32 needs the tensor-core engine; "
                         f"got {plan}")
    out = torch.empty(h.shape, dtype=torch.float32, device=h.device)
    _launch(h, w1, w1_gate, w2, valid, mlp, plan, out)
    return out


def _check_dy(h: torch.Tensor, dy: torch.Tensor) -> None:
    """What the backward kernels take of dy beyond h's checks."""
    if dy.shape != h.shape or dy.dtype != h.dtype or dy.device != h.device:
        raise ValueError(f"dy must be like h {tuple(h.shape)} {h.dtype}; got "
                         f"{tuple(dy.shape)} {dy.dtype} on {dy.device}")
    if not dy.is_contiguous():
        raise ValueError("the grouped-expert backward takes a contiguous dy")


def grouped_expert_ffn_bwd(h: torch.Tensor, w1: torch.Tensor,
                           w1_gate: torch.Tensor | None, w2: torch.Tensor,
                           valid: torch.Tensor, dy: torch.Tensor, mlp: str):
    """The backward of ``grouped_expert_ffn`` at dy: (dh, dw1, dw1g, dw2) in
    the operands' types (dw1g None when ungated).  A CUDA tensor launches
    the backward kernels on ``bwd_engine``'s engine (or raises), a CPU
    tensor takes ``grouped_expert_ffn_bwd_torch``, and a meta tensor under
    a recorder is counted as one launch of ``grouped_bwd_work``.  Like the
    forward it reads ``valid`` on the card only, so it can be captured in
    a CUDA graph."""
    global GROUPED_BWD_LAUNCHES
    _check_shapes(h, w1, w1_gate, w2, valid, mlp)
    if h.device.type == "cpu":
        return grouped_expert_ffn_bwd_torch(h, w1, w1_gate, w2, valid, dy,
                                            mlp)
    reads = (h, w1, w1_gate, w2, valid, dy)
    if instrument.is_meta(h):
        _check_operands(h, w1, w1_gate, w2, valid)
        _check_dy(h, dy)
        outs = (torch.empty_like(h), torch.empty_like(w1),
                None if w1_gate is None else torch.empty_like(w1_gate),
                torch.empty_like(w2))
        return instrument.meta_kernel(
            "grouped_expert_ffn_bwd", reads, outs,
            work=_work(h, w1, valid, mlp, True, grouped_bwd_work))
    _check_card(h, w1, w1_gate, w2, valid, mlp)
    _check_dy(h, dy)
    engine = bwd_engine(h, w1, w2)
    n_g, c, d = h.shape
    e, _, f = w1.shape
    ctas = 0
    if engine == "mma":
        ctas = _sm_count(h.device.index if h.device.index is not None
                         else torch.cuda.current_device())
        bad = [name for name, t in (("h", h), ("w1", w1), ("w1_gate", w1_gate),
                                    ("w2", w2), ("dy", dy))
               if t is not None and t.data_ptr() % 16]
        if bad:
            raise ValueError(f"the tensor-core grouped backward loads by "
                             f"TMA: {', '.join(bad)} must start on a 16-byte "
                             f"boundary")
        # act, dU (and dG) as bf16 hi/lo planes, then the f32 dact in the
        # bytes of two more
        ws = torch.empty((8 if gated(mlp) else 6, n_g, c, f),
                         dtype=torch.bfloat16, device=h.device)
    else:
        ws = torch.empty((3 if gated(mlp) else 2, n_g, c, f),
                         dtype=torch.float32, device=h.device)
    dh, dw1, dw2 = (torch.empty_like(t) for t in (h, w1, w2))
    dw1g = None if w1_gate is None else torch.empty_like(w1_gate)
    counts = valid.to(torch.int32).contiguous()
    lib = _lib()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = lib.grouped_ffn_bwd_launch(
            _DTYPE_CODE[h.dtype], _BWD_ENGINE_CODE[engine], _ACT_CODE[mlp],
            h.data_ptr(), w1.data_ptr(),
            None if w1_gate is None else w1_gate.data_ptr(), w2.data_ptr(),
            dy.data_ptr(), counts.data_ptr(), ws.data_ptr(), dh.data_ptr(),
            dw1.data_ptr(), None if dw1g is None else dw1g.data_ptr(),
            dw2.data_ptr(), n_g, c, d, f, e, ctas, stream)
    if err != 0:
        raise RuntimeError(f"grouped_expert_ffn backward kernel launch "
                           f"failed: {lib.grouped_error_string(err).decode()}")
    GROUPED_BWD_LAUNCHES += 1
    BWD_ENGINE_LAUNCHES[engine] += 1
    outs = (dh, dw1, dw1g, dw2)
    instrument.note_kernel("grouped_expert_ffn_bwd", reads,
                           [t for t in outs if t is not None],
                           work=_work(h, w1, valid, mlp, False,
                                      grouped_bwd_work))
    return outs


class _GroupedFFN(torch.autograd.Function):
    """The kernel forward and backward (the plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, h, w1, w1_gate, w2, valid, mlp):
        ctx.save_for_backward(h, w1, w1_gate, w2, valid)
        ctx.mlp = mlp
        if h.device.type == "cpu":
            return grouped_expert_ffn_torch(h, w1, w1_gate, w2, valid, mlp)
        return grouped_expert_ffn_cuda(h, w1, w1_gate, w2, valid, mlp)

    @staticmethod
    def backward(ctx, dy):
        h, w1, w1_gate, w2, valid = ctx.saved_tensors
        grads = grouped_expert_ffn_bwd(h, w1, w1_gate, w2, valid,
                                       dy.contiguous(), ctx.mlp)
        return (*[g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)], None,
                None)


def grouped_expert_ffn(h: torch.Tensor, w1: torch.Tensor,
                       w1_gate: torch.Tensor | None, w2: torch.Tensor,
                       valid: torch.Tensor, *, mlp: str,
                       engine: str = "auto") -> torch.Tensor:
    """Batched expert FFN over capacity groups, padded rows skipped: the
    CUDA kernel for a CUDA tensor, the plain version for a CPU tensor or
    with ``engine="torch"``.  Differentiable in h and the weights."""
    if engine not in ("auto", "torch"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "torch":
        return grouped_expert_ffn_torch(h, w1, w1_gate, w2, valid, mlp)
    _check_shapes(h, w1, w1_gate, w2, valid, mlp)
    # the kernels take contiguous operands: an FSDP-gathered expert weight
    # is a moved view of the gathered blocks
    return _GroupedFFN.apply(
        h.contiguous(), w1.contiguous(),
        None if w1_gate is None else w1_gate.contiguous(), w2.contiguous(),
        valid, mlp)
