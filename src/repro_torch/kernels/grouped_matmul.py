"""Grouped-expert FFN — hand-written CUDA kernel + plain PyTorch version
(port of ``repro.kernels.grouped_matmul``).

The MoE capacity buffers are [G, C, D] groups of padded rows (G = E
experts, or E_loc x tp (expert, source-rank) groups after the EP
all_to_all); only the first ``valid[g]`` rows of each group hold real
tokens, the rest are padding sized by the capacity factor.  Group g uses
expert ``g // (G / E)``.

Two engines with the same arithmetic:

  * the CUDA kernel ``csrc/grouped_matmul.cu`` (Hopper, ``sm_90a``), in
    place of the reference's Pallas TPU kernel
    ``grouped_expert_ffn_pallas``: two launches tiled in D and F (the
    first products and the activation into an f32 workspace, then the
    f32 down-projection); row tiles wholly past ``valid[g]`` do no
    arithmetic.  The valid counts stay a device tensor the kernel reads,
    so a call never syncs with the host;
  * ``grouped_expert_ffn_torch`` — rows masked by the same predicate,
    then batched products in f32 (the reference's
    ``grouped_expert_ffn_jnp``).

``grouped_expert_ffn`` is a ``torch.autograd.Function``: a CUDA tensor
launches the kernel (or raises), a CPU tensor takes the plain version,
and ``engine="torch"`` pins the plain version on any device.  Its
backward recomputes through the plain version (the reference's custom VJP,
whose backward is jnp, not a kernel).  ``GROUPED_LAUNCHES`` counts kernel
calls.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

#: kernel calls since the count was last set to 0
GROUPED_LAUNCHES = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ACT_CODE = {"swiglu": 0, "geglu": 1, "relu2": 2, "gelu": 3}


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
# Plain PyTorch version (the oracle, and the backward of the kernel path)
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


# ---------------------------------------------------------------------------
# The CUDA kernel's wrapper
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = build.load("grouped_matmul")
    if lib.grouped_ffn_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.grouped_ffn_launch.argtypes = [i, i, p, p, p, p, p, p, p, i, i,
                                           i, i, i, p]
        lib.grouped_ffn_launch.restype = i
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


def grouped_expert_ffn_cuda(h: torch.Tensor, w1: torch.Tensor,
                            w1_gate: torch.Tensor | None, w2: torch.Tensor,
                            valid: torch.Tensor, mlp: str) -> torch.Tensor:
    """One call of the kernel (both launches) on CUDA tensors; raises on
    anything it does not take."""
    global GROUPED_LAUNCHES
    _check_shapes(h, w1, w1_gate, w2, valid, mlp)
    weights = [w1, w2] + ([w1_gate] if w1_gate is not None else [])
    if h.device.type != "cuda":
        raise RuntimeError(f"no grouped-expert kernel for {h.device}")
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
    n_g, c, d = h.shape
    e, _, f = w1.shape
    out = torch.empty_like(h)
    counts = valid.to(torch.int32).contiguous()
    ws = torch.empty((n_g, c, f), dtype=torch.float32, device=h.device)
    lib = _lib()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = lib.grouped_ffn_launch(
            _DTYPE_CODE[h.dtype], _ACT_CODE[mlp], h.data_ptr(),
            w1.data_ptr(), None if w1_gate is None else w1_gate.data_ptr(),
            w2.data_ptr(), counts.data_ptr(), ws.data_ptr(), out.data_ptr(),
            n_g, c, d, f, e, stream)
    if err != 0:
        raise RuntimeError(f"grouped_expert_ffn kernel launch failed: "
                           f"{lib.grouped_error_string(err).decode()}")
    GROUPED_LAUNCHES += 1
    return out


class _GroupedFFN(torch.autograd.Function):
    """The kernel forward (the plain version on the CPU) with a backward
    that recomputes through the plain version."""

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
        operands = (h, w1, w1_gate, w2)
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(need)
                      for t, need in zip(operands, ctx.needs_input_grad)]
            out = grouped_expert_ffn_torch(*leaves, valid, ctx.mlp)
            wrt = [t for t in leaves if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, dy) if wrt else ())
        return (*[next(grads) if t is not None and t.requires_grad else None
                  for t in leaves], None, None)


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
    return _GroupedFFN.apply(h, w1, w1_gate, w2, valid, mlp)
