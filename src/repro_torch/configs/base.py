"""Model/config system.  One ``ModelConfig`` covers every assigned family
(dense / moe / ssm / hybrid / audio / vlm); per-arch files instantiate the
exact published dimensions and provide ``reduced()`` smoke-test variants.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.parallel.sharding import pad_to_multiple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # EP via all_to_all when n_experts % tp == 0, else expert-TP dense path
    impl: str = "auto"      # auto | ep_a2a | expert_tp
    # -- managed dispatch schedule: how routed tokens cross the EP
    # axis.  "bulk" = one all_to_all into capacity buffers (the unmanaged
    # baseline); "stream" = capacity chunks ppermute'd around the EP ring
    # under the expert FFN; "dense" = no dispatch (every rank runs its
    # local experts on the full token set, reduce-scattered back); "auto"
    # = core/cost_model.decide_moe_dispatch picks (schedule, g,
    # capacity_factor) and logs the DecisionRecord -------------------------
    dispatch: str = "bulk"  # bulk | stream | dense | auto
    dispatch_g: int = 0     # stream chunk count (0 = cost-model pick)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    chunk: int = 256
    # Hymba-style hybrid: SSM output fused with attention in parallel heads
    parallel_with_attn: bool = False


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder (conv frontend stubbed per assignment:
    input_specs provides precomputed frame embeddings)."""
    n_layers: int
    n_frames: int = 1500


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """InternVL-style ViT frontend stub: precomputed patch embeddings are
    prepended to the token stream."""
    n_patches: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                     # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                  # 0 -> d_model // n_heads
    mlp: str = "swiglu"              # swiglu | relu2 | gelu
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    vision: Optional[VisionConfig] = None
    sliding_window: int = 0          # 0 = full attention
    # Hybrid archs: indices of layers using *full* attention (others SWA)
    full_attn_layers: tuple[int, ...] = ()
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # -- attention comm strategy: "megatron" (AG-matmul rings), "ulysses"
    # (a2a head/seq switch), "ring" (context parallelism: KV streamed
    # around 'model' under flash compute — O(S_loc) activation memory), or
    # "auto" (the managed runtime picks per call site from the cost model
    # and logs the DecisionRecord; EXPERIMENTS.md §Attention-schedules) ---
    attn_impl: str = "megatron"
    # -- training memory knobs ------------------------------------------------
    remat: bool = True
    accum_steps: int = 1             # gradient accumulation microbatches
    moment_dtype: str = "float32"    # bf16 for the 100B+ archs (DESIGN.md)
    # -- padding for TP divisibility (derived; see padded_* properties) -------
    tp_multiple: int = 16

    # ---- derived ----
    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        assert self.n_heads > 0
        return self.d_model // self.n_heads

    @property
    def padded_heads(self) -> int:
        return pad_to_multiple(self.n_heads, self.tp_multiple) \
            if self.n_heads else 0

    @property
    def padded_vocab(self) -> int:
        return pad_to_multiple(self.vocab_size, 128)

    @property
    def padded_ff(self) -> int:
        return pad_to_multiple(self.d_ff, self.tp_multiple) if self.d_ff else 0

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        assert self.ssm is not None
        return self.ssm.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        assert self.ssm is not None
        return pad_to_multiple(self.d_inner // self.ssm.headdim,
                               self.tp_multiple)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """May this arch run the long_500k shape?  SSM state is O(1);
        hybrid = SSM + sliding-window (few global layers, O(S) decode)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True   # every assigned arch decodes (whisper via its decoder)

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks), used for the
        6·N·D MODEL_FLOPS roofline term."""
        d = self.d_model
        n = 0
        n += self.padded_vocab * d                      # embed
        if not self.tie_embeddings:
            n += self.padded_vocab * d                  # unembed
        per_layer = 0
        if self.family != "ssm":
            hd = self.head_dim
            per_layer += d * self.padded_heads * hd      # Wq
            per_layer += 2 * d * self.n_kv_heads * hd    # Wk, Wv
            per_layer += self.padded_heads * hd * d      # Wo
        mults = 3 if self.mlp in ("swiglu", "geglu") else 2
        if self.moe is not None:
            e = self.moe
            per_layer += d * e.n_experts                 # router
            per_layer += e.n_experts * mults * d * e.d_ff_expert
        elif self.d_ff:
            per_layer += mults * d * self.padded_ff
        if self.ssm is not None:
            di = self.ssm_heads * self.ssm.headdim
            per_layer += d * 2 * di                      # in_proj (x, z)
            per_layer += d * 2 * self.ssm.d_state        # B, C proj
            per_layer += d * self.ssm_heads              # dt proj
            per_layer += di * d                          # out_proj
        n += self.n_layers * per_layer
        if self.encoder is not None:
            # encoder blocks (attn + mlp) + decoder cross-attention
            hd = self.head_dim
            enc_layer = (d * self.padded_heads * hd * 2
                         + 2 * d * self.n_kv_heads * hd
                         + mults * d * self.padded_ff)
            n += self.encoder.n_layers * enc_layer
            n += self.n_layers * (d * self.padded_heads * hd * 2
                                  + 2 * d * self.n_kv_heads * hd)
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        mults = 3 if self.mlp in ("swiglu", "geglu") else 2
        expert_params = self.n_layers * e.n_experts * mults * \
            self.d_model * e.d_ff_expert
        active_expert = expert_params * e.top_k / e.n_experts
        return self.param_count() - expert_params + int(active_expert)


# ---------------------------------------------------------------------------
# Input shapes (assigned): every arch pairs with these four.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether (arch, shape) is a runnable cell, with the skip reason
    (DESIGN.md §3.3)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 500k decode state is "
                       "O(seq)-quadratic; skipped per assignment rules")
    return True, ""
