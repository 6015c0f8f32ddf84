"""Grok-1-314B [moe]: 64L, d_model 6144, 48H GQA(kv=8), MoE 8 experts top-2
with expert d_ff 32768, vocab 131072.  [hf:xai-org/grok-1]

8 experts on a TP16 axis -> expert-TP path (each expert's FFN sharded over
the model axis, capacity-limited local dispatch); see DESIGN.md §3.3.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=0,
    vocab_size=131072,
    mlp="geglu",  # gated GeLU expert FFN -> ~314B
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32768, impl="expert_tp"),
    moment_dtype="bfloat16",
    accum_steps=4,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        vocab_size=256, accum_steps=1, moment_dtype="float32", tp_multiple=1,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64, impl="expert_tp"))
