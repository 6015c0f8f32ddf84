"""Moonlight-16B-A3B [moe]: 48L, d_model 2048, 16H GQA(kv=16), MoE 64
experts top-6 with expert d_ff 1408, vocab 163840.
[hf:moonshotai/Moonlight-16B-A3B]

64 experts % TP16 == 0 -> expert-parallel all_to_all dispatch path.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=0,
    vocab_size=163840,
    mlp="swiglu",
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, impl="ep_a2a"),
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        vocab_size=256, tp_multiple=1,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64, impl="ep_a2a"))
