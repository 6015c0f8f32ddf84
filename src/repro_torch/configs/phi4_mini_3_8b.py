"""Phi-4-mini-3.8B [dense]: 32L, d_model 3072, 24H GQA(kv=8), d_ff 8192,
vocab 200064, RoPE + SwiGLU.  [arXiv:2412.08905]"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,           # padded to 32 for TP16
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    mlp="swiglu",
    rope_theta=10000.0,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=256, tp_multiple=1)
