"""Granite-34B-Code [dense]: 88L, d_model 6144, 48H MQA(kv=1), d_ff 24576,
vocab 49152, llama-style arch.  [arXiv:2405.04324]"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    mlp="gelu",   # GPT-BigCode-style 2-matrix MLP -> ~34B
    rope_theta=10000.0,
    accum_steps=2,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=256,
        vocab_size=256, accum_steps=1, tp_multiple=1)
