"""Mamba2-130M [ssm]: 24L, d_model 768, attention-free SSD,
vocab 50280, d_state 128.  [arXiv:2405.21060]"""

import dataclasses

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, headdim=64, chunk=256),
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, vocab_size=256, tp_multiple=1,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, headdim=16, chunk=32))
