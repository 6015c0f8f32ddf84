"""Hymba-1.5B [hybrid]: 32L, d_model 1600, 25H GQA(kv=5) in parallel with
mamba heads, d_ff 5504, vocab 32001, d_state 16, sliding-window attention
except 3 global layers.  [arXiv:2411.13676]"""

import dataclasses

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,           # padded to 32 for TP16
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    mlp="swiglu",
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, headdim=64, chunk=256,
                  parallel_with_attn=True),
    sliding_window=1024,
    full_attn_layers=(0, 15, 31),
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=256, sliding_window=16, full_attn_layers=(0,),
        tp_multiple=1,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, headdim=16, chunk=32,
                      parallel_with_attn=True))
