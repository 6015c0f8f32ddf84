"""StarCoder2-7B [dense]: 32L, d_model 4608, 36H GQA(kv=4), d_ff 18432,
vocab 49152, RoPE.  [arXiv:2402.19173]"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,           # padded to 48 for TP16 (DESIGN.md §3.3)
    n_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    mlp="gelu",
    rope_theta=1_000_000.0,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=256, tp_multiple=1)
