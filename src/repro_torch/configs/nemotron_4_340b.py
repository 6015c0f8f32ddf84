"""Nemotron-4-340B [dense]: 96L, d_model 18432, 96H GQA(kv=8), d_ff 73728,
vocab 256000, squared-ReLU MLP, no-bias GQA.  [arXiv:2402.16819]"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    mlp="relu2",
    rope_theta=10000.0,
    # 340B-scale memory posture on a 256-chip pod: bf16 Adam moments +
    # deep gradient accumulation (DESIGN.md §3.1).
    moment_dtype="bfloat16",
    accum_steps=8,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=256, accum_steps=1, moment_dtype="float32", tp_multiple=1)
