"""InternVL2-1B [vlm]: InternLM2-backbone 24L, d_model 896, 14H GQA(kv=2),
d_ff 4864, vocab 151655.  InternViT frontend is a STUB per assignment:
input_specs provides precomputed patch embeddings.  [arXiv:2404.16821]"""

import dataclasses

from repro_torch.configs.base import ModelConfig, VisionConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,            # padded to 16 for TP16
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    mlp="swiglu",
    rope_theta=1_000_000.0,
    vision=VisionConfig(n_patches=256),
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=256, tp_multiple=1, vision=VisionConfig(n_patches=4))
