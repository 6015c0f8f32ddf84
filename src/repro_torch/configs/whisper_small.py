"""Whisper-small [audio]: enc-dec, 12L each, d_model 768, 12H MHA,
d_ff 3072, vocab 51865.  Conv frontend is a STUB per assignment:
input_specs provides precomputed frame embeddings.  [arXiv:2212.04356]"""

import dataclasses

from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,           # decoder layers
    d_model=768,
    n_heads=12,            # padded to 16 for TP16
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    mlp="gelu",
    encoder=EncoderConfig(n_layers=12, n_frames=1500),
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab_size=256, tp_multiple=1,
        encoder=EncoderConfig(n_layers=2, n_frames=16))
