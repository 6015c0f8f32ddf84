"""Architecture registry: ``get_config(arch_id)`` / ``list_archs()``.

Each module defines ``CONFIG`` (exact published dims from the assignment)
and ``reduced()`` (tiny same-family variant for CPU smoke tests).
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import (SHAPES, EncoderConfig, ModelConfig, MoEConfig,
                                ShapeConfig, SSMConfig, VisionConfig,
                                shape_applicable)

ARCH_IDS = [
    "nemotron-4-340b",
    "granite-34b",
    "starcoder2-7b",
    "phi4-mini-3.8b",
    "mamba2-130m",
    "hymba-1.5b",
    "grok-1-314b",
    "moonshot-v1-16b-a3b",
    "whisper-small",
    "internvl2-1b",
]


def _module(arch_id: str):
    return importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return _module(arch_id).CONFIG


def get_reduced(arch_id: str) -> ModelConfig:
    return _module(arch_id).reduced()


def list_archs() -> list[str]:
    return list(ARCH_IDS)


__all__ = ["ARCH_IDS", "SHAPES", "EncoderConfig", "ModelConfig", "MoEConfig",
           "ShapeConfig", "SSMConfig", "VisionConfig", "get_config",
           "get_reduced", "list_archs", "shape_applicable"]
