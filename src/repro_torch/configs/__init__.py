"""Config registry: ``get_config("<arch-id>")`` / ``--arch <id>``."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, reduced
from repro_torch.configs.deepseek_7b import CONFIG as DEEPSEEK_7B
from repro_torch.configs.paper_models import LLAMA32_1B

CONFIGS = {c.name: c for c in (LLAMA32_1B, DEEPSEEK_7B)}


def get_config(name: str, **overrides) -> ModelConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(CONFIGS)}")
    cfg = CONFIGS[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


__all__ = ["ModelConfig", "reduced", "get_config", "CONFIGS",
           "LLAMA32_1B", "DEEPSEEK_7B"]
