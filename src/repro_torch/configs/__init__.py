"""Config registry: ``get_config("<arch-id>")`` / ``--arch <id>``: the
paper's six models under the JAX package's names, deepseek-7b, the
assigned dense configs (``ASSIGNED_DENSE``: mistral-nemo-12b,
deepseek-67b, qwen1.5-110b), the mixture-of-experts family
(phi3.5-moe-42b-a6.6b, kimi-k2-1t-a32b), the SSM family
(mamba2-2.7b) and the RG-LRU hybrid family (recurrentgemma-2b). ``get_config(name, scheduler_version="v0")`` gives the
paper's unfused V0 of a config, as in the JAX package."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, reduced
from repro_torch.configs.deepseek_67b import CONFIG as DEEPSEEK_67B
from repro_torch.configs.deepseek_7b import CONFIG as DEEPSEEK_7B
from repro_torch.configs.kimi_k2_1t_a32b import CONFIG as KIMI_K2
from repro_torch.configs.mamba2_2_7b import CONFIG as MAMBA2_2_7B
from repro_torch.configs.mistral_nemo_12b import CONFIG as MISTRAL_NEMO_12B
from repro_torch.configs.paper_models import (LLAMA31_8B, LLAMA32_1B,
                                              LLAMA32_3B, MISTRAL_7B,
                                              PAPER_MODELS, QWEN2_0_5B,
                                              QWEN2_1_5B)
from repro_torch.configs.phi3_5_moe_42b import CONFIG as PHI35_MOE
from repro_torch.configs.qwen1_5_110b import CONFIG as QWEN15_110B
from repro_torch.configs.recurrentgemma_2b import CONFIG as RECURRENTGEMMA_2B

MOE_MODELS = {m.name: m for m in (PHI35_MOE, KIMI_K2)}
SSM_MODELS = {MAMBA2_2_7B.name: MAMBA2_2_7B}
HYBRID_MODELS = {RECURRENTGEMMA_2B.name: RECURRENTGEMMA_2B}
ASSIGNED_DENSE = {m.name: m for m in (MISTRAL_NEMO_12B, DEEPSEEK_67B,
                                      QWEN15_110B)}
CONFIGS = {**PAPER_MODELS, DEEPSEEK_7B.name: DEEPSEEK_7B, **ASSIGNED_DENSE,
           **MOE_MODELS, **SSM_MODELS, **HYBRID_MODELS}


def get_config(name: str, **overrides) -> ModelConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(CONFIGS)}")
    cfg = CONFIGS[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


__all__ = ["ModelConfig", "reduced", "get_config", "CONFIGS", "PAPER_MODELS",
           "LLAMA32_1B", "LLAMA32_3B", "LLAMA31_8B", "QWEN2_0_5B",
           "QWEN2_1_5B", "MISTRAL_7B", "DEEPSEEK_7B", "ASSIGNED_DENSE",
           "MISTRAL_NEMO_12B", "DEEPSEEK_67B", "QWEN15_110B", "MOE_MODELS",
           "PHI35_MOE", "KIMI_K2", "SSM_MODELS", "MAMBA2_2_7B",
           "HYBRID_MODELS", "RECURRENTGEMMA_2B"]
