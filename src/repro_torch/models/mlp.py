"""SwiGLU FFN with the gate and up projections fused into one matrix
(the counterpart of the JAX package's ``models/mlp.py``)."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers


def mlp_specs(cfg: ModelConfig) -> Dict:
    return {"w_gate_up": layers.linear_spec(cfg.d_model, 2 * cfg.d_ff),
            "w_down": layers.linear_spec(cfg.d_ff, cfg.d_model)}


def mlp_forward(p, x: torch.Tensor) -> torch.Tensor:
    gu = layers.linear(p["w_gate_up"], x)
    return layers.linear(p["w_down"], layers.swiglu(gu))
