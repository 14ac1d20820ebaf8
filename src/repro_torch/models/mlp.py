"""SwiGLU FFN with the gate and up projections fused into one matrix
(the counterpart of the JAX package's ``models/mlp.py``). A quantized
``w_gate_up`` runs the product and the SwiGLU as one operation
(``ops.quant_matmul_swiglu``); a plain one runs ``linear`` and then
``layers.swiglu``."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.quant.quantize import QuantizedTensor


def mlp_specs(cfg: ModelConfig) -> Dict:
    return {"w_gate_up": layers.linear_spec(cfg.d_model, 2 * cfg.d_ff),
            "w_down": layers.linear_spec(cfg.d_ff, cfg.d_model)}


def mlp_forward(p, x: torch.Tensor) -> torch.Tensor:
    w = p["w_gate_up"]["w"]
    if isinstance(w, QuantizedTensor):
        h = ops.quant_matmul_swiglu(x.reshape(-1, x.shape[-1]), w)
        h = h.reshape(*x.shape[:-1], h.shape[-1])
    else:
        h = layers.swiglu(layers.linear(p["w_gate_up"], x))
    return layers.linear(p["w_down"], h)
