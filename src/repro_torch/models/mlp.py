"""The gated FFN, SwiGLU or GeGLU (the counterpart of the JAX package's
``models/mlp.py``): h = act(g) * u, then ``w_down``, with act silu or,
under ``cfg.activation`` "gelu" (recurrentgemma), the JAX logistic
``gelu``, which keeps the JAX rounding points (gelu rounded to the
activation dtype, then the product; the SwiGLU rounds once).

With ``cfg.fuse_gate_up`` (the paper's V1 and later) the gate and up
projections are one matrix, ``w_gate_up``: a quantized one runs the
product and the activation as one operation (``ops.quant_matmul_swiglu``,
``act`` "silu" or "gelu"), a plain one runs ``linear`` and then the
standalone ``layers.swiglu`` / ``layers.geglu``. The unfused V0
(``scheduler_version`` "v0") keeps ``w_gate`` and ``w_up`` apart: two
GEMM launches write g and u into the two halves of one (M, 2F) row
(``ops.matmul(out=)``), and the standalone kernel runs on it, under any
weight format; nothing of V0 is fused.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.quant.quantize import QuantizedTensor


def mlp_specs(cfg: ModelConfig) -> Dict:
    D, F = cfg.d_model, cfg.d_ff
    if cfg.fuse_gate_up:
        specs = {"w_gate_up": layers.linear_spec(D, 2 * F)}
    else:
        specs = {"w_gate": layers.linear_spec(D, F),
                 "w_up": layers.linear_spec(D, F)}
    specs["w_down"] = layers.linear_spec(F, D)
    return specs


def gate_up(p, x2: torch.Tensor) -> torch.Tensor:
    """The unfused V0 gate and up products of x2 (M, D), each written into
    its half of one (M, 2F) buffer, [g | u]: the layout of the fused
    product, which ``layers.swiglu`` and ``layers.geglu`` take."""
    F = ops.out_width(p["w_up"]["w"])
    gu = torch.empty((x2.shape[0], 2 * F), dtype=x2.dtype, device=x2.device)
    ops.matmul(x2, p["w_gate"]["w"], out=gu[:, :F])
    ops.matmul(x2, p["w_up"]["w"], out=gu[:, F:])
    return gu


def mlp_forward(p, x: torch.Tensor, activation: str = "silu") -> torch.Tensor:
    x2 = x.reshape(-1, x.shape[-1])
    glu = layers.geglu if activation == "gelu" else layers.swiglu
    if "w_gate_up" not in p:
        h = glu(gate_up(p, x2))
    elif isinstance(p["w_gate_up"]["w"], QuantizedTensor):
        kw = {"act": "gelu"} if activation == "gelu" else {}
        h = ops.quant_matmul_swiglu(x2, p["w_gate_up"]["w"], **kw)
    else:
        h = glu(layers.linear(p["w_gate_up"], x2))
    h = h.reshape(*x.shape[:-1], h.shape[-1])
    return layers.linear(p["w_down"], h)
