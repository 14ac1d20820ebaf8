"""Shared building blocks: RMSNorm, RoPE, embeddings, linear layers.

Counterparts of the JAX package's ``models/layers.py`` with the same
rounding points: norms and RoPE compute in f32 and cast back, the
logits of the unembedding are f32. RMSNorm (alone, or with the residual
add before it), SwiGLU and GeGLU go through the fused kernels of
``kernels/fused_ops.py``, where ``apply_rope`` (part of the plain
versions of the RoPE + cache write kernels) and the JAX logistic
``gelu`` live too.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import fused_ops, ops
from repro_torch.models.params import ParamSpec


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """The fused RMSNorm kernel on the card, its plain version on the
    CPU (``kernels/fused_ops.py``)."""
    return ops.rmsnorm(x, weight, eps)


def add_rmsnorm(x: torch.Tensor, delta: torch.Tensor, weight: torch.Tensor,
                eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual add and the RMSNorm of its sum, → (x + delta, the
    norm), in one fused kernel on the card (``kernels/fused_ops.py``)."""
    return ops.add_rmsnorm(x, delta, weight, eps)


def embed_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    specs = {"embedding": ParamSpec((cfg.padded_vocab, cfg.d_model),
                                    init="fan_out")}
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((cfg.d_model, cfg.padded_vocab))
    return specs


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embedding"][tokens]


def unembed(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """f32 logits over the padded vocab (the tied table's transpose, or
    the separate ``lm_head``)."""
    w = params["embedding"].t() if cfg.tie_embeddings else params["lm_head"]
    return ops.matmul(x, w, out_dtype=torch.float32)


def linear_spec(d_in: int, d_out: int,
                bias: bool = False) -> Dict[str, ParamSpec]:
    out = {"w": ParamSpec((d_in, d_out))}
    if bias:
        out["b"] = ParamSpec((d_out,), init="zeros")
    return out


def linear(p, x: torch.Tensor) -> torch.Tensor:
    """x @ w. The layers with a bias add it inside the kernel that reads
    the product next, not as a launch of its own: the fused QKV
    projection's inside the RoPE + cache-write kernels
    (``models/attention.py``), the RG-LRU gates' ``wa`` / ``wx`` inside
    the RG-LRU kernels (``models/hybrid.py``)."""
    return ops.matmul(x, p["w"])


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The JAX ``layers.gelu`` (tanh approximation in its logistic form),
    in f32, rounded to x's dtype."""
    return fused_ops.gelu(x)



def swiglu(gu: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up of the fused gate-up output (..., 2 F), in f32 with
    one rounding to the input dtype (the fused kernel on the card)."""
    return ops.swiglu(gu)


def geglu(gu: torch.Tensor) -> torch.Tensor:
    """gelu(gate) * up of the fused gate-up output (..., 2 F), gelu
    rounded to the input dtype and the product again (the fused kernel
    on the card)."""
    return ops.geglu(gu)
