"""Shared building blocks: RMSNorm, RoPE, embeddings, linear layers.

Counterparts of the JAX package's ``models/layers.py`` with the same
rounding points: norms and RoPE compute in f32 and cast back, the
logits of the unembedding are f32.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.params import ParamSpec


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Half-split rotation. x (..., H, D) with positions (...)."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, x.device)                   # (D/2,)
    angles = positions[..., None].float() * freqs            # (..., D/2)
    cos = torch.cos(angles)[..., None, :]                    # over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


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


def linear_spec(d_in: int, d_out: int) -> Dict[str, ParamSpec]:
    return {"w": ParamSpec((d_in, d_out))}


def linear(p, x: torch.Tensor) -> torch.Tensor:
    return ops.matmul(x, p["w"])


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up, in f32 with one rounding to the input dtype."""
    return (F.silu(gate.float()) * up.float()).to(gate.dtype)
