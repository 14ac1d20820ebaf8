"""Mixture-of-experts FFN with sort-based dispatch and a static capacity
(the counterpart of the JAX package's ``models/moe.py``).

``moe_forward`` takes that module's steps in its order:

  1. the router's f32 logits, ``x.float() @ w.float()``, summed in an
     order that does not depend on the number of tokens (``moe_route``'s
     first launch: the library's f32 product does, on the H100);
  2. softmax and top-k, the gates renormalized (``moe_route``);
  3. the stable sort-based dispatch with capacity C = ``capacity(cfg,
     B·S)``: each (token, k) pair's slot is its rank among its expert's
     pairs in flat order, and pairs at slot >= C drop (``moe_route``);
  4. the expert GEMMs over the kept rows, the tokens gathered through the
     route's map (``moe_gate_up_swiglu``, ``moe_down``);
  5. gather back and combine with the gates (``moe_combine``);
  6. the shared experts, always on (kimi-k2): the two GEMMs as one group
     of all T rows, their output added in the activation dtype.

At decode (``moe_down_combined(C)``) the down GEMM and the combine are
one pair of launches, ``moe_down_combine``, with the same bits: y is
never written there.

The rounding points are the JAX module's: gu in f32, silu(g) · u in f32
cast once; y in f32 cast once; the combine in f32 cast once; the shared
output added to it in the activation dtype. Unlike the JAX einsums, the
GEMMs read only the experts that have rows and only those rows; rows
past a count are never gathered back there either, so the function is
the same.

The serving path does not compute the Switch load-balance loss (XLA
drops it as dead code in the JAX serving path too); ``router_aux_loss``
computes it alone, for training.

The experts' weights are bf16 (or f32) only: the JAX MoE has no
quantized-weight path (its ``quantize_tree`` would quantize the router
and the stacked experts, which ``moe_forward`` then cannot read), so
``check_weight_format`` refuses a quantized policy for an MoE config.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.moe import capacity as _capacity
from repro_torch.kernels.moe import moe_down_combined, router_logits_plain
from repro_torch.models.params import ParamSpec
from repro_torch.quant.quantize import FLOAT_FORMATS


def moe_specs(cfg: ModelConfig) -> Dict:
    D, F, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    specs: Dict = {
        "router": {"w": ParamSpec((D, E))},
        "experts": {"w_gate_up": ParamSpec((E, D, 2 * F)),
                    "w_down": ParamSpec((E, F, D))},
    }
    if cfg.num_shared_experts:
        S = cfg.num_shared_experts
        specs["shared"] = {"w_gate_up": ParamSpec((D, S * 2 * F)),
                           "w_down": ParamSpec((S * F, D))}
    return specs


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Rows each expert keeps of a call of ``n_tokens`` tokens."""
    return _capacity(cfg.num_experts, cfg.experts_per_token,
                     cfg.capacity_factor, n_tokens)


def check_weight_format(cfg: ModelConfig, quant_policy: str) -> None:
    """Raise for a quantized weight format on an MoE config."""
    if cfg.is_moe and quant_policy not in FLOAT_FORMATS:
        raise ValueError(
            f"{cfg.name}: quantized weights ({quant_policy!r}) are not "
            "served for a mixture-of-experts model: the JAX reference MoE "
            "has no quantized-weight path (its quantize_tree quantizes the "
            "router and the stacked experts, which moe_forward cannot "
            "read), so the port serves MoE weights in bf16 only")


def router_logits(p, x2: torch.Tensor) -> torch.Tensor:
    """(T, D) → f32 (T, E), the plain product."""
    return router_logits_plain(x2, p["router"]["w"])


def moe_forward(p, cfg: ModelConfig, x: torch.Tensor,
                reads: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, S, D) → (B, S, D) in x's dtype. ``reads`` (int64 (2,), on
    x's device) gains the experts that had a pair and one layer pass."""
    B, S, D = x.shape
    T = B * S
    C = capacity(cfg, T)
    x2 = x.reshape(T, D)
    gates, experts, slots, counts, src, _ = ops.moe_route(
        x2, p["router"]["w"], cfg.experts_per_token, C, reads)
    h = ops.moe_gate_up_swiglu(x2, p["experts"]["w_gate_up"], C, counts,
                               src)
    shared = None
    if "shared" in p:
        w_gu, w_d = p["shared"]["w_gate_up"], p["shared"]["w_down"]
        h_s = ops.moe_gate_up_swiglu(x2, w_gu[None], T)
        shared = ops.moe_down(h_s, w_d[None])[0]
    w_down = p["experts"]["w_down"]
    if moe_down_combined(C):
        out = ops.moe_down_combine(h, w_down, gates, experts, slots, counts,
                                   shared)
    else:
        y = ops.moe_down(h, w_down, counts)
        out = ops.moe_combine(y, gates, experts, slots, shared)
    return out.reshape(B, S, D)


def router_aux_loss(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The Switch-style load-balance loss of the JAX ``moe_forward``'s
    ``aux``: ``router_aux_weight · E · Σ_e mean_t(probs) · mean_t(top-1
    is e)``, f32 scalar."""
    E = cfg.num_experts
    logits = router_logits(p, x.reshape(-1, x.shape[-1]))
    probs = torch.softmax(logits, dim=-1)
    top1 = torch.sort(logits, dim=-1, descending=True,
                      stable=True).indices[:, 0]
    me = probs.mean(0)
    ce = torch.nn.functional.one_hot(top1, E).float().mean(0)
    return cfg.router_aux_weight * E * torch.sum(me * ce)
