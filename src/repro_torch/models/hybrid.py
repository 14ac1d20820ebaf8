"""The RG-LRU temporal block of the hybrid family (RecurrentGemma
[arXiv:2402.19427]): the counterpart of the JAX package's
``models/hybrid.py``.

A layer's input x (B, S, D) goes through ``in_proj`` (D, 2w), whose two
halves are the recurrence's branch and the gate. The branch runs the
causal conv of width 4 (``ops.ssm_conv``, the SSM family's kernel, with its
conv state), then the products of ``wa`` and ``wx`` (w, w), written side by
side into one (M, 2w) row, [x wa | x wx], by two GEMM launches
(``ops.matmul(out=)``) so that the RG-LRU kernel reads one row; their
biases are added inside that kernel. The recurrence and the gelu-gated
output are one launch (``ops.rglru_scan`` over a prompt,
``ops.rglru_decode_step`` for one token; ``kernels/rglru.py`` has the
arithmetic), and ``out_proj`` (w, D) closes the block.

A decode step of an RG-LRU layer of the hybrid model launches 10 kernels
under quantized weights: ``add_rmsnorm``, ``in_proj`` (``quant_matmul``),
``ssm_conv``, ``wa`` and ``wx`` (two ``quant_matmul``),
``rglru_decode_step``, ``out_proj`` (``quant_matmul``), ``add_rmsnorm``, the
gate-up GEMM with its GeGLU (``quant_matmul_swiglu``) and ``w_down``
(``quant_matmul``); under bf16 weights the five linears are library
products and the GeGLU runs alone (``geglu``). A prefill of the layer runs
``rglru_scan`` in place of the decode step. ``chip_smoke.py`` checks these
counts.

A layer's cache is ``{"conv": (B, 3, w) in the activation dtype, "state":
(B, w) f32}``; the model keeps one ``lens`` beside the layers. Both are
updated in place. As in the JAX package, a prefill starts from zero
states and stores as the layer's state the gated output y of the prompt's
last position (the JAX ``rglru_forward`` returns ``h[:, -1]`` after ``h``
became the gated output), while a decode step stores the recurrence's h.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.params import ParamSpec

CONV_WIDTH = 4


def rglru_specs(cfg: ModelConfig) -> Dict:
    D, w = cfg.d_model, cfg.lru_width
    return {
        "in_proj": {"w": ParamSpec((D, 2 * w))},
        "conv_w": ParamSpec((CONV_WIDTH, w)),
        "conv_b": ParamSpec((w,), init="zeros"),
        "wa": {"w": ParamSpec((w, w)), "b": ParamSpec((w,), init="zeros")},
        "wx": {"w": ParamSpec((w, w)), "b": ParamSpec((w,), init="zeros")},
        "a_param": ParamSpec((w,), init="small_a"),
        "out_proj": {"w": ParamSpec((w, D))},
    }


def _gate_products(p, xb: torch.Tensor) -> torch.Tensor:
    """[xb wa | xb wx] (M, 2w) of the conv's output xb (M, w): two GEMMs,
    each writing its half of one row; the biases are the kernels'."""
    w = ops.out_width(p["wa"]["w"])
    gx = torch.empty((xb.shape[0], 2 * w), dtype=xb.dtype, device=xb.device)
    ops.matmul(xb, p["wa"]["w"], out=gx[:, :w])
    ops.matmul(xb, p["wx"]["w"], out=gx[:, w:])
    return gx


def rglru_forward(p, cfg: ModelConfig, x: torch.Tensor,
                  cache: Dict) -> torch.Tensor:
    """A prompt's layer, x (B, S, D) → (B, S, D), from zero states (as the
    JAX ``Model.prefill`` runs ``rglru_forward(cache=None)``); the new conv
    state and the last position's gated output, as the state, are written
    into the layer's cache rows."""
    B, S, _ = x.shape
    w = cfg.lru_width
    xg = layers.linear(p["in_proj"], x)
    xb, gate = xg[..., :w], xg[..., w:]
    xb = ops.ssm_conv(xb, p["conv_w"], p["conv_b"], cache["conv"],
                      carry=False)
    gx = _gate_products(p, xb.reshape(B * S, w)).view(B, S, 2 * w)
    y = ops.rglru_scan(xb, gx, gate, p["wa"]["b"], p["wx"]["b"],
                       p["a_param"], cache["state"])
    return layers.linear(p["out_proj"], y)


def rglru_decode(p, cfg: ModelConfig, x: torch.Tensor, cache: Dict,
                 advance: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One token, x (B, 1, D) → (B, 1, D). The rows where ``advance`` (B,)
    is False keep their conv and recurrent states (the JAX
    ``_freeze_rows``)."""
    B = x.shape[0]
    w = cfg.lru_width
    xg = layers.linear(p["in_proj"], x)
    xb, gate = xg[..., :w], xg[..., w:]
    xb = ops.ssm_conv(xb, p["conv_w"], p["conv_b"], cache["conv"], advance)
    gx = _gate_products(p, xb[:, 0])
    y = ops.rglru_decode_step(xb[:, 0], gx, gate[:, 0], p["wa"]["b"],
                              p["wx"]["b"], p["a_param"], cache["state"],
                              advance)
    return layers.linear(p["out_proj"], y).reshape(B, 1, -1)


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device) -> Dict:
    w = cfg.lru_width
    return {
        "conv": torch.zeros((batch, CONV_WIDTH - 1, w), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, w), dtype=torch.float32, device=device),
    }
