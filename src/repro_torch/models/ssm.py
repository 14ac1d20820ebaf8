"""Mamba-2 SSD (state-space duality) layer [arXiv:2405.21060]: the
counterpart of the JAX package's ``models/ssm.py``.

The fused ``in_proj`` (z, x, B, C and dt from one GEMM: ``quant_matmul``
under quantized weights) feeds the causal conv over the xBC channels, then
the SSD recurrence, the gate ``rmsnorm(y * silu(z))`` and ``out_proj``.
On the card the conv, the recurrence and the gated norm are the kernels
of ``kernels/ssm.py`` (one launch each); on the CPU their plain versions,
which keep the JAX rounding points:

- ``ssm_forward`` (a whole sequence) rounds the scan's y to the
  activation dtype first and adds the D skip after, in that dtype
  (ssm.py:118, :141);
- ``ssm_decode`` (one token) adds the D skip in f32 and rounds after
  (ssm.py:171-172);
- dt = softplus(dt + dt_bias) and A = -exp(A_log) in f32 on both paths,
  and the gate's product in the activation dtype.

A layer's cache is ``{"conv": (B, ssm_conv - 1, d_inner + 2 N) in the
activation dtype, "state": (B, H, P, N) f32}``; the model keeps one
``lens`` beside the layers. Both are updated in place. The JAX package
allocates the conv state in bf16 and stores the activations' dtype into
it at its first write; the port allocates it in that dtype from the
start.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
# the JAX module's conv (which the RG-LRU slice reuses) and scan, kept as
# parts of the kernels' plain versions in kernels/ssm.py
from repro_torch.kernels.ssm import causal_conv as _causal_conv  # noqa: F401
from repro_torch.kernels.ssm import ssd_chunked  # noqa: F401
from repro_torch.models import layers
from repro_torch.models.params import ParamSpec


def ssm_specs(cfg: ModelConfig) -> Dict:
    D, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh = cfg.ssm_heads
    conv_ch = di + 2 * N
    return {
        "in_proj": {"w": ParamSpec((D, 2 * di + 2 * N + nh))},
        "conv_w": ParamSpec((cfg.ssm_conv, conv_ch)),
        "conv_b": ParamSpec((conv_ch,), init="zeros"),
        "A_log": ParamSpec((nh,), init="zeros"),
        "dt_bias": ParamSpec((nh,), init="zeros"),
        "D_skip": ParamSpec((nh,), init="ones"),
        "norm_w": ParamSpec((di,), init="ones"),
        "out_proj": {"w": ParamSpec((di, D))},
    }


def _split_in_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    """(z, xBC, dt) views of the fused projection's columns."""
    di, N = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * N]
    dt = zxbcdt[..., di + di + 2 * N:]
    return z, xbc, dt


def _forward(p, cfg: ModelConfig, x: torch.Tensor, conv: torch.Tensor,
             state: torch.Tensor, carry: bool) -> torch.Tensor:
    """The whole-sequence layer, x (B, S, D) → (B, S, D), reading the
    conv and SSD states (``carry``; else zeros) and writing the final
    ones in place."""
    zxbcdt = layers.linear(p["in_proj"], x)
    z, xbc, dt = _split_in_proj(cfg, zxbcdt)
    xbc = ops.ssm_conv(xbc, p["conv_w"], p["conv_b"], conv, carry=carry)
    y = ops.ssd_prefill(xbc, dt, p["dt_bias"], p["A_log"], p["D_skip"],
                        state, carry=carry, chunk=cfg.ssm_chunk)
    y = ops.gated_rmsnorm(y, z, p["norm_w"], cfg.norm_eps)
    return layers.linear(p["out_proj"], y)


def ssm_forward(p, cfg: ModelConfig, x: torch.Tensor,
                conv_state: Optional[torch.Tensor] = None,
                ssd_state: Optional[torch.Tensor] = None,
                return_state: bool = False):
    """Full-sequence SSD layer, x (B, S, D), from the given states (None:
    zeros), which are left as they were. With ``return_state`` returns
    (out, (new conv state, final f32 state))."""
    B = x.shape[0]
    conv = (conv_state.to(x.dtype).clone() if conv_state is not None else
            torch.zeros((B, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state),
                        dtype=x.dtype, device=x.device))
    state = (ssd_state.float().clone() if ssd_state is not None else
             torch.zeros((B, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                         dtype=torch.float32, device=x.device))
    out = _forward(p, cfg, x, conv, state, carry=True)
    return (out, (conv, state)) if return_state else out


def ssm_prefill(p, cfg: ModelConfig, x: torch.Tensor,
                cache: Dict) -> torch.Tensor:
    """A prompt's layer from zero states (as the JAX ``Model.prefill``
    runs ``ssm_forward``), its final states written into the layer's
    cache rows."""
    return _forward(p, cfg, x, cache["conv"], cache["state"], carry=False)


def ssm_decode(p, cfg: ModelConfig, x: torch.Tensor, cache: Dict,
               advance: Optional[torch.Tensor] = None) -> torch.Tensor:
    """O(1) single-token state update, x (B, 1, D) → (B, 1, D). The rows
    where ``advance`` (B,) is False keep their conv and SSD states (the
    JAX ``_freeze_rows``)."""
    B = x.shape[0]
    zxbcdt = layers.linear(p["in_proj"], x)
    z, xbc, dt = _split_in_proj(cfg, zxbcdt)
    y = ops.ssm_decode_step(xbc[:, 0], dt[:, 0], p["conv_w"], p["conv_b"],
                            cache["conv"], p["dt_bias"], p["A_log"],
                            p["D_skip"], cache["state"], advance)
    y = ops.gated_rmsnorm(y[:, None], z, p["norm_w"], cfg.norm_eps)
    return layers.linear(p["out_proj"], y).reshape(B, 1, -1)


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                   device) -> Dict:
    di, N = cfg.d_inner, cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * N),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim, N),
                             dtype=torch.float32, device=device),
    }
