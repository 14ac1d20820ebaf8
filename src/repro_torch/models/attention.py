"""GQA attention: the prefill's causal self-attention and one decode
token over a dense KV cache.

Counterpart of the JAX package's ``models/attention.py``:
``attention_forward`` (the self-attention branch at positions 0..S-1,
whose ``return_kv`` rows the JAX ``prefill`` writes into the cache),
``attention_decode``, ``kv_cache_read`` and ``init_kv_cache``. RoPE and
the cache write are one fused kernel on each path
(``ops.rope_cache_write`` and ``ops.rope_cache_write_prefill``), whose
plain versions, with ``kv_cache_write`` and ``kv_cache_write_prefill``,
live in ``kernels/fused_ops.py``; ``chunked_attention`` is in
``repro_torch.kernels.flash_attention``: it is the plain version of the
prefill attention kernel there, and ``attention_forward`` reaches it
through ``ops.attention``. Paging, cross-attention and ``kv_override``
are not ported yet.

The cache is updated in place. A row whose ``advance`` flag is False
(a frozen slot of the serving engine) keeps its old cache contents:
the write selects the old row back in for it, which replaces the JAX
package's write-then-select of the old value (``_freeze_rows``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.quant.quantize import (FLOAT_FORMATS, dequantize_rows,
                                        kv_group_size)


def attention_specs(cfg: ModelConfig) -> Dict:
    return {"wqkv": layers.linear_spec(cfg.d_model,
                                       cfg.q_dim + 2 * cfg.kv_dim),
            "wo": layers.linear_spec(cfg.q_dim, cfg.d_model)}


def attention_forward(p, cfg: ModelConfig, x: torch.Tensor,
                      cache: Dict) -> torch.Tensor:
    """Causal self-attention of a prefill: x (B, S, D_model) at positions
    0..S-1 of every row. The roped K and the V go into positions [0, S)
    of one layer's cache, in place; RoPE of q and k and that write are
    one fused kernel (``ops.rope_cache_write_prefill``; its plain version
    is ``apply_rope`` twice, the transposes and
    ``kv_cache_write_prefill``)."""
    B, S, _ = x.shape
    check_cache_format(cfg, cache)
    qkv = layers.linear(p["wqkv"], x)
    q, k, v = ops.rope_cache_write_prefill(qkv, cache, cfg.rope_theta,
                                           cfg.kv_quant)
    out = ops.attention(q, k, v, causal=True, window=0)
    out = out.transpose(1, 2).reshape(B, S, cfg.q_dim)
    return layers.linear(p["wo"], out)


def check_cache_format(cfg: ModelConfig, cache: Dict) -> None:
    """Raise when a layer's cache leaves are not ``cfg.kv_quant``'s."""
    if ("k_scale" in cache) == (cfg.kv_quant in FLOAT_FORMATS):
        raise ValueError(f"cache leaves {sorted(cache)} are not a "
                         f"{cfg.kv_quant} cache")


def attention_decode(p, cfg: ModelConfig, x: torch.Tensor, cache: Dict,
                     lens: torch.Tensor, kv_len: torch.Tensor,
                     advance: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, 1, D); cache one layer's leaves (B, Hkv, S, ·); lens (B,)
    tokens already cached per row; kv_len (B,) = ``min(lens + 1, S)``,
    the positions attention reads (the caller computes it once for every
    layer). The new token's K/V go to ring slot ``lens % S``. RoPE of q
    and k and the K/V write are one fused kernel
    (``ops.rope_cache_write``; its plain version is ``apply_rope`` twice
    and ``kv_cache_write``)."""
    B = x.shape[0]
    qkv = layers.linear(p["wqkv"], x).reshape(B, -1)
    check_cache_format(cfg, cache)
    q = ops.rope_cache_write(qkv, cache, lens, advance, cfg.rope_theta,
                             cfg.kv_quant)
    if cfg.kv_quant in FLOAT_FORMATS:
        out = ops.decode_attention(q, cache["k"], cache["v"], kv_len)
    else:
        out = ops.decode_attention_quant(
            q, cache["k"], cache["k_scale"], cache["v"], cache["v_scale"],
            kv_len, fmt=cfg.kv_quant)
    return layers.linear(p["wo"], out.reshape(B, 1, cfg.q_dim))


def kv_cache_read(cache: Dict, *, kv_quant: str = "bf16",
                  dtype: torch.dtype = torch.bfloat16
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The attention-visible (B, Hkv, S, hd) K/V view of one layer's
    cache (dequantized for q8_0/q4_0 caches)."""
    if kv_quant in FLOAT_FORMATS:
        return cache["k"], cache["v"]
    return (dequantize_rows(cache["k"], cache["k_scale"], kv_quant, dtype),
            dequantize_rows(cache["v"], cache["v_scale"], kv_quant, dtype))


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                  kv_quant: str = "bf16", device: torch.device,
                  dtype: torch.dtype = torch.bfloat16) -> Dict:
    """One layer's zeroed cache leaves: bf16 K/V (B, Hkv, S, hd), or an
    int8 payload (hd, or hd // 2 for q4_0) plus bf16 scales
    (B, Hkv, S, hd // g)."""
    Hkv, hd = cfg.num_kv_heads, cfg.head_dim
    shape = (batch, Hkv, max_len)
    if kv_quant in FLOAT_FORMATS:
        return {"k": torch.zeros(shape + (hd,), dtype=dtype, device=device),
                "v": torch.zeros(shape + (hd,), dtype=dtype, device=device)}
    g = kv_group_size(hd, cfg.quant_group, kv_quant)
    pd = hd // 2 if kv_quant == "q4_0" else hd
    return {
        "k": torch.zeros(shape + (pd,), dtype=torch.int8, device=device),
        "v": torch.zeros(shape + (pd,), dtype=torch.int8, device=device),
        "k_scale": torch.zeros(shape + (hd // g,), dtype=dtype,
                               device=device),
        "v_scale": torch.zeros(shape + (hd // g,), dtype=dtype,
                               device=device),
    }
