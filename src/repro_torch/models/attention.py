"""GQA attention: the full-sequence prefill forward and one decode token
over a dense KV cache.

Counterpart of the JAX package's ``models/attention.py``:
``attention_forward`` (the self-attention branch, with ``return_kv``),
``attention_decode``, ``kv_cache_read`` and ``init_kv_cache``.
``kv_cache_write`` lives in ``kernels/fused_ops.py``, beside the fused
decode RoPE + cache write kernel whose plain version it is part of, and
``chunked_attention`` in ``repro_torch.kernels.flash_attention``: it is
the plain version of the prefill attention kernel there, and
``attention_forward`` reaches it through ``ops.attention``. Paging,
cross-attention and ``kv_override`` are not ported yet.

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
                                        kv_group_size, quantize_rows)


def attention_specs(cfg: ModelConfig) -> Dict:
    return {"wqkv": layers.linear_spec(cfg.d_model,
                                       cfg.q_dim + 2 * cfg.kv_dim),
            "wo": layers.linear_spec(cfg.q_dim, cfg.d_model)}


def attention_forward(p, cfg: ModelConfig, x: torch.Tensor, *,
                      positions: torch.Tensor, return_kv: bool = False):
    """Full-sequence causal self-attention (prefill). x (B, S, D_model),
    positions (B, S) absolute. With ``return_kv`` also returns the roped
    K and the V, (B, Hkv, S, hd) each, for the cache fill."""
    B, S, _ = x.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    qkv = layers.linear(p["wqkv"], x)
    q = qkv[..., :cfg.q_dim].reshape(B, S, H, hd)
    k = qkv[..., cfg.q_dim:cfg.q_dim + cfg.kv_dim].reshape(B, S, Hkv, hd)
    v = qkv[..., cfg.q_dim + cfg.kv_dim:].reshape(B, S, Hkv, hd)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    out = ops.attention(q, k, v, causal=True, window=0)
    out = out.transpose(1, 2).reshape(B, S, H * hd)
    out = layers.linear(p["wo"], out)
    if return_kv:
        return out, k, v
    return out


def check_cache_format(cfg: ModelConfig, cache: Dict) -> None:
    """Raise when a layer's cache leaves are not ``cfg.kv_quant``'s."""
    if ("k_scale" in cache) == (cfg.kv_quant in FLOAT_FORMATS):
        raise ValueError(f"cache leaves {sorted(cache)} are not a "
                         f"{cfg.kv_quant} cache")


def attention_decode(p, cfg: ModelConfig, x: torch.Tensor, cache: Dict,
                     lens: torch.Tensor,
                     advance: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, 1, D); cache one layer's leaves (B, Hkv, S, ·); lens (B,)
    tokens already cached per row. The new token's K/V go to ring slot
    ``lens % S`` and attention reads ``min(lens + 1, S)`` positions. RoPE
    of q and k and the K/V write are one fused kernel
    (``ops.rope_cache_write``; its plain version is ``apply_rope`` twice
    and ``kv_cache_write``)."""
    B = x.shape[0]
    H, hd = cfg.num_heads, cfg.head_dim
    qkv = layers.linear(p["wqkv"], x).reshape(B, -1)
    check_cache_format(cfg, cache)
    q = ops.rope_cache_write(qkv, cache, lens, advance, cfg.rope_theta,
                             cfg.kv_quant)
    S = cache["k"].shape[2]
    kv_len = torch.clamp(lens + 1, max=S)
    if cfg.kv_quant in FLOAT_FORMATS:
        out = ops.decode_attention(q, cache["k"], cache["v"], kv_len)
    else:
        out = ops.decode_attention_quant(
            q, cache["k"], cache["k_scale"], cache["v"], cache["v_scale"],
            kv_len, fmt=cfg.kv_quant)
    return layers.linear(p["wo"], out.reshape(B, 1, H * hd))


def kv_cache_write_prefill(cache: Dict, k: torch.Tensor, v: torch.Tensor,
                           *, kv_quant: str = "bf16",
                           group: int = 32) -> None:
    """Write prefill K/V (B, Hkv, S, hd) into positions [0, S) of every
    row of one layer's cache, in place (the ``S <= S_cache`` branch of
    the JAX package's ``_write_prefill_kv``). Quantized caches quantize
    the rows at the write point, per position, so they equal what the
    stepwise decode path writes one at a time. Rows past a prompt's true
    length are the padding's junk, as in the JAX package: decode reads
    only ``lens + 1`` rows and overwrites the junk in order before it is
    ever visible. A prompt longer than the cache (the ring branch) is
    for the windowed family, which the port does not carry yet."""
    S, S_cache = k.shape[2], cache["k"].shape[2]
    if S > S_cache:
        raise ValueError(f"prefill of {S} positions into a {S_cache}-row "
                         "cache needs the ring write of the windowed "
                         "family, which the port does not carry yet")
    if kv_quant in FLOAT_FORMATS:
        rows = {"k": k, "v": v}
    else:
        kq, ks = quantize_rows(k, kv_quant, group)
        vq, vs = quantize_rows(v, kv_quant, group)
        rows = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    for name, new in rows.items():
        cache[name][:, :, :S] = new.to(cache[name].dtype)


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
