"""GQA attention: the prefill's causal (or windowed) self-attention and
one decode token over a dense, ring or paged KV cache.

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
through ``ops.attention``. Cross-attention and ``kv_override`` are not
ported yet.

The fused QKV projection may carry a bias (``cfg.qkv_bias``, the qwen2
models). It is not added after the product: the RoPE + cache-write
kernels add it as they read each qkv element (``bias=``), so a layer
launches no kernel more for it.

The unfused V0 (``cfg.fuse_qkv`` False, the paper's serial baseline)
keeps ``wq``, ``wk`` and ``wv`` apart, each with its own bias under
``qkv_bias`` (the JAX ``attention.py:43-58``). Its three GEMM launches
write q, k and v side by side into one (B·S, q_dim + 2·kv_dim) row
(``ops.matmul(out=)``), the fused product's layout, so the RoPE +
cache-write kernels run unchanged on it. ``Model.init`` keeps the three
biases as slices of one buffer a layer (``join_qkv_bias``), which reach
the kernels as one vector without a copy.

A windowed config (``cfg.sliding_window``, mistral-7b) keeps a ring of
``min(max_len, window)`` positions a slot: the prefill attends within
the window over all its positions and writes its last ring-length
positions into the ring; a decode step writes slot ``lens % S`` and
attends over the whole ring (``kv_len = min(lens + 1, S)``), as the JAX
``decode_step`` does: the ring's length is the window.

A paged cache (``init_kv_cache(page_size=)``) holds each layer's K/V
(and scales) as a pool of blocks of ``page_size`` positions; a block
table (slots, max_pages) names each slot's blocks. The decode step's
kernels read and write the pool through the table themselves;
``paged_gather`` (kept in ``kernels/decode_attention.py`` beside the
plain version that uses it) builds the dense view only for the plain
versions on the CPU and for ``kv_cache_read``.

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
from repro_torch.kernels.decode_attention import paged_gather
from repro_torch.models import layers
from repro_torch.quant.quantize import (FLOAT_FORMATS, dequantize_rows,
                                        kv_group_size)


QKV = ("wq", "wk", "wv")          # the unfused V0 projections, in order


def attention_specs(cfg: ModelConfig) -> Dict:
    D, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    if cfg.fuse_qkv:
        specs = {"wqkv": layers.linear_spec(D, qd + 2 * kvd,
                                            bias=cfg.qkv_bias)}
    else:
        specs = {n: layers.linear_spec(D, width, bias=cfg.qkv_bias)
                 for n, width in zip(QKV, (qd, kvd, kvd))}
    specs["wo"] = layers.linear_spec(qd, D)
    return specs


def join_qkv_bias(p) -> None:
    """Make an unfused layer's three biases slices of one buffer (in
    place; a no-op for the fused layout or without a bias), so that
    ``_qkv`` hands them to the kernels as one vector without a copy."""
    if "wq" not in p or "b" not in p["wq"]:
        return
    buf = torch.cat([p[n]["b"] for n in QKV])
    at = 0
    for n in QKV:
        width = p[n]["b"].numel()
        p[n]["b"] = buf[at:at + width]
        at += width


def _qkv_bias(p) -> Optional[torch.Tensor]:
    """The unfused layer's biases as one (q_dim + 2 kv_dim) vector: a view
    where they are consecutive slices of one buffer (``join_qkv_bias``),
    else their concatenation."""
    bs = [p[n].get("b") for n in QKV]
    if bs[0] is None:
        return None
    first, at, joined = bs[0], 0, True
    for b in bs:
        joined &= (b.is_contiguous() and b.dtype == first.dtype
                   and b.untyped_storage().data_ptr()
                   == first.untyped_storage().data_ptr()
                   and b.storage_offset() == first.storage_offset() + at)
        at += b.numel()
    return first.as_strided((at,), (1,)) if joined else torch.cat(bs)


def _qkv(p, x: torch.Tensor):
    """The QKV product (..., q_dim + 2 kv_dim) of x and its bias (None
    without one), which the RoPE + cache-write kernels add: x @ wqkv, or
    under V0 x @ wq, x @ wk and x @ wv written side by side into one
    row."""
    if "wqkv" in p:
        return ops.matmul(x, p["wqkv"]["w"]), p["wqkv"].get("b")
    x2 = x.reshape(-1, x.shape[-1])
    ws = [p[n]["w"] for n in QKV]
    widths = [ops.out_width(w) for w in ws]
    qkv = torch.empty((x2.shape[0], sum(widths)), dtype=x.dtype,
                      device=x.device)
    at = 0
    for w, width in zip(ws, widths):
        ops.matmul(x2, w, out=qkv[:, at:at + width])
        at += width
    return qkv.view(*x.shape[:-1], at), _qkv_bias(p)


def attention_forward(p, cfg: ModelConfig, x: torch.Tensor, cache: Dict,
                      window: int = 0) -> torch.Tensor:
    """Causal self-attention of a prefill: x (B, S, D_model) at positions
    0..S-1 of every row, each query seeing its last ``window`` keys (0:
    all of them). The roped K and the V go into positions [0, S) of one
    layer's cache, in place, or into its ring when S is longer than the
    cache; RoPE of q and k and that write are one fused kernel
    (``ops.rope_cache_write_prefill``; its plain version is the bias add,
    ``apply_rope`` twice, the transposes and ``kv_cache_write_prefill``).
    The attention reads the kernel's q, k and v of all S positions, never
    the cache."""
    B, S, _ = x.shape
    check_cache_format(cfg, cache)
    qkv, bias = _qkv(p, x)
    q, k, v = ops.rope_cache_write_prefill(qkv, cache, cfg.rope_theta,
                                           cfg.kv_quant, bias=bias)
    out = ops.attention(q, k, v, causal=True, window=window)
    out = out.transpose(1, 2).reshape(B, S, cfg.q_dim)
    return layers.linear(p["wo"], out)


def check_cache_format(cfg: ModelConfig, cache: Dict) -> None:
    """Raise when a layer's cache leaves are not ``cfg.kv_quant``'s."""
    if ("k_scale" in cache) == (cfg.kv_quant in FLOAT_FORMATS):
        raise ValueError(f"cache leaves {sorted(cache)} are not a "
                         f"{cfg.kv_quant} cache")


def attention_decode(p, cfg: ModelConfig, x: torch.Tensor, cache: Dict,
                     lens: torch.Tensor, kv_len: torch.Tensor,
                     advance: Optional[torch.Tensor] = None,
                     block_table: Optional[torch.Tensor] = None,
                     frozen_see_current: bool = False) -> torch.Tensor:
    """x (B, 1, D); cache one layer's leaves (B, Hkv, S, ·), or its pools
    (n_blocks, Hkv, P, ·) with the slots' ``block_table`` (B, max_pages)
    and S = max_pages × P; lens (B,) tokens already cached per row;
    kv_len (B,) = ``min(lens + 1, S)``, the positions attention reads
    (the caller computes it once for every layer). The new token's K/V
    go to ring slot ``lens % S``. The bias add, RoPE of q and k and the
    K/V write are one fused kernel (``ops.rope_cache_write``; its plain
    version is the add, ``apply_rope`` twice and ``kv_cache_write``);
    both kernels take the table.

    ``frozen_see_current`` (a dense cache with ``advance``): a frozen
    row's attention reads its own current token's K/V at ring slot
    ``lens % S``, and its cache is left as it was, as the JAX package's
    dense decode writes every row, attends, then selects the frozen rows'
    old cache. Without it a frozen row reads the slot's old contents;
    either way its output is junk nobody emits, unless it reaches other
    rows, as it does through an MoE layer whose capacity can drop pairs."""
    B = x.shape[0]
    qkv, bias = _qkv(p, x)
    qkv = qkv.reshape(B, -1)
    check_cache_format(cfg, cache)
    restore = frozen_see_current and advance is not None
    if restore:
        if block_table is not None:
            raise ValueError("frozen_see_current takes a dense cache")
        rows = torch.arange(B, device=x.device)
        pos = (lens % cache["k"].shape[2]).long()
        saved = {n: t[rows, :, pos] for n, t in cache.items()}
    q = ops.rope_cache_write(qkv, cache, lens, None if restore else advance,
                             cfg.rope_theta, cfg.kv_quant, block_table,
                             bias=bias)
    if cfg.kv_quant in FLOAT_FORMATS:
        out = ops.decode_attention(q, cache["k"], cache["v"], kv_len,
                                   block_table=block_table)
    else:
        out = ops.decode_attention_quant(
            q, cache["k"], cache["k_scale"], cache["v"], cache["v_scale"],
            kv_len, fmt=cfg.kv_quant, block_table=block_table)
    if restore:
        frozen = ~advance[:, None, None]
        for n, t in cache.items():
            t[rows, :, pos] = torch.where(frozen, saved[n], t[rows, :, pos])
    return layers.linear(p["wo"], out.reshape(B, 1, cfg.q_dim))


def kv_cache_read(cache: Dict, *, kv_quant: str = "bf16",
                  dtype: torch.dtype = torch.bfloat16,
                  block_table: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The attention-visible (B, Hkv, S, hd) K/V view of one layer's
    cache (dequantized for q8_0/q4_0 caches); a paged cache's pools are
    gathered through ``block_table`` first."""
    if block_table is not None:
        cache = {n: paged_gather(t, block_table) for n, t in cache.items()}
    if kv_quant in FLOAT_FORMATS:
        return cache["k"], cache["v"]
    return (dequantize_rows(cache["k"], cache["k_scale"], kv_quant, dtype),
            dequantize_rows(cache["v"], cache["v_scale"], kv_quant, dtype))


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  window: int = 0, *, kv_quant: str = "bf16",
                  device: torch.device, dtype: torch.dtype = torch.bfloat16,
                  page_size: int = 0, num_blocks: int = 0) -> Dict:
    """One layer's zeroed cache leaves: bf16 K/V (B, Hkv, S, hd), or an
    int8 payload (hd, or hd // 2 for q4_0) plus bf16 scales
    (B, Hkv, S, hd // g), with S = ``max_len``, or ``min(max_len,
    window)`` for a window > 0 (a ring).

    ``page_size`` P > 0 pages the cache: every leaf becomes a pool
    (n_blocks, Hkv, P, ·) with no batch axis, ``num_blocks`` defaulting
    to ``batch × max_len / P + 1`` (one block a page a slot, plus block
    0, the garbage block that unmapped table entries name). P must divide
    ``max_len``. The block table is the model cache's (``Model.init_cache``),
    not a layer's; a ring is never paged."""
    Hkv, hd = cfg.num_kv_heads, cfg.head_dim
    S = min(max_len, window) if window else max_len
    shape = (batch, Hkv, S)
    if page_size:
        if window:
            raise ValueError("a paged cache needs full attention (window "
                             f"0); got window {window}")
        if max_len % page_size:
            raise ValueError(f"page_size {page_size} must divide the cache "
                             f"length {max_len}")
        shape = (num_blocks or batch * (max_len // page_size) + 1, Hkv,
                 page_size)
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
