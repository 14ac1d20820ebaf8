"""Decode attention straight off a quantized (q8_0 / q4_0) KV cache.

Replaces the JAX package's Pallas kernel ``decode_attention_quant``
(``src/repro/kernels/decode_attention_quant.py``,
``_decode_quant_kernel`` / ``_dequant_rows``) with the kernel of
``csrc/decode_attention.cu`` instantiated with a quantized loader: the
int8 payload and bf16 scales are copied to shared memory as they are
(cp.async, split along the cache like the bf16 loader) and dequantized
there (``bf16(float(q) * scale)``, q4_0 nibbles sign-extended, low
nibble = even feature), so device reads stay at the quantized width,
the bytes that bound the kernel (8.5/16 or 4.5/16 of a bf16 cache, plus
scales).

``decode_attention_quant_plain`` is the plain PyTorch version, the JAX
package's XLA path: dequantize the rows to a bf16 view, then
``decode_attention_plain``.

Layouts: q8_0 payload (B, Hkv, S, D) int8; q4_0 (B, Hkv, S, D // 2);
scales (B, Hkv, S, D // g) bf16 with g = ``kv_group_size``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import (decode_attention_plain,
                                                  launch_decode_kernel)
from repro_torch.quant.quantize import dequantize_rows

FORMATS = ("q8_0", "q4_0")


def _check_fmt(fmt: str) -> None:
    if fmt not in FORMATS:
        raise ValueError(f"decode_attention_quant: fmt must be q8_0 or "
                         f"q4_0, got {fmt!r}")


def decode_attention_quant_plain(q, k_q, k_scale, v_q, v_scale, kv_len, *,
                                 fmt: str, window: int = 0):
    _check_fmt(fmt)
    k = dequantize_rows(k_q, k_scale, fmt)
    v = dequantize_rows(v_q, v_scale, fmt)
    return decode_attention_plain(q, k, v, kv_len, window=window)


def decode_attention_quant(q: torch.Tensor, k_q: torch.Tensor,
                           k_scale: torch.Tensor, v_q: torch.Tensor,
                           v_scale: torch.Tensor, kv_len, *, fmt: str,
                           window: int = 0) -> torch.Tensor:
    """q (B, Hq, D) bf16 → (B, Hq, D); see the module doc for the cache
    layouts. CPU tensors take the plain version."""
    _check_fmt(fmt)
    D = q.shape[-1]
    if k_q.shape[-1] != (D // 2 if fmt == "q4_0" else D):
        raise ValueError(f"payload dim {k_q.shape[-1]} inconsistent with "
                         f"head dim {D} under {fmt}")
    if q.device.type == "cpu":
        return decode_attention_quant_plain(
            q, k_q, k_scale, v_q, v_scale, kv_len, fmt=fmt, window=window)
    out = launch_decode_kernel(fmt, q, k_q, v_q, k_scale, v_scale, kv_len,
                               window=window)
    decode_attention_quant.launches += 1
    return out


decode_attention_quant.launches = 0
