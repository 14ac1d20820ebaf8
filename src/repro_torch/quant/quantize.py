"""Groupwise weight and KV-cache quantization (llama.cpp k-quant
analogues), the same formats and layouts as the JAX package's
``repro.quant.quantize``:

- ``q8_0``: groups of 32 along the reduction dim; int8 payload + one
  bf16 scale per (group, column) → 8.5 bits/weight.
- ``q4_0``: groups of 32; symmetric int4 in [-8, 7], two nibbles packed
  per int8 byte along K (low nibble = even K index) → 4.5 bits/weight.

Weights quantize along K (axis -2, the matmul reduction dim); KV-cache
rows quantize along their last (feature) axis with a group size from
``kv_group_size``.

Rounding: ``torch.round`` rounds half to even like ``jnp.round``, but
the division ``w / scale`` may land one ulp apart from XLA's compiled
division, so on exact .5 ties a payload can differ from the JAX
package's by one quantization step. Compare payloads with that
allowance, or compare dequantized values.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

FLOAT_FORMATS = ("bf16", "f16", "f32")


@dataclasses.dataclass
class QuantizedTensor:
    """Groupwise-quantized (K, N) weight.

    data:   int8. q8_0 → (K, N); q4_0 → (K // 2, N), nibble-packed.
    scales: bf16 (K // group, N), one per (group, column).
    """
    data: torch.Tensor
    scales: torch.Tensor
    fmt: str            # "q8_0" | "q4_0"
    group: int = 32

    @property
    def logical_shape(self) -> Tuple[int, ...]:
        """Unquantized shape ``(..., K, N)``, derived from ``data``."""
        k2 = self.data.shape[-2]
        K = 2 * k2 if self.fmt == "q4_0" else k2
        return tuple(self.data.shape[:-2]) + (K, self.data.shape[-1])

    @property
    def quant_nbytes(self) -> int:
        return (self.data.numel() * self.data.element_size()
                + self.scales.numel() * self.scales.element_size())


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int4 values in [-8, 7] pairwise along axis -2 into int8:
    (2i, n) → low nibble of (i, n), (2i+1, n) → high nibble."""
    if q.shape[-2] % 2:
        raise ValueError(f"pack_int4 needs an even K, got {q.shape}")
    lo = q[..., 0::2, :].to(torch.int32) & 0x0F
    hi = q[..., 1::2, :].to(torch.int32) & 0x0F
    return _to_int8(lo | (hi << 4))


def _to_int8(u: torch.Tensor) -> torch.Tensor:
    """Reinterpret values in [0, 255] as two's-complement int8."""
    return torch.where(u > 127, u - 256, u).to(torch.int8)


def _sign_extend_nibbles(packed: torch.Tensor):
    u = packed.to(torch.int32) & 0xFF
    lo = u & 0x0F
    hi = (u >> 4) & 0x0F
    lo = torch.where(lo > 7, lo - 16, lo).to(torch.int8)
    hi = torch.where(hi > 7, hi - 16, hi).to(torch.int8)
    return lo, hi


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4` → int8 values in [-8, 7]."""
    lo, hi = _sign_extend_nibbles(packed)
    k2 = packed.shape[-2]
    out = torch.stack([lo, hi], dim=-2)        # (..., k2, 2, n)
    return out.reshape(packed.shape[:-2] + (2 * k2,) + packed.shape[-1:])


def _group_scales(w: torch.Tensor, group: int, qmax: float):
    *lead, K, N = w.shape
    if K % group:
        raise ValueError(f"K={K} is not a multiple of the group {group}")
    wg = w.reshape(*lead, K // group, group, N)
    scale = wg.abs().amax(dim=-2) / qmax           # (..., K//group, N)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    return wg, scale


def quantize_q8_0(w: torch.Tensor, group: int = 32) -> QuantizedTensor:
    wg, scale = _group_scales(w.float(), group, 127.0)
    q = torch.clamp(torch.round(wg / scale[..., None, :]), -127, 127)
    q = q.to(torch.int8).reshape(w.shape)
    return QuantizedTensor(q, scale.to(torch.bfloat16), "q8_0", group)


def quantize_q4_0(w: torch.Tensor, group: int = 32) -> QuantizedTensor:
    wg, scale = _group_scales(w.float(), group, 7.0)
    q = torch.clamp(torch.round(wg / scale[..., None, :]), -8, 7)
    q = q.to(torch.int8).reshape(w.shape)
    return QuantizedTensor(pack_int4(q), scale.to(torch.bfloat16),
                           "q4_0", group)


def quantize(w: torch.Tensor, fmt: str, group: int = 32):
    if fmt in FLOAT_FORMATS:
        return w
    if fmt == "q8_0":
        return quantize_q8_0(w, group)
    if fmt == "q4_0":
        return quantize_q4_0(w, group)
    raise ValueError(fmt)


def dequantize(qt: QuantizedTensor,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    if qt.fmt == "q8_0":
        q = qt.data
    elif qt.fmt == "q4_0":
        q = unpack_int4(qt.data)
    else:
        raise ValueError(qt.fmt)
    *lead, K, N = qt.logical_shape
    qg = q.reshape(*lead, K // qt.group, qt.group, N).float()
    w = qg * qt.scales[..., None, :].float()
    return w.reshape(*lead, K, N).to(dtype)


# ---------------------------------------------------------------------------
# Row-wise (last-axis) groupwise quantization — KV-cache leaves
# ---------------------------------------------------------------------------

def kv_group_size(dim: int, group: int, fmt: str) -> int:
    """Group size for quantizing a ``dim``-wide row: the largest divisor
    of ``dim`` that is <= ``group``. q4_0 also needs ``dim`` even."""
    if fmt == "q4_0" and dim % 2:
        raise ValueError(
            f"q4_0 KV rows need an even dim to pack nibbles (got {dim})")
    g = min(group, dim)
    while dim % g:
        g -= 1
    return g


def pack_int4_rows(q: torch.Tensor) -> torch.Tensor:
    """Pack int4 values in [-8, 7] pairwise along the LAST axis (low
    nibble = even feature index)."""
    if q.shape[-1] % 2:
        raise ValueError(f"pack_int4_rows needs an even dim, got {q.shape}")
    lo = q[..., 0::2].to(torch.int32) & 0x0F
    hi = q[..., 1::2].to(torch.int32) & 0x0F
    return _to_int8(lo | (hi << 4))


def unpack_int4_rows(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4_rows` → int8 values in [-8, 7]."""
    lo, hi = _sign_extend_nibbles(packed)
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(packed.shape[:-1] + (2 * packed.shape[-1],))


def quantize_rows(x: torch.Tensor, fmt: str, group: int = 32
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Groupwise-quantize along the last axis: x (..., d) → (payload
    int8 (..., d) [q8_0] or (..., d // 2) [q4_0], scales bf16
    (..., d // g)) with ``g = kv_group_size(d, group, fmt)``."""
    if fmt not in ("q8_0", "q4_0"):
        raise ValueError(fmt)
    d = x.shape[-1]
    g = kv_group_size(d, group, fmt)
    qmax = 127.0 if fmt == "q8_0" else 7.0
    xg = x.float().reshape(x.shape[:-1] + (d // g, g))
    scale = xg.abs().amax(dim=-1) / qmax
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(xg / scale[..., None]), -qmax, qmax)
    q = q.to(torch.int8).reshape(x.shape)
    if fmt == "q4_0":
        q = pack_int4_rows(q)
    return q, scale.to(torch.bfloat16)


def dequantize_rows(payload: torch.Tensor, scales: torch.Tensor, fmt: str,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_rows` (group size inferred from the
    scales' last dim)."""
    if fmt == "q4_0":
        q = unpack_int4_rows(payload)
    elif fmt == "q8_0":
        q = payload
    else:
        raise ValueError(fmt)
    d = q.shape[-1]
    g = d // scales.shape[-1]
    qg = q.reshape(q.shape[:-1] + (d // g, g)).float()
    x = qg * scales[..., None].float()
    return x.reshape(q.shape).to(dtype)


def quantize_tree(params, fmt: str, group: int = 32):
    """Quantize every matmul weight of a nested-dict param tree.

    Selected: tensors with ndim >= 2 whose K (axis -2) is divisible by
    ``group``, on a path that contains neither ``embed`` nor ``norm``
    (embedding tables are read by gather, and the tied unembedding
    shares the ``embedding`` leaf). Already-quantized leaves pass
    through. Lists (per-layer params) are walked element by element.
    """
    if fmt in FLOAT_FORMATS:
        return params

    def walk(node, path: str):
        if isinstance(node, QuantizedTensor):
            return node
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, f"{path}/{i}") for i, v in enumerate(node)]
        if (node.ndim >= 2 and node.shape[-2] % group == 0
                and "embed" not in path and "norm" not in path):
            return quantize(node, fmt, group)
        return node

    return walk(params, "")
