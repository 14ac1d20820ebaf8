"""Single-token GQA decode attention over a bf16 KV cache.

Replaces the JAX package's Pallas kernel ``decode_attention``
(``src/repro/kernels/decode_attention.py``, ``_decode_kernel``) with the
CUDA kernel in ``csrc/decode_attention.cu`` (bf16 loader); the same
kernel, templated on a quantized loader, serves
``decode_attention_quant``. The kernel is bound by the cache bytes it
reads. Its design (flash decoding: a grid of (batch x kv head, split)
CTAs, each split a fixed run of ``SPLIT`` absolute cache positions
holding the G grouped queries of one kv head, K/V tiles of 64 positions
double-buffered by cp.async, f32 partial (m, l, acc) per split merged in
split order by the last CTA of each (batch, kv head) to finish, found by
an atomic ticket) is described in the source. Because the
split boundaries depend on cache positions alone, a slot's output does
not depend on the batch, the cache length or other slots' lengths.

A paged cache (the serving engine's block pool) is read through its
block table by the kernel itself: ``block_table`` (B, max_pages) int32
names the pool block of each page of P positions, and the cache leaves
are pools (n_blocks, Hkv, P, ·). Splits and tiles are the dense
kernel's over S = max_pages × P, so a paged slot has the bits of the
dense kernel over ``paged_gather``'s view.

``decode_attention_plain`` is the plain PyTorch version: the JAX
package's ``ops._decode_attention_jnp`` with the same rounding points
(q*scale → input dtype, p → input dtype, f32 accumulation, the -1e30
mask, l clamped to 1e-20), over ``paged_gather``'s dense view for a
paged cache (the JAX package's ``models/attention.py`` gathers before
its kernels). The wrapper runs it for CPU tensors only; a CUDA tensor
always goes through the kernel, or the wrapper raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.tickets import tickets

NEG_INF = -1e30
LOADERS = {"bf16": 0, "q8_0": 1, "q4_0": 2}
NOT_INSTANTIATED = -1          # C result: no kernel for this (D, G)
# Cache positions per split: split s covers [s * SPLIT, (s + 1) * SPLIT).
# The kernel takes it as an argument (a multiple of its 64-position tile)
# and sizes nothing by itself, so this is the one place it is set.
SPLIT = 128

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_I, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _P, _I,
             _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P)


def num_splits(S: int) -> int:
    """Splits of a cache of S positions: ceil(S / SPLIT)."""
    return -(-S // SPLIT)


def split_scratch_elems(B: int, Hkv: int, G: int, S: int, D: int) -> int:
    """f32 elements of the kernel's scratch: per (batch, kv head, split)
    the unnormalized acc (G x D), then m (G) and l (G)."""
    return B * Hkv * num_splits(S) * G * (D + 2)


def as_lens(kv_len, batch: int, device) -> torch.Tensor:
    """kv_len as an int32 (batch,) tensor on ``device``."""
    lens = torch.as_tensor(kv_len, dtype=torch.int32, device=device)
    return lens.expand(batch) if lens.ndim == 0 else lens


def softmax_scale(head_dim: int) -> float:
    """The score scale both versions apply to q: head_dim ** -0.5."""
    return head_dim ** -0.5


def paged_gather(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """A block pool's dense per-slot view: pool (n_blocks, Hkv, P, d),
    table (B, max_pages) int32 → (B, Hkv, max_pages × P, d). Unmapped
    entries name the garbage block 0; their positions lie past every
    slot's ``kv_len``. The plain versions' half of paged attention (the
    JAX package's ``models/attention.py::paged_gather``): the kernels
    read through the table and never call it, and ``paged_gather.calls``
    counts its calls so that a run can show it."""
    paged_gather.calls += 1
    B, n_pages = table.shape
    _, Hkv, P, d = pool.shape
    g = pool[table.long()]                      # (B, n_pages, Hkv, P, d)
    return g.transpose(1, 2).reshape(B, Hkv, n_pages * P, d)


paged_gather.calls = 0


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_len, *, window: int = 0,
                           block_table: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """q (B, Hq, D); k, v (B, Hkv, S, D), or pools (n_blocks, Hkv, P, D)
    read through ``block_table`` (B, max_pages); kv_len (B,) →
    (B, Hq, D)."""
    if block_table is not None:
        k, v = paged_gather(k, block_table), paged_gather(v, block_table)
    B, Hq, D = q.shape
    _, Hkv, S, _ = k.shape
    G = Hq // Hkv
    scale = softmax_scale(D)
    lens = as_lens(kv_len, B, q.device)
    qg = (q.float() * scale).to(q.dtype).reshape(B, Hkv, G, D)
    s = torch.matmul(qg.float(), k.float().transpose(-1, -2))  # (B,Hkv,G,S)
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = kpos < lens[:, None]
    if window:
        mask &= kpos >= lens[:, None] - window
    mask = mask[:, None, None, :]
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros((), device=q.device))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(q.dtype).float(), v.float())
    out = out / torch.clamp(l, min=1e-20)
    return out.reshape(B, Hq, D).to(q.dtype)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def paged_scales_aligned(P: int, ng: int) -> bool:
    """Whether the quantized loaders can copy a paged cache's scales by
    page run: every run of a 64-position tile must start on a 16-byte
    boundary, so gcd(64, P) × 2 × ng must be a multiple of 16."""
    return math.gcd(64, P) * 2 * ng % 16 == 0


def launch_decode_kernel(loader: str, q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, k_scale: Optional[torch.Tensor],
                         v_scale: Optional[torch.Tensor], kv_len, *,
                         window: int,
                         block_table: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Check the inputs and launch ``csrc/decode_attention.cu`` on the
    current stream. Raises on anything the kernel does not take. With
    ``block_table`` the cache leaves are pools (n_blocks, Hkv, P, ·)."""
    B, Hq, D = q.shape
    _require(k.ndim == 4 and v.shape == k.shape,
             f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
             "(B, Hkv, S, D') and alike")
    _, Hkv, S, Dp = k.shape
    P = max_pages = 0
    if block_table is None:
        _require(k.shape[0] == B,
                 f"q {tuple(q.shape)} does not match cache {tuple(k.shape)}")
    else:
        _require(block_table.dtype == torch.int32 and block_table.ndim == 2
                 and block_table.shape[0] == B,
                 f"block_table must be int32 (B={B}, max_pages), got "
                 f"{block_table.dtype} {tuple(block_table.shape)}")
        _require(window == 0, "a paged cache takes no window")
        P, max_pages = S, block_table.shape[1]
        S = P * max_pages
    _require(Hq % Hkv == 0,
             f"q {tuple(q.shape)} does not match cache {tuple(k.shape)}")
    G = Hq // Hkv
    _require(q.dtype == torch.bfloat16, f"q must be bf16, got {q.dtype}")
    want_dp = D // 2 if loader == "q4_0" else D
    _require(Dp == want_dp, f"payload dim {Dp} inconsistent with head dim "
             f"{D} under {loader}")
    cache_dtype = torch.bfloat16 if loader == "bf16" else torch.int8
    tensors = [q, k, v]
    ng = 0
    if loader != "bf16":
        _require(k_scale is not None and v_scale is not None
                 and k_scale.shape == v_scale.shape
                 and k_scale.shape[:3] == k.shape[:3],
                 "scales must be (B, Hkv, S, D // g) for both K and V")
        ng = k_scale.shape[3]
        _require(D % ng == 0 and k_scale.dtype == torch.bfloat16
                 and v_scale.dtype == torch.bfloat16,
                 f"scales must be bf16 with a dim dividing {D}")
        _require(block_table is None or paged_scales_aligned(P, ng),
                 f"page size {P} with {ng} scales a row: gcd(64, P) * 2 * "
                 "ng must be a multiple of 16 for the paged scale copy")
        tensors += [k_scale, v_scale]
    _require(k.dtype == cache_dtype and v.dtype == cache_dtype,
             f"{loader} cache must be {cache_dtype}, got {k.dtype}")
    lens = as_lens(kv_len, B, q.device).contiguous()
    _require(lens.shape == (B,), f"kv_len must be (B,), got {tuple(lens.shape)}")
    if block_table is not None:
        tensors.append(block_table)
    for t in tensors + [lens]:
        _require(t.is_cuda and t.device == q.device,
                 "all inputs must be on q's CUDA device")
        _require(t.is_contiguous() and t.data_ptr() % 16 == 0,
                 "inputs must be contiguous and 16-byte aligned")
    out = torch.empty_like(q)
    if B == 0:
        return out
    if S == 0:                     # no cache position: l == 0, output 0
        return out.zero_()
    n_part = split_scratch_elems(B, Hkv, G, S, D)
    part = torch.empty((n_part,), dtype=torch.float32, device=q.device)
    counts = tickets(B * Hkv, q.device)
    fn = build.function("decode_attention", "decode_attention", _ARGTYPES)
    err = fn(LOADERS[loader], q.data_ptr(), k.data_ptr(), v.data_ptr(),
             k_scale.data_ptr() if ng else None,
             v_scale.data_ptr() if ng else None, lens.data_ptr(),
             out.data_ptr(), part.data_ptr(), n_part, counts.data_ptr(),
             counts.numel(),
             block_table.data_ptr() if block_table is not None else None,
             max_pages, P, B, Hkv, G, S, D, ng, int(window), SPLIT,
             softmax_scale(D),
             torch.cuda.current_stream(q.device).cuda_stream)
    _require(err != NOT_INSTANTIATED,
             f"decode_attention.cu has no kernel for head_dim {D} with "
             f"{G} query heads per kv head")
    build.check(err, f"decode_attention[{loader}]")
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len, *, window: int = 0,
                     block_table: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """q (B, Hq, D) bf16; k, v (B, Hkv, S, D) bf16, or pools
    (n_blocks, Hkv, P, D) read through ``block_table`` (B, max_pages)
    int32; kv_len (B,) int32 → (B, Hq, D). Keys at positions >= kv_len
    (or < kv_len - window when ``window`` > 0) are masked."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, kv_len, window=window,
                                      block_table=block_table)
    out = launch_decode_kernel("bf16", q, k, v, None, None, kv_len,
                               window=window, block_table=block_table)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
