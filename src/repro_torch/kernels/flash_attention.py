"""Tiled GQA prefill attention (flash attention): causal, sliding window,
``q_offset``, block skip.

Replaces the JAX package's Pallas kernel ``flash_attention``
(``src/repro/kernels/flash_attention.py``, ``_flash_kernel``) with the
CUDA kernel in ``csrc/flash_attention.cu``, designed for Hopper: work
items of ``BLOCK_Q`` = 128 queries of one query head each walk their
visible KV tiles of ``block_k`` keys. A producer thread feeds Q and a ring of K/V tiles
by TMA; two consumer warpgroups run both products on the tensor cores
with ``wgmma`` (Q K^T with Q in registers, or at head dim 256 in shared
memory, P V with P taken straight from the score accumulators), software pipelined and taking turns, with
the online softmax in registers. A persistent grid of at most one CTA
per SM takes the items heaviest first, in the order ``tile_order``
gives. The tile sizes, that order and the grid are set here and passed
to the kernel, so the CPU model of the schedule in the tests uses the
very same ones. Its bound and design are described in the source.

``flash_attention_plain`` is the plain PyTorch version: the port of the
JAX package's ``chunked_attention`` (``models/attention.py``), which is
what the JAX model path runs, with its Q/KV block loop (``bq = bk =
512``, halved until they divide), its static block skip and its
rounding points: ``q * scale`` computed in f32 and rounded to the input
dtype; scores as f32 sums of products of input-dtype operands; masked
scores -1e30 and masked ``p`` 0; ``p`` rounded to the input dtype for
the PV product while ``l`` sums the unrounded f32 ``p``; ``l == 0`` read
as 1; one cast to the input dtype at the end. The kernel rounds at the
same points (it takes ``exp`` as ``exp2`` with log2(e) folded into the
f32 score scale). The wrapper runs the plain version for CPU tensors
only; a CUDA tensor always goes through the kernel, or the wrapper
raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import (NEG_INF, _require,
                                                  softmax_scale)

NOT_INSTANTIATED = -1          # C result: no kernel for this (D, G, tiles)
BLOCK = 512                    # chunked_attention's default bq = bk
# The kernel's tiles: a work item holds BLOCK_Q queries of one query head
# (two m64 warpgroups); KV tiles hold block_k(D) keys, anchored at key
# position 0. The kernel instantiates these sizes and takes them as
# arguments: this is the one place they are set.
BLOCK_Q = 128
MAX_TILES = 1024               # query tiles one launch can order

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
             ctypes.c_float, _I, _I, _P, _I, _I, _P)


def _block(size: int, pref: int = BLOCK) -> int:
    b = min(pref, size)
    while size % b:
        b //= 2
    return b


STAGES = 3                     # the kernel's K/V ring
SMEM_PER_BLOCK = 232448        # the H100's shared memory a CTA may use


def block_k(D: int) -> int:
    """Keys per KV tile at head dim D: 128, or 64 at D 128 (the score
    and output accumulators of a warpgroup then fit its registers), or 32
    at D 256 (three stages of K/V tiles and the Q tile then fit a CTA's
    shared memory)."""
    return 128 if D <= 64 else 64 if D <= 128 else 32


def q_in_smem(D: int) -> bool:
    """Whether the kernel keeps Q in shared memory (one buffer, the
    output staged in it) rather than in registers: at D 256."""
    return D > 128


def smem_bytes(D: int) -> int:
    """A CTA's shared memory at head dim D, as the kernel's ``Geo``
    carves it: the K/V ring, the Q tiles (two, or one in shared memory),
    the output staging (none when staged in Q), the mbarriers and 1024
    bytes of alignment."""
    cols = min(D, 64)
    stage = 2 * (D // cols) * block_k(D) * cols * 2
    q_bufs = 1 if q_in_smem(D) else 2
    out = 0 if q_in_smem(D) else BLOCK_Q * (2 * D + 16)
    return (STAGES * stage + q_bufs * BLOCK_Q * D * 2 + out
            + (2 * STAGES + 2 * q_bufs) * 8 + 1024)


def kv_tiles(q0: int, bq: int, Sq: int, Skv: int, bk: int, causal: bool,
             window: int, q_offset: int) -> Tuple[int, int]:
    """(first, count) of the KV tiles that the work item of queries [q0,
    q0 + bq) walks: from the window's first visible key to the causal
    last one (the kernel computes the same from its arguments)."""
    lo = q0 + q_offset
    hi = min(q0 + bq, Sq) - 1 + q_offset
    k_end = max(0, min(Skv, hi + 1)) if causal else Skv
    k_lo = max(0, lo - window + 1) if window > 0 else 0
    first = k_lo // bk
    return first, max(0, -(-k_end // bk) - first)


@functools.lru_cache(maxsize=256)
def tile_order(Sq: int, Skv: int, bq: int, bk: int, causal: bool,
               window: int, q_offset: int) -> Tuple[int, ...]:
    """The query tiles in launch order: most KV tiles first, then the
    later tile first (window 0: the tiles in reverse)."""
    n = -(-Sq // bq)
    work = [kv_tiles(t * bq, bq, Sq, Skv, bk, causal, window, q_offset)[1]
            for t in range(n)]
    return tuple(sorted(range(n), key=lambda t: (-work[t], -t)))


@dataclasses.dataclass(frozen=True)
class Plan:
    block_q: int
    block_k: int
    order: Tuple[int, ...]     # query tiles, heaviest first
    items: int                 # len(order) x batch rows x query heads
    ctas: int                  # persistent CTAs: min(items, SMs)


def plan(B: int, Hq: int, Hkv: int, Sq: int, Skv: int, D: int, *,
         causal: bool = True, window: int = 0, q_offset: int = 0,
         sms: int = 132) -> Plan:
    """The kernel's tiles, tile order and grid for this call on a card
    of ``sms`` SMs. Work item w is query tile ``order[w // (B * Hq)]`` of
    (batch row, query head) ``w % (B * Hq)``; CTA c takes items c, c +
    ctas, c + 2 ctas, ..."""
    bk = block_k(D)
    order = tile_order(Sq, Skv, BLOCK_Q, bk, bool(causal), int(window),
                       int(q_offset))
    items = len(order) * B * Hq
    return Plan(BLOCK_Q, bk, order, items, min(items, sms))


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=256)
def _order_array(order: Tuple[int, ...]):
    return (ctypes.c_uint16 * len(order))(*order)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          q_offset: int = 0) -> torch.Tensor:
    """q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D) → (B, Hq, Sq, D)."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    G = Hq // Hkv
    bq, bk = _block(Sq), _block(Skv)
    dev = q.device
    qg = (q.float() * softmax_scale(D)).to(q.dtype).reshape(B, Hkv, G, Sq, D)
    outs = []
    for i in range(Sq // bq):
        q_i = qg[:, :, :, i * bq:(i + 1) * bq].float()
        q_lo = i * bq + q_offset
        hi = min(Skv, q_lo + bq) if causal else Skv
        lo = max(0, q_lo - window + 1) if window else 0
        lo_b = (lo // bk) * bk
        hi_b = min(Skv, ((hi + bk - 1) // bk) * bk)
        qpos = q_lo + torch.arange(bq, device=dev)
        m = torch.full((B, Hkv, G, bq), NEG_INF, device=dev)
        l = torch.zeros((B, Hkv, G, bq), device=dev)
        acc = torch.zeros((B, Hkv, G, bq, D), device=dev)
        for k0 in range(lo_b, hi_b, bk):
            k_c = k[:, :, None, k0:k0 + bk].float()      # (B,Hkv,1,bk,D)
            v_c = v[:, :, None, k0:k0 + bk]
            s = torch.matmul(q_i, k_c.transpose(-1, -2))   # (B,Hkv,G,bq,bk)
            kpos = k0 + torch.arange(bk, device=dev)
            mask = torch.ones((bq, bk), dtype=torch.bool, device=dev)
            if causal:
                mask &= kpos[None, :] <= qpos[:, None]
            if window:
                mask &= kpos[None, :] > qpos[:, None] - window
            s = torch.where(mask, s, torch.full((), NEG_INF, device=dev))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.where(mask, torch.exp(s - m_new[..., None]),
                            torch.zeros((), device=dev))
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.matmul(
                p.to(v.dtype).float(), v_c.float())
            m = m_new
        l = torch.where(l == 0.0, torch.ones((), device=dev), l)
        outs.append(acc / l[..., None])
    out = torch.cat(outs, dim=3) if len(outs) > 1 else outs[0]
    return out.reshape(B, Hq, Sq, D).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    _require(q.ndim == 4 and k.ndim == 4 and v.shape == k.shape,
             f"q {tuple(q.shape)} must be (B, Hq, Sq, D) and k "
             f"{tuple(k.shape)}, v {tuple(v.shape)} (B, Hkv, Skv, D) alike")
    B, Hq, Sq, D = q.shape
    _require(k.shape[0] == B and k.shape[3] == D and k.shape[1] > 0
             and Hq % k.shape[1] == 0,
             f"q {tuple(q.shape)} does not match k {tuple(k.shape)}: "
             "batch and head dim must agree and Hkv divide Hq")
    _require(Sq >= 1 and k.shape[2] >= 1, "Sq and Skv must be >= 1")
    _require(q.dtype == k.dtype == v.dtype,
             f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D) → (B, Hq, Sq, D). Query
    i sits at absolute position ``i + q_offset``. CPU tensors take the
    plain version; CUDA tensors must be bf16 and contiguous."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    _require(q.dtype == torch.bfloat16,
             f"the flash_attention kernel takes bf16, got {q.dtype}")
    for t in (q, k, v):
        _require(t.is_cuda and t.device == q.device,
                 "q, k, v must be on one CUDA device")
        _require(t.is_contiguous() and t.data_ptr() % 16 == 0,
                 "q, k, v must be contiguous and 16-byte aligned")
    out = torch.empty_like(q)
    if B == 0:
        return out
    pl = plan(B, Hq, Hkv, Sq, Skv, D, causal=causal, window=window,
              q_offset=q_offset, sms=_sms(q.device))
    _require(len(pl.order) <= MAX_TILES,
             f"Sq {Sq} needs {len(pl.order)} query tiles of {pl.block_q}; "
             f"the kernel orders at most {MAX_TILES}")
    fn = build.function("flash_attention", "flash_attention", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hkv,
             Hq // Hkv, Sq, Skv, D, int(causal), int(window), int(q_offset),
             softmax_scale(D), pl.block_q, pl.block_k,
             ctypes.addressof(_order_array(pl.order)), len(pl.order),
             pl.ctas, torch.cuda.current_stream(q.device).cuda_stream)
    _require(err != NOT_INSTANTIATED,
             f"flash_attention.cu has no kernel for head_dim {D} with "
             f"{Hq // Hkv} query heads per kv head and tiles of "
             f"{pl.block_q} queries, {pl.block_k} keys")
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
