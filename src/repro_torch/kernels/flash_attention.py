"""Tiled GQA prefill attention (flash attention): causal, sliding window,
``q_offset``, block skip.

Replaces the JAX package's Pallas kernel ``flash_attention``
(``src/repro/kernels/flash_attention.py``, ``_flash_kernel``) with the
CUDA kernel in ``csrc/flash_attention.cu``: one CTA per (64-query tile,
batch row, kv head) walks the visible 64-key tiles in a loop of its own,
holds all G query heads of the kv head, and runs both products on the
tensor cores (``mma.sync`` m16n8k16, bf16 in, f32 accumulate). Its bound
and design are described in the source.

``flash_attention_plain`` is the plain PyTorch version: the port of the
JAX package's ``chunked_attention`` (``models/attention.py``), which is
what the JAX model path runs, with its Q/KV block loop (``bq = bk =
512``, halved until they divide), its static block skip and its
rounding points: ``q * scale`` computed in f32 and rounded to the input
dtype; scores as f32 sums of products of input-dtype operands; masked
scores -1e30 and masked ``p`` 0; ``p`` rounded to the input dtype for
the PV product while ``l`` sums the unrounded f32 ``p``; ``l == 0`` read
as 1; one cast to the input dtype at the end. The kernel rounds at the
same points. The wrapper runs the plain version for CPU tensors only; a
CUDA tensor always goes through the kernel, or the wrapper raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import (NEG_INF, _require,
                                                  softmax_scale)

NOT_INSTANTIATED = -1          # C result: no kernel for this (D, G)
BLOCK = 512                    # chunked_attention's default bq = bk

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
             ctypes.c_float, _P)


def _block(size: int, pref: int = BLOCK) -> int:
    b = min(pref, size)
    while size % b:
        b //= 2
    return b


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
    fn = build.function("flash_attention", "flash_attention", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hkv,
             Hq // Hkv, Sq, Skv, D, int(causal), int(window), int(q_offset),
             softmax_scale(D), torch.cuda.current_stream(q.device).cuda_stream)
    _require(err != NOT_INSTANTIATED,
             f"flash_attention.cu has no kernel for head_dim {D} with "
             f"{Hq // Hkv} query heads per kv head")
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
