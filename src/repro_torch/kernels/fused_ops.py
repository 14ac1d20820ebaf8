"""RMSNorm (alone, or with the residual add before it), SwiGLU, and RoPE
with the cache write (one decode token, or a whole prefill): the small
fused kernels of ``csrc/fused_ops.cu``.

No Pallas kernel of the JAX package stands behind them: inside the
jitted megastep and prefill XLA fuses ``layers.rmsnorm`` with the
residual adds, the SwiGLU of ``mlp_forward`` and ``apply_rope`` with
``attention.kv_cache_write`` / ``model._write_prefill_kv`` itself. Run
eagerly, each of these ops is a handful of PyTorch launches; on the card
each is one launch here. All of them are bound by the bytes they move;
the design (one pass, 16-byte loads, warp-shuffle reductions, nothing
intermediate in device memory) is described in the source.

- ``rmsnorm(x, w, eps)``: x (..., d) bf16 or f32, w (d,) → x's dtype;
  f32 math, one rounding (the JAX ``layers.rmsnorm``).
- ``add_rmsnorm(x, delta, w, eps)``: the residual add and the norm of
  its sum, → (h, out): h = x + delta rounded once to x's dtype, as
  PyTorch's add rounds it, and out = ``rmsnorm(h, w, eps)``.
- ``swiglu(gu)``: the fused gate-up output (..., 2 F) → (..., F),
  ``silu(g) * u`` in f32 with one rounding, read in place.
- ``rope_cache_write(qkv, cache, lens, advance, theta, fmt)``: one
  token's fused-QKV rows (B, q_dim + 2 kv_dim) bf16 → the roped q
  (B, Hq, D); the roped K and the V row go into ring slot ``lens % S``
  of one layer's cache (bf16, or q8_0 / q4_0 quantized at the write
  point) for the rows where ``advance`` is True.
- ``rope_cache_write_prefill(qkv, cache, theta, fmt)``: a prefill's
  fused-QKV rows (B, S, q_dim + 2 kv_dim) bf16 → q (B, Hq, S, D) and
  k, v (B, Hkv, S, D), roped at positions 0..S-1 of every row, in the
  layout the prefill attention takes; K and V go into cache positions
  [0, S) of every row in the cache's format.

Each ``*_plain`` function is the plain PyTorch version, with the same
rounding points. ``apply_rope``, ``kv_cache_write`` and
``kv_cache_write_prefill`` (the parts of the RoPE kernels' plain
versions) live here too. A wrapper runs the plain version for CPU
tensors only; a CUDA tensor reaches the kernel or the wrapper raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.quant.quantize import FLOAT_FORMATS, quantize_rows

CACHE_FORMATS = {"bf16": 0, "q8_0": 1, "q4_0": 2}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_RMSNORM_ARGS = (_I, _I, _P, _P, _P, _I, _I, _F, _P)
_ADD_RMSNORM_ARGS = (_I, _I, _P, _P, _P, _P, _P, _I, _I, _F, _P)
_SWIGLU_ARGS = (_I, _P, _P, _I, _I, _P)
_ROPE_ARGS = (_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
              _F, _P)
_ROPE_PREFILL_ARGS = (_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      _I, _I, _F, _P)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_cuda(what: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        _require(t.is_cuda and t.device == dev,
                 f"{what}: all inputs must be on one CUDA device")
        _require(t.is_contiguous(), f"{what}: inputs must be contiguous")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# -- RMSNorm ------------------------------------------------------------------
def rmsnorm_plain(x: torch.Tensor, weight: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def _check_norm(what: str, x: torch.Tensor, weight: torch.Tensor) -> int:
    """Rows of x for the kernel: bf16 or f32 x and weight (d,); → M."""
    d = x.shape[-1]
    _require(weight.shape == (d,), f"{what}: weight {tuple(weight.shape)} "
             f"for rows of {d}")
    kinds = (torch.bfloat16, torch.float32)
    _require(x.dtype in kinds and weight.dtype in kinds,
             f"{what} kernel takes bf16 or f32, got {x.dtype}, "
             f"{weight.dtype}")
    return x.numel() // d if d else 0


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x (..., d) bf16 or f32, weight (d,) bf16 or f32 → x's dtype."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, weight, eps)
    M = _check_norm("rmsnorm", x, weight)
    _check_cuda("rmsnorm", x, weight)
    out = torch.empty_like(x)
    if M == 0:
        return out
    fn = build.function("fused_ops", "rmsnorm", _RMSNORM_ARGS)
    err = fn(int(x.dtype == torch.float32), int(weight.dtype == torch.float32),
             x.data_ptr(), weight.data_ptr(), out.data_ptr(), M, x.shape[-1],
             float(eps), _stream(x))
    build.check(err, "rmsnorm")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0


def add_rmsnorm_plain(x: torch.Tensor, delta: torch.Tensor,
                      weight: torch.Tensor, eps: float = 1e-6
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    h = x + delta
    return h, rmsnorm_plain(h, weight, eps)


def add_rmsnorm(x: torch.Tensor, delta: torch.Tensor, weight: torch.Tensor,
                eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual add and the norm of its sum: x, delta (..., d) of one
    dtype, bf16 or f32, weight (d,) bf16 or f32 → (h, out), both x's
    dtype: h = x + delta, out = rmsnorm(h, weight, eps)."""
    _require(delta.shape == x.shape and delta.dtype == x.dtype,
             f"add_rmsnorm: delta {tuple(delta.shape)} {delta.dtype} is not "
             f"x's {tuple(x.shape)} {x.dtype}")
    if x.device.type == "cpu":
        return add_rmsnorm_plain(x, delta, weight, eps)
    M = _check_norm("add_rmsnorm", x, weight)
    _check_cuda("add_rmsnorm", x, delta, weight)
    h, out = torch.empty_like(x), torch.empty_like(x)
    if M == 0:
        return h, out
    fn = build.function("fused_ops", "add_rmsnorm", _ADD_RMSNORM_ARGS)
    err = fn(int(x.dtype == torch.float32), int(weight.dtype == torch.float32),
             x.data_ptr(), delta.data_ptr(), weight.data_ptr(), h.data_ptr(),
             out.data_ptr(), M, x.shape[-1], float(eps), _stream(x))
    build.check(err, "add_rmsnorm")
    add_rmsnorm.launches += 1
    return h, out


add_rmsnorm.launches = 0


# -- SwiGLU -------------------------------------------------------------------
def swiglu_plain(gu: torch.Tensor) -> torch.Tensor:
    """silu(g) * u of the halves g, u of the last axis, in f32 with one
    rounding to the input dtype."""
    g, u = gu.chunk(2, dim=-1)
    return (F.silu(g.float()) * u.float()).to(gu.dtype)


def swiglu(gu: torch.Tensor) -> torch.Tensor:
    """gu (..., 2 F) bf16 or f32 → (..., F)."""
    if gu.device.type == "cpu":
        return swiglu_plain(gu)
    _require(gu.shape[-1] % 2 == 0,
             f"swiglu: odd gate-up width {gu.shape[-1]}")
    _require(gu.dtype in (torch.bfloat16, torch.float32),
             f"swiglu kernel takes bf16 or f32, got {gu.dtype}")
    _check_cuda("swiglu", gu)
    Fw = gu.shape[-1] // 2
    out = torch.empty(gu.shape[:-1] + (Fw,), dtype=gu.dtype, device=gu.device)
    M = out.numel() // Fw if Fw else 0
    if M == 0:
        return out
    fn = build.function("fused_ops", "swiglu", _SWIGLU_ARGS)
    err = fn(int(gu.dtype == torch.float32), gu.data_ptr(), out.data_ptr(),
             M, Fw, _stream(gu))
    build.check(err, "swiglu")
    swiglu.launches += 1
    return out


swiglu.launches = 0


# -- RoPE and the decode cache write -----------------------------------------
def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Half-split rotation. x (..., H, D) with positions (...)."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, x.device)                   # (D/2,)
    angles = positions[..., None].float() * freqs            # (..., D/2)
    cos = torch.cos(angles)[..., None, :]                    # over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def kv_cache_write(cache: Dict, k: torch.Tensor, v: torch.Tensor,
                   slot: torch.Tensor, *, kv_quant: str = "bf16",
                   group: int = 32,
                   advance: Optional[torch.Tensor] = None) -> None:
    """Write one (B, Hkv, hd) K/V row per batch row at ring ``slot``
    (B,), in place. Quantized caches quantize the row at the write point
    (payload into ``k``/``v``, groupwise scales into ``k_scale`` /
    ``v_scale``). Rows with ``advance`` False keep their old contents."""
    B = k.shape[0]
    if kv_quant in FLOAT_FORMATS:
        rows = {"k": k, "v": v}
    else:
        kq, ks = quantize_rows(k, kv_quant, group)
        vq, vs = quantize_rows(v, kv_quant, group)
        rows = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    bidx = torch.arange(B, device=k.device)
    for name, new in rows.items():
        leaf = cache[name]
        new = new.to(leaf.dtype)
        if advance is not None:
            new = torch.where(advance[:, None, None], new,
                              leaf[bidx, :, slot])
        leaf[bidx, :, slot] = new


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
    _require(S <= S_cache, f"prefill of {S} positions into a {S_cache}-row "
             "cache needs the ring write of the windowed family, which the "
             "port does not carry yet")
    if kv_quant in FLOAT_FORMATS:
        rows = {"k": k, "v": v}
    else:
        kq, ks = quantize_rows(k, kv_quant, group)
        vq, vs = quantize_rows(v, kv_quant, group)
        rows = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    for name, new in rows.items():
        cache[name][:, :, :S] = new.to(cache[name].dtype)


def _qkv_layout(what: str, qkv: torch.Tensor, cache: Dict, fmt: str):
    """(B, Hq, Hkv, S_cache, D, ng) of fused-QKV rows (B, [S,] width) and
    one layer's cache."""
    B, W = qkv.shape[0], qkv.shape[-1]
    _require(cache["k"].ndim == 4 and cache["k"].shape[0] == B,
             f"{what}: cache {tuple(cache['k'].shape)} is not "
             f"(B={B}, Hkv, S, D')")
    _, Hkv, S, Dp = cache["k"].shape
    D = 2 * Dp if fmt == "q4_0" else Dp
    _require(D % 2 == 0 and W % D == 0 and (W // D - 2 * Hkv) % Hkv == 0
             and W // D > 2 * Hkv,
             f"{what}: qkv width {W} is not (Hq + 2 * {Hkv}) x {D} with Hq "
             f"a multiple of {Hkv}")
    ng = 0 if fmt in FLOAT_FORMATS else cache["k_scale"].shape[-1]
    return B, W // D - 2 * Hkv, Hkv, S, D, ng


def _cache_format(what: str, fmt: str) -> str:
    if fmt in FLOAT_FORMATS:
        fmt = "bf16"
    _require(fmt in CACHE_FORMATS, f"{what}: unknown cache format {fmt!r}")
    return fmt


def _cache_leaves(what: str, qkv: torch.Tensor, cache: Dict, fmt: str,
                  B: int, Hkv: int, S: int, D: int, ng: int) -> list:
    """One layer's cache leaves in the order the kernels take them,
    checked against the kernels' types and shapes."""
    names = ("k", "v") if fmt == "bf16" else ("k", "v", "k_scale", "v_scale")
    leaves = [cache[n] for n in names]
    want = torch.bfloat16 if fmt == "bf16" else torch.int8
    _require(qkv.dtype == torch.bfloat16 and leaves[0].dtype == want
             and leaves[1].dtype == want
             and leaves[1].shape == leaves[0].shape,
             f"{what}[{fmt}] takes bf16 qkv and a {want} cache")
    if ng:
        _require(D % ng == 0 and all(
            t.dtype == torch.bfloat16 and t.shape == (B, Hkv, S, ng)
            for t in leaves[2:]),
            f"{what}[{fmt}]: scales must be bf16 (B, Hkv, S, ng) with ng "
            f"dividing {D}")
    return leaves


def rope_cache_write_plain(qkv: torch.Tensor, cache: Dict,
                           lens: torch.Tensor,
                           advance: Optional[torch.Tensor], theta: float,
                           fmt: str) -> torch.Tensor:
    """``apply_rope`` of q and k at ``lens``, then ``kv_cache_write`` at
    ring slot ``lens % S``; returns q (B, Hq, D)."""
    _require(qkv.ndim == 2, f"rope_cache_write: qkv must be (B, width), got "
             f"{tuple(qkv.shape)}")
    B, Hq, Hkv, S, D, ng = _qkv_layout("rope_cache_write", qkv, cache, fmt)
    q = qkv[:, :Hq * D].reshape(B, Hq, D)
    k = qkv[:, Hq * D:(Hq + Hkv) * D].reshape(B, Hkv, D)
    v = qkv[:, (Hq + Hkv) * D:].reshape(B, Hkv, D)
    q = apply_rope(q, lens, theta)
    k = apply_rope(k, lens, theta)
    kv_cache_write(cache, k, v, lens % S, kv_quant=fmt,
                   group=D // ng if ng else 32, advance=advance)
    return q


def rope_cache_write(qkv: torch.Tensor, cache: Dict, lens: torch.Tensor,
                     advance: Optional[torch.Tensor], theta: float,
                     fmt: str) -> torch.Tensor:
    """qkv (B, q_dim + 2 kv_dim) bf16, one layer's cache leaves
    (B, Hkv, S, ·) in ``fmt``, lens (B,) int32, advance (B,) bool or
    None → q (B, Hq, D) bf16; the cache is written in place."""
    fmt = _cache_format("rope_cache_write", fmt)
    if qkv.device.type == "cpu":
        return rope_cache_write_plain(qkv, cache, lens, advance, theta, fmt)
    _require(qkv.ndim == 2, f"rope_cache_write: qkv must be (B, width), got "
             f"{tuple(qkv.shape)}")
    B, Hq, Hkv, S, D, ng = _qkv_layout("rope_cache_write", qkv, cache, fmt)
    leaves = _cache_leaves("rope_cache_write", qkv, cache, fmt, B, Hkv, S, D,
                           ng)
    _require(lens.dtype == torch.int32 and lens.shape == (B,),
             "rope_cache_write: lens must be int32 (B,)")
    extra = [lens]
    if advance is not None:
        _require(advance.dtype == torch.bool and advance.shape == (B,),
                 "rope_cache_write: advance must be bool (B,)")
        extra.append(advance)
    _check_cuda("rope_cache_write", qkv, *leaves, *extra)
    q = torch.empty((B, Hq, D), dtype=torch.bfloat16, device=qkv.device)
    if B == 0:
        return q
    fn = build.function("fused_ops", "rope_cache_write", _ROPE_ARGS)
    err = fn(CACHE_FORMATS[fmt], qkv.data_ptr(), q.data_ptr(),
             leaves[0].data_ptr(), leaves[1].data_ptr(),
             leaves[2].data_ptr() if ng else None,
             leaves[3].data_ptr() if ng else None, lens.data_ptr(),
             advance.data_ptr() if advance is not None else None,
             B, Hkv, Hq // Hkv, S, D, ng, float(theta), _stream(qkv))
    build.check(err, f"rope_cache_write[{fmt}]")
    rope_cache_write.launches += 1
    return q


rope_cache_write.launches = 0


# -- RoPE and the prefill cache write -----------------------------------------
def rope_cache_write_prefill_plain(qkv: torch.Tensor, cache: Dict,
                                   theta: float, fmt: str
                                   ) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """``apply_rope`` of q and k at positions 0..S-1 of every row, the
    (B, H, S, D) transposes, and ``kv_cache_write_prefill``; returns q, k,
    v in qkv's dtype."""
    _require(qkv.ndim == 3, f"rope_cache_write_prefill: qkv must be "
             f"(B, S, width), got {tuple(qkv.shape)}")
    B, Hq, Hkv, _, D, ng = _qkv_layout("rope_cache_write_prefill", qkv,
                                       cache, fmt)
    S = qkv.shape[1]
    q = qkv[..., :Hq * D].reshape(B, S, Hq, D)
    k = qkv[..., Hq * D:(Hq + Hkv) * D].reshape(B, S, Hkv, D)
    v = qkv[..., (Hq + Hkv) * D:].reshape(B, S, Hkv, D)
    positions = torch.arange(S, device=qkv.device).expand(B, S)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kv_cache_write_prefill(cache, k, v, kv_quant=fmt,
                           group=D // ng if ng else 32)
    return q, k, v


def rope_cache_write_prefill(qkv: torch.Tensor, cache: Dict, theta: float,
                             fmt: str) -> Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """qkv (B, S, q_dim + 2 kv_dim) bf16 and one layer's cache leaves
    (B, Hkv, S_cache >= S, ·) in ``fmt`` → q (B, Hq, S, D), k and v
    (B, Hkv, S, D), bf16 and contiguous; cache positions [0, S) of every
    row are written in place."""
    fmt = _cache_format("rope_cache_write_prefill", fmt)
    if qkv.device.type == "cpu":
        return rope_cache_write_prefill_plain(qkv, cache, theta, fmt)
    _require(qkv.ndim == 3, f"rope_cache_write_prefill: qkv must be "
             f"(B, S, width), got {tuple(qkv.shape)}")
    B, Hq, Hkv, S_cache, D, ng = _qkv_layout("rope_cache_write_prefill",
                                             qkv, cache, fmt)
    S = qkv.shape[1]
    _require(S <= S_cache, f"rope_cache_write_prefill: prefill of {S} "
             f"positions into a {S_cache}-row cache needs the ring write of "
             "the windowed family, which the port does not carry yet")
    leaves = _cache_leaves("rope_cache_write_prefill", qkv, cache, fmt, B,
                           Hkv, S_cache, D, ng)
    _check_cuda("rope_cache_write_prefill", qkv, *leaves)
    q = torch.empty((B, Hq, S, D), dtype=torch.bfloat16, device=qkv.device)
    k, v = (torch.empty((B, Hkv, S, D), dtype=torch.bfloat16,
                        device=qkv.device) for _ in range(2))
    if B == 0 or S == 0:
        return q, k, v
    fn = build.function("fused_ops", "rope_cache_write_prefill",
                        _ROPE_PREFILL_ARGS)
    err = fn(CACHE_FORMATS[fmt], qkv.data_ptr(), q.data_ptr(), k.data_ptr(),
             v.data_ptr(), leaves[0].data_ptr(), leaves[1].data_ptr(),
             leaves[2].data_ptr() if ng else None,
             leaves[3].data_ptr() if ng else None,
             B, Hkv, Hq // Hkv, S, S_cache, D, ng, float(theta), _stream(qkv))
    build.check(err, f"rope_cache_write_prefill[{fmt}]")
    rope_cache_write_prefill.launches += 1
    return q, k, v


rope_cache_write_prefill.launches = 0
