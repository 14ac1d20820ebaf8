"""RMSNorm (alone, or with the residual add before it), SwiGLU, GeGLU, and
RoPE with the cache write (one decode token, or a whole prefill): the small
fused kernels of ``csrc/fused_ops.cu``.

No Pallas kernel of the JAX package stands behind them: inside the
jitted megastep and prefill XLA fuses ``layers.rmsnorm`` with the
residual adds, the SwiGLU or GeGLU of ``mlp_forward`` and ``apply_rope`` with
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
- ``geglu(gu)``: the same for the GeGLU FFN (``cfg.activation``
  "gelu", recurrentgemma): ``gelu(g) * u`` with the JAX rounding points,
  ``gelu`` (the JAX ``layers.gelu``, its logistic form) in f32 rounded
  to the input dtype, then the product rounded again.
- ``rope_cache_write(qkv, cache, lens, advance, theta, fmt,
  block_table, bias)``: one token's fused-QKV rows (B, q_dim + 2 kv_dim)
  bf16 → the roped q (B, Hq, D); the roped K and the V row go into ring slot
  ``lens % S`` of one layer's cache (bf16, or q8_0 / q4_0 quantized at
  the write point) for the rows where ``advance`` is True. A paged
  cache (pools (n_blocks, Hkv, P, ·) and its ``block_table``
  (B, max_pages), S = max_pages × P) takes ring slot pos to row
  pos % P of block ``block_table[b, pos // P]``.
- ``rope_cache_write_prefill(qkv, cache, theta, fmt, bias)``: a
  prefill's fused-QKV rows (B, S, q_dim + 2 kv_dim) bf16 → q (B, Hq, S,
  D) and k, v (B, Hkv, S, D), roped at positions 0..S-1 of every row, in
  the layout the prefill attention takes; K and V go into cache
  positions [0, S) of every row in the cache's format, or, for a prefill
  longer than the cache (S > S_cache), its last S_cache positions at
  ring slots ``pos % S_cache`` (the ring branch of the JAX
  ``_write_prefill_kv``; the windowed family, and a resumed request past
  ``max_len``).

Both RoPE kernels take the fused QKV projection's bias (``bias``, one
value a column, or None): each element is ``qkv + bias`` rounded to
qkv's dtype, the JAX ``layers.linear``'s add, before RoPE and the cache
write. The kernels read every qkv element once anyway, so the add costs
no launch of its own.

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
_ROPE_ARGS = (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
              _I, _I, _I, _I, _F, _P)
_ROPE_PREFILL_ARGS = (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                      _I, _I, _I, _I, _F, _P)


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


# -- GeGLU --------------------------------------------------------------------
def gelu(x: torch.Tensor) -> torch.Tensor:
    """The JAX ``layers.gelu``: the tanh approximation with the tanh
    written as 2 sigmoid(2z) - 1, in f32, rounded to x's dtype."""
    xf = x.float()
    z = 0.7978845608028654 * (xf + 0.044715 * xf * xf * xf)
    t = 2.0 * torch.sigmoid(2.0 * z) - 1.0
    return (0.5 * xf * (1.0 + t)).to(x.dtype)


def geglu_plain(gu: torch.Tensor) -> torch.Tensor:
    """gelu(g) * u of the halves g, u of the last axis: gelu rounded to
    the input dtype, then the product (the JAX ``mlp_forward``)."""
    g, u = gu.chunk(2, dim=-1)
    return gelu(g) * u


def geglu(gu: torch.Tensor) -> torch.Tensor:
    """gu (..., 2 F) bf16 or f32 → (..., F)."""
    if gu.device.type == "cpu":
        return geglu_plain(gu)
    _require(gu.shape[-1] % 2 == 0,
             f"geglu: odd gate-up width {gu.shape[-1]}")
    _require(gu.dtype in (torch.bfloat16, torch.float32),
             f"geglu kernel takes bf16 or f32, got {gu.dtype}")
    _check_cuda("geglu", gu)
    Fw = gu.shape[-1] // 2
    out = torch.empty(gu.shape[:-1] + (Fw,), dtype=gu.dtype, device=gu.device)
    M = out.numel() // Fw if Fw else 0
    if M == 0:
        return out
    fn = build.function("fused_ops", "geglu", _SWIGLU_ARGS)
    err = fn(int(gu.dtype == torch.float32), gu.data_ptr(), out.data_ptr(),
             M, Fw, _stream(gu))
    build.check(err, "geglu")
    geglu.launches += 1
    return out


geglu.launches = 0


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
                   advance: Optional[torch.Tensor] = None,
                   block_table: Optional[torch.Tensor] = None) -> None:
    """Write one (B, Hkv, hd) K/V row per batch row at ring ``slot``
    (B,), in place. Quantized caches quantize the row at the write point
    (payload into ``k``/``v``, groupwise scales into ``k_scale`` /
    ``v_scale``). Rows with ``advance`` False keep their old contents.

    A paged cache (pools (n_blocks, Hkv, P, ·) and ``block_table``
    (B, max_pages)) puts position ``slot`` at row ``slot % P`` of block
    ``block_table[b, slot // P]``. A frozen row's write goes to the
    garbage block 0, as in the JAX package (its slot's blocks keep their
    contents; the kernel writes nothing at all for it)."""
    B = k.shape[0]
    if kv_quant in FLOAT_FORMATS:
        rows = {"k": k, "v": v}
    else:
        kq, ks = quantize_rows(k, kv_quant, group)
        vq, vs = quantize_rows(v, kv_quant, group)
        rows = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    bidx = torch.arange(B, device=k.device)
    if block_table is not None:
        P = cache["k"].shape[2]
        blk = block_table[bidx, slot // P].long()
        if advance is not None:
            blk = torch.where(advance, blk, torch.zeros_like(blk))
        for name, new in rows.items():
            cache[name][blk, :, slot % P] = new.to(cache[name].dtype)
        return
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
    """Write prefill K/V (B, Hkv, S, hd) into one layer's cache, in place
    (the JAX package's ``_write_prefill_kv``): positions [0, S) of every
    row, or, when S is longer than the cache (S_cache positions: a
    windowed model's ring, or a resumed request past ``max_len``), the
    last S_cache positions, position pos at ring slot ``pos % S_cache``.
    Quantized caches quantize the rows at the write point, per position,
    so they equal what the stepwise decode path writes one at a time.
    Rows past a prompt's true length are the padding's junk, as in the
    JAX package: decode reads only ``lens + 1`` rows and overwrites the
    junk in order before it is ever visible (the ring branch takes no
    padding: its prompts are bucketed at their exact length)."""
    S, S_cache = k.shape[2], cache["k"].shape[2]
    if kv_quant in FLOAT_FORMATS:
        rows = {"k": k, "v": v}
    else:
        kq, ks = quantize_rows(k, kv_quant, group)
        vq, vs = quantize_rows(v, kv_quant, group)
        rows = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    for name, new in rows.items():
        new = new.to(cache[name].dtype)
        if S <= S_cache:
            cache[name][:, :, :S] = new
        else:
            cache[name].copy_(torch.roll(new[:, :, S - S_cache:],
                                         S % S_cache, dims=2))


def _qkv_layout(what: str, qkv: torch.Tensor, cache: Dict, fmt: str,
                block_table: Optional[torch.Tensor] = None):
    """(B, Hq, Hkv, S_cache, D, ng) of fused-QKV rows (B, [S,] width) and
    one layer's cache (a paged one: S_cache = max_pages × P)."""
    B, W = qkv.shape[0], qkv.shape[-1]
    if block_table is None:
        _require(cache["k"].ndim == 4 and cache["k"].shape[0] == B,
                 f"{what}: cache {tuple(cache['k'].shape)} is not "
                 f"(B={B}, Hkv, S, D')")
    else:
        _require(cache["k"].ndim == 4 and block_table.ndim == 2
                 and block_table.shape[0] == B
                 and block_table.dtype == torch.int32,
                 f"{what}: pool {tuple(cache['k'].shape)} and block table "
                 f"{tuple(block_table.shape)} are not (n_blocks, Hkv, P, "
                 f"D') and int32 (B={B}, max_pages)")
    _, Hkv, S, Dp = cache["k"].shape
    if block_table is not None:
        S *= block_table.shape[1]
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
    checked against the kernels' types and shapes (B and S are the
    pool's blocks and page size for a paged cache)."""
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


def _with_bias(qkv: torch.Tensor,
               bias: Optional[torch.Tensor]) -> torch.Tensor:
    """qkv + bias rounded to qkv's dtype: the JAX ``layers.linear``'s
    add after the projection."""
    return qkv if bias is None else qkv + bias.to(qkv.dtype)


def rope_cache_write_plain(qkv: torch.Tensor, cache: Dict,
                           lens: torch.Tensor,
                           advance: Optional[torch.Tensor], theta: float,
                           fmt: str,
                           block_table: Optional[torch.Tensor] = None,
                           bias: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The bias add, ``apply_rope`` of q and k at ``lens``, then
    ``kv_cache_write`` at ring slot ``lens % S`` (through ``block_table``
    for a paged cache); returns q (B, Hq, D)."""
    _require(qkv.ndim == 2, f"rope_cache_write: qkv must be (B, width), got "
             f"{tuple(qkv.shape)}")
    B, Hq, Hkv, S, D, ng = _qkv_layout("rope_cache_write", qkv, cache, fmt,
                                       block_table)
    qkv = _with_bias(qkv, bias)
    q = qkv[:, :Hq * D].reshape(B, Hq, D)
    k = qkv[:, Hq * D:(Hq + Hkv) * D].reshape(B, Hkv, D)
    v = qkv[:, (Hq + Hkv) * D:].reshape(B, Hkv, D)
    q = apply_rope(q, lens, theta)
    k = apply_rope(k, lens, theta)
    kv_cache_write(cache, k, v, lens % S, kv_quant=fmt,
                   group=D // ng if ng else 32, advance=advance,
                   block_table=block_table)
    return q


def _check_bias(what: str, qkv: torch.Tensor,
                bias: Optional[torch.Tensor]) -> None:
    if bias is not None:
        _require(bias.shape == qkv.shape[-1:],
                 f"{what}: bias {tuple(bias.shape)} is not one value a qkv "
                 f"column ({qkv.shape[-1]},)")


def _kernel_bias(what: str, bias: Optional[torch.Tensor]) -> list:
    """[bias] for the kernel's device checks, or [] without one."""
    if bias is None:
        return []
    _require(bias.dtype == torch.bfloat16,
             f"{what}: the kernel takes a bf16 bias, got {bias.dtype}")
    return [bias]


def decode_rope_takes(D: int, ng: int) -> bool:
    """Whether the decode RoPE + cache-write kernel takes head dim D with
    ng scales a cache row (0: a bf16 cache). A thread takes a 16-byte run
    of 8 elements in each half of a head row, and a head's D / 16 runs
    lie in one warp: D a multiple of 16, D / 16 a power of two up to 32.
    A quantization group of g = D / ng features takes its amax by warp
    shuffles over the runs it spans: g a multiple of 8 dividing D / 2,
    or the whole row (ng 1)."""
    runs = D // 16
    if D <= 0 or D % 16 or runs > 32 or runs & (runs - 1):
        return False
    return ng in (0, 1) or (D % ng == 0 and (D // ng) % 8 == 0
                            and (D // 2) % (D // ng) == 0)


def rope_cache_write(qkv: torch.Tensor, cache: Dict, lens: torch.Tensor,
                     advance: Optional[torch.Tensor], theta: float,
                     fmt: str, block_table: Optional[torch.Tensor] = None,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """qkv (B, q_dim + 2 kv_dim) bf16, one layer's cache leaves
    (B, Hkv, S, ·) in ``fmt``, or pools (n_blocks, Hkv, P, ·) with their
    ``block_table`` (B, max_pages) int32, lens (B,) int32, advance (B,)
    bool or None, bias (q_dim + 2 kv_dim,) bf16 or None → q (B, Hq, D)
    bf16; the cache is written in place."""
    fmt = _cache_format("rope_cache_write", fmt)
    _check_bias("rope_cache_write", qkv, bias)
    if qkv.device.type == "cpu":
        return rope_cache_write_plain(qkv, cache, lens, advance, theta, fmt,
                                      block_table, bias)
    _require(qkv.ndim == 2, f"rope_cache_write: qkv must be (B, width), got "
             f"{tuple(qkv.shape)}")
    B, Hq, Hkv, S, D, ng = _qkv_layout("rope_cache_write", qkv, cache, fmt,
                                       block_table)
    rows, per_row = (B, S) if block_table is None else \
        (cache["k"].shape[0], cache["k"].shape[2])
    leaves = _cache_leaves("rope_cache_write", qkv, cache, fmt, rows, Hkv,
                           per_row, D, ng)
    _require(lens.dtype == torch.int32 and lens.shape == (B,),
             "rope_cache_write: lens must be int32 (B,)")
    extra = [lens]
    if advance is not None:
        _require(advance.dtype == torch.bool and advance.shape == (B,),
                 "rope_cache_write: advance must be bool (B,)")
        extra.append(advance)
    if block_table is not None:
        extra.append(block_table)
    extra += _kernel_bias("rope_cache_write", bias)
    _check_cuda("rope_cache_write", qkv, *leaves, *extra)
    _require(decode_rope_takes(D, ng),
             f"rope_cache_write[{fmt}]: the kernel takes no head dim {D} "
             f"with {ng} scales a row")
    q = torch.empty((B, Hq, D), dtype=torch.bfloat16, device=qkv.device)
    _require(all(t.data_ptr() % 16 == 0 for t in
                 [qkv, q, *leaves[:2], *_kernel_bias("rope_cache_write",
                                                     bias)]),
             "rope_cache_write: qkv, the bias and the cache must be "
             "16-byte aligned")
    if B == 0:
        return q
    fn = build.function("fused_ops", "rope_cache_write", _ROPE_ARGS)
    err = fn(CACHE_FORMATS[fmt], qkv.data_ptr(),
             bias.data_ptr() if bias is not None else None, q.data_ptr(),
             leaves[0].data_ptr(), leaves[1].data_ptr(),
             leaves[2].data_ptr() if ng else None,
             leaves[3].data_ptr() if ng else None, lens.data_ptr(),
             advance.data_ptr() if advance is not None else None,
             block_table.data_ptr() if block_table is not None else None,
             0 if block_table is None else block_table.shape[1],
             0 if block_table is None else per_row,
             B, Hkv, Hq // Hkv, S, D, ng, float(theta), _stream(qkv))
    build.check(err, f"rope_cache_write[{fmt}]")
    rope_cache_write.launches += 1
    return q


rope_cache_write.launches = 0


# -- RoPE and the prefill cache write -----------------------------------------
def rope_cache_write_prefill_plain(qkv: torch.Tensor, cache: Dict,
                                   theta: float, fmt: str,
                                   bias: Optional[torch.Tensor] = None
                                   ) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """The bias add, ``apply_rope`` of q and k at positions 0..S-1 of
    every row, the (B, H, S, D) transposes, and ``kv_cache_write_prefill``
    (its ring branch when S is longer than the cache); returns q, k, v in
    qkv's dtype, all S positions."""
    _require(qkv.ndim == 3, f"rope_cache_write_prefill: qkv must be "
             f"(B, S, width), got {tuple(qkv.shape)}")
    B, Hq, Hkv, _, D, ng = _qkv_layout("rope_cache_write_prefill", qkv,
                                       cache, fmt)
    qkv = _with_bias(qkv, bias)
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
                             fmt: str, bias: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """qkv (B, S, q_dim + 2 kv_dim) bf16, one layer's cache leaves
    (B, Hkv, S_cache, ·) in ``fmt`` and bias (q_dim + 2 kv_dim,) bf16 or
    None → q (B, Hq, S, D), k and v (B, Hkv, S, D), bf16 and contiguous;
    cache positions [0, S) of every row are written in place, or the
    last S_cache positions at their ring slots when S > S_cache."""
    fmt = _cache_format("rope_cache_write_prefill", fmt)
    _check_bias("rope_cache_write_prefill", qkv, bias)
    if qkv.device.type == "cpu":
        return rope_cache_write_prefill_plain(qkv, cache, theta, fmt, bias)
    _require(qkv.ndim == 3, f"rope_cache_write_prefill: qkv must be "
             f"(B, S, width), got {tuple(qkv.shape)}")
    B, Hq, Hkv, S_cache, D, ng = _qkv_layout("rope_cache_write_prefill",
                                             qkv, cache, fmt)
    S = qkv.shape[1]
    leaves = _cache_leaves("rope_cache_write_prefill", qkv, cache, fmt, B,
                           Hkv, S_cache, D, ng)
    _check_cuda("rope_cache_write_prefill", qkv, *leaves,
                *_kernel_bias("rope_cache_write_prefill", bias))
    q = torch.empty((B, Hq, S, D), dtype=torch.bfloat16, device=qkv.device)
    k, v = (torch.empty((B, Hkv, S, D), dtype=torch.bfloat16,
                        device=qkv.device) for _ in range(2))
    if B == 0 or S == 0:
        return q, k, v
    fn = build.function("fused_ops", "rope_cache_write_prefill",
                        _ROPE_PREFILL_ARGS)
    err = fn(CACHE_FORMATS[fmt], qkv.data_ptr(),
             bias.data_ptr() if bias is not None else None, q.data_ptr(),
             k.data_ptr(), v.data_ptr(), leaves[0].data_ptr(), leaves[1].data_ptr(),
             leaves[2].data_ptr() if ng else None,
             leaves[3].data_ptr() if ng else None,
             B, Hkv, Hq // Hkv, S, S_cache, D, ng, float(theta), _stream(qkv))
    build.check(err, f"rope_cache_write_prefill[{fmt}]")
    rope_cache_write_prefill.launches += 1
    return q, k, v


rope_cache_write_prefill.launches = 0
