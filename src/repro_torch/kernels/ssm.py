"""The SSM family's kernels (Mamba-2 SSD, ``csrc/ssm.cu``): the causal
conv with its state, the decode step (the token's conv and the state
update in one launch), the chunked SSD prefill scan, and the gated
RMSNorm.

No Pallas kernel of the JAX package stands behind them: its
``models/ssm.py`` computes the layer with ``jnp`` outside any kernel.
Eagerly, a decode step of the layer is about ten PyTorch launches, each
reading or writing the layer's f32 state; each kernel here is one launch
but the scan (``scan_launches``). The design of each is described in the
source. The decode path runs ``ssm_decode_step`` and ``gated_rmsnorm``;
the prefill path ``ssm_conv``, ``ssd_prefill`` and ``gated_rmsnorm``.

- ``ssm_conv(x, w, b, state, advance, carry)``: the depthwise causal conv
  of width W (the kernel: ``CONV_WIDTH``, every config's) over x (B, S, C)
  (rows may be strided, columns contiguous), plus the bias and silu (the
  JAX ``_causal_conv``), → y (B, S, C) in x's dtype. The conv state
  (B, W - 1, C) holds the W - 1 inputs before x: it is read (``carry``;
  else taken as zeros) and replaced in place by the last W - 1 inputs of
  state ++ x, for the rows where ``advance`` (B,) bool is set (None: every
  row); a frozen row's state is untouched. A thread of the kernel takes a
  16-byte run of 8 channels and ``CONV_STRETCH`` positions, its loads all
  issued before its arithmetic; the kernel takes C a multiple of 8 and x
  rows at strides that are multiples of 8, 16-byte aligned. Its y and
  state are bit-equal to the plain version's.
- ``ssm_decode_step(xbc, dt, conv_w, conv_b, conv_state, dt_bias, A_log,
  D, state, advance)``: one decode token's conv and SSD update in one
  launch, the decode path's. xbc (B, H P + 2 N) is the conv's input (x,
  then B, then C), dt (B, H) the projection's raw dt; the conv is
  ``ssm_conv``'s of one position, then dt = softplus(dt + dt_bias) and A
  = -exp(A_log) in f32, S <- S exp(dt A) + dt x (x) B and y = S C + D x in
  f32, rounded once → y (B, H P). The conv state and the f32 state
  (B, H, P, N) are updated in place where ``advance`` is set. Its plain
  version is ``ssm_conv_plain`` then ``ssm_decode_update_plain`` (the JAX
  ``ssm_decode``'s update). A CTA of the kernel takes ``STEP_ROWS`` p rows
  of one (slot, head), a lane of a warp the same four n of each row, so a
  row's sum over n has one order from N alone and a slot's bits do not
  depend on B. Every CTA of a slot computes the conv of B and C, and the
  slot's last CTA, by an int32 ticket of the stream
  (``kernels/tickets.py``), replaces their conv state. The kernel takes P
  a multiple of ``STEP_ROWS`` and N a multiple of 4 up to
  ``DECODE_MAX_STATE``.
- ``ssd_prefill(xbc, dt, dt_bias, A_log, D, state, carry)``: the chunked
  SSD over a whole prompt, xbc (B, S, H P + 2 N), dt (B, S, H), from the
  state (``carry``; else zeros), → y (B, S, H P): the scan's y rounded to
  xbc's dtype, plus x D in that dtype (the JAX ``ssm_forward``); the final
  f32 state is written into ``state``. The kernel scans chunks of its own
  length (64, the last one masked), ``SCAN_SLICE`` chunks at a time, in
  ``SCAN_KERNELS`` launches a slice (a walk over the chunks that passes
  the state, then the chunk outputs in parallel), its products on the tensor cores with each f32 operand
  split into three bf16 parts (``split3``); the
  plain version uses the JAX package's chunk rule (``chunk``, halved until
  it divides S). The algorithm is exact: the two differ by rounding only.
  The kernel takes P = ``SCAN_HEAD_DIM`` and N a multiple of 8 up to
  ``MAX_STATE``.
- ``gated_rmsnorm(y, z, w, eps)``: rmsnorm(y * silu(z)) * w, the product
  in y's dtype, the norm in f32, one rounding (z's rows may be strided).
  The kernel gives a thread of one CTA a row a 16-byte run, its order of
  sums fixed by ``norm_plan(d)`` from d alone, so a row's bits do not
  depend on the number of rows (``gated_rmsnorm_planned`` is that order
  in PyTorch): d a multiple of 8 and at most ``NORM_MAX_D``, z's row
  stride a multiple of 8, every pointer 16-byte aligned.

Each ``*_plain`` function is the plain PyTorch version with the JAX
package's rounding points; ``causal_conv`` and ``ssd_chunked`` are the
JAX functions as they are. A wrapper runs the plain version for CPU
tensors only; a CUDA tensor reaches the kernel or the wrapper raises. The
kernels take bf16 activations and parameters (f32 parameters are served
on the CPU only).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.fused_ops import rmsnorm_plain
from repro_torch.kernels.tickets import tickets

CONV_WIDTH = 4                 # the conv kernel's width
CONV_STRETCH = 4               # positions a thread of the conv kernel takes
MAX_STATE = 128                # the scan kernel's largest N
SCAN_CHUNK = 64                # the scan kernel's chunk
SCAN_HEAD_DIM = 64             # the scan kernel's P (wgmma's 64 rows)
SCAN_KERNELS = 2               # launches of one slice of an ssd_prefill call
SCAN_SLICE = 8                 # chunks a slice (the f32 scratch's depth)
NORM_MAX_D = 8192              # the gated norm kernel's widest row
DECODE_MAX_STATE = 128         # the decode step's largest N (a float4 a lane)
STEP_ROWS = 64                 # p rows a CTA of ``ssm_decode_step``

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_CONV_ARGS = (_P, _L, _L, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P)
_STEP_ARGS = (_P, _L, _P, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
              _I, _I, _P)
_SCAN_ARGS = (_P, _L, _L, _P, _L, _L, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
              _I, _I, _I, _P)
_NORM_ARGS = (_P, _P, _L, _P, _P, _I, _I, _F, _I, _P)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_cuda(what: str, *tensors: Optional[torch.Tensor]) -> None:
    """One CUDA device, bf16 activations and parameters, f32 SSD states
    and a bool ``advance``; every tensor contiguous in its last dim."""
    dev = next(t for t in tensors if t is not None).device
    for t in tensors:
        if t is None:
            continue
        _require(t.is_cuda and t.device == dev,
                 f"{what}: all inputs must be on one CUDA device")
        _require(t.dtype in (torch.bfloat16, torch.float32, torch.bool),
                 f"{what}: unexpected dtype {t.dtype}")
        _require(t.dim() == 0 or t.stride(-1) == 1,
                 f"{what}: the last dim must be contiguous")


def _bf16(what: str, *tensors: torch.Tensor) -> None:
    _require(all(t.dtype == torch.bfloat16 for t in tensors),
             f"{what} kernel takes bf16 activations and parameters, got "
             f"{[t.dtype for t in tensors]}")


def _advance(what: str, advance: Optional[torch.Tensor], B: int):
    if advance is None:
        return None
    _require(advance.dtype == torch.bool and tuple(advance.shape) == (B,)
             and advance.is_contiguous(),
             f"{what}: advance must be a contiguous bool ({B},)")
    return advance.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _write_rows(dst: torch.Tensor, src: torch.Tensor,
                advance: Optional[torch.Tensor]) -> None:
    """dst[b] = src[b] for the rows where advance is set (all without)."""
    src = src.to(dst.dtype)
    if advance is None:
        dst.copy_(src)
    else:
        m = advance.view((-1,) + (1,) * (dst.dim() - 1))
        dst.copy_(torch.where(m, src, dst))


def softplus(v: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: max(v, 0) + log1p(exp(-|v|))."""
    return torch.clamp(v, min=0) + torch.log1p(torch.exp(-v.abs()))


# -- the causal conv ----------------------------------------------------------
def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX ``_causal_conv``: x (B, S, C), w (W, C), b (C,), state
    (B, W - 1, C) or None (zeros) → (silu(conv + b), the new state), in
    x's dtype: each product and partial sum rounded as a sum of x-dtype
    products is."""
    width, S = w.shape[0], x.shape[1]
    if state is None:
        state = torch.zeros(x.shape[:1] + (width - 1,) + x.shape[2:],
                            dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = xp[:, :S] * w[0].to(x.dtype)
    for i in range(1, width):
        y = y + xp[:, i:i + S] * w[i].to(x.dtype)
    return F.silu(y + b.to(x.dtype)), xp[:, -(width - 1):]


def ssm_conv_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   state: torch.Tensor, advance: Optional[torch.Tensor] = None,
                   carry: bool = True) -> torch.Tensor:
    y, new = causal_conv(x, w, b, state if carry else None)
    _write_rows(state, new, advance)
    return y


def ssm_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             state: torch.Tensor, advance: Optional[torch.Tensor] = None,
             carry: bool = True) -> torch.Tensor:
    """x (B, S, C), w (W, C), b (C,), state (B, W - 1, C) → y (B, S, C);
    the state is updated in place (see the module docstring)."""
    (B, S, C), W = x.shape, w.shape[0]
    _require(tuple(w.shape) == (W, C) and tuple(b.shape) == (C,)
             and tuple(state.shape) == (B, W - 1, C),
             f"ssm_conv: x {tuple(x.shape)}, w {tuple(w.shape)}, b "
             f"{tuple(b.shape)}, state {tuple(state.shape)}")
    if x.device.type == "cpu":
        return ssm_conv_plain(x, w, b, state, advance, carry)
    _require(W == CONV_WIDTH, f"ssm_conv: the kernel's width is "
             f"{CONV_WIDTH}, got {W}")
    _check_cuda("ssm_conv", x, w, b, state, advance)
    _bf16("ssm_conv", x, w, b, state)
    x_ss = x.stride(1) if S > 1 else 0
    _require(w.is_contiguous() and state.is_contiguous() and C % 8 == 0
             and x.stride(0) % 8 == 0 and x_ss % 8 == 0
             and all(t.data_ptr() % 16 == 0 for t in (x, w, b, state)),
             f"ssm_conv: the kernel takes C a multiple of 8 (got {C}), x "
             "rows at strides that are multiples of 8, 16-byte aligned, and "
             "a contiguous w and state")
    y = torch.empty((B, S, C), dtype=x.dtype, device=x.device)
    fn = build.function("ssm", "ssm_conv", _CONV_ARGS)
    err = fn(x.data_ptr(), x.stride(0), x_ss, w.data_ptr(),
             b.data_ptr(), state.data_ptr(), _advance("ssm_conv", advance, B),
             y.data_ptr(), B, S, C, int(carry), _stream(x))
    build.check(err, "ssm_conv")
    ssm_conv.launches += 1
    return y


ssm_conv.launches = 0


def _split(xbc: torch.Tensor, H: int, P: int, N: int):
    """x (..., H, P), B (..., N), C (..., N) of the conv's output."""
    di = H * P
    return (xbc[..., :di].reshape(xbc.shape[:-1] + (H, P)),
            xbc[..., di:di + N], xbc[..., di + N:di + 2 * N])


def _check_ssd(what: str, xbc: torch.Tensor, dt: torch.Tensor,
               vectors, state: torch.Tensor) -> Tuple[int, int, int]:
    H, P, N = state.shape[1:]
    _require(xbc.shape[-1] == H * P + 2 * N and dt.shape[-1] == H
             and dt.shape[:-1] == xbc.shape[:-1]
             and state.shape[0] == xbc.shape[0]
             and all(tuple(v.shape) == (H,) for v in vectors)
             and state.dtype == torch.float32,
             f"{what}: xbc {tuple(xbc.shape)}, dt {tuple(dt.shape)}, state "
             f"{tuple(state.shape)} {state.dtype}")
    return H, P, N


# -- the decode state update (the plain half of ``ssm_decode_step``) ----------
def ssm_decode_update_plain(xbc: torch.Tensor, dt: torch.Tensor,
                            dt_bias: torch.Tensor, A_log: torch.Tensor,
                            D: torch.Tensor, state: torch.Tensor,
                            advance: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """The JAX ``ssm_decode``'s update (ssm.py:162-172)."""
    B = xbc.shape[0]
    H, P, N = _check_ssd("ssm_decode_update", xbc, dt, (dt_bias, A_log, D),
                         state)
    xs, Bm, Cm = _split(xbc, H, P, N)
    dt1 = softplus(dt.float() + dt_bias.float())                 # (B, H)
    A = -torch.exp(A_log.float())
    decay = torch.exp(dt1 * A[None])
    dBx = (dt1[:, :, None, None] * xs.float()[:, :, :, None]
           * Bm.float()[:, None, None, :])
    s_new = state * decay[..., None, None] + dBx
    y = torch.einsum("bhpn,bn->bhp", s_new, Cm.float())
    y = y + xs.float() * D.float()[None, :, None]
    _write_rows(state, s_new, advance)
    return y.reshape(B, H * P).to(xbc.dtype)


# -- the decode conv and state update in one launch ---------------------------
def ssm_decode_step_plain(xbc: torch.Tensor, dt: torch.Tensor,
                          conv_w: torch.Tensor, conv_b: torch.Tensor,
                          conv_state: torch.Tensor, dt_bias: torch.Tensor,
                          A_log: torch.Tensor, D: torch.Tensor,
                          state: torch.Tensor,
                          advance: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """``ssm_conv_plain`` of the token, then ``ssm_decode_update_plain``."""
    x = ssm_conv_plain(xbc[:, None], conv_w, conv_b, conv_state, advance)
    return ssm_decode_update_plain(x[:, 0], dt, dt_bias, A_log, D, state,
                                   advance)


def ssm_decode_step(xbc: torch.Tensor, dt: torch.Tensor, conv_w: torch.Tensor,
                    conv_b: torch.Tensor, conv_state: torch.Tensor,
                    dt_bias: torch.Tensor, A_log: torch.Tensor,
                    D: torch.Tensor, state: torch.Tensor,
                    advance: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decode token's conv and state update: xbc (B, H P + 2 N) the
    token's conv input (rows may be strided), dt (B, H) → y (B, H P); the
    conv state (B, W - 1, H P + 2 N) and the f32 state (B, H, P, N) are
    updated in place where ``advance`` is set (see the module docstring)."""
    if xbc.device.type == "cpu":
        return ssm_decode_step_plain(xbc, dt, conv_w, conv_b, conv_state,
                                     dt_bias, A_log, D, state, advance)
    B, C = xbc.shape
    H, P, N = _check_ssd("ssm_decode_step", xbc, dt, (dt_bias, A_log, D),
                         state)
    _require(tuple(conv_w.shape) == (CONV_WIDTH, C)
             and tuple(conv_b.shape) == (C,)
             and tuple(conv_state.shape) == (B, CONV_WIDTH - 1, C),
             f"ssm_decode_step: the kernel's conv width is {CONV_WIDTH}; "
             f"conv_w {tuple(conv_w.shape)}, conv_b {tuple(conv_b.shape)}, "
             f"conv state {tuple(conv_state.shape)} for xbc {(B, C)}")
    _check_cuda("ssm_decode_step", xbc, dt, conv_w, conv_b, conv_state,
                dt_bias, A_log, D, state, advance)
    _bf16("ssm_decode_step", xbc, dt, conv_w, conv_b, conv_state, dt_bias,
          A_log, D)
    _require(P % STEP_ROWS == 0 and N % 4 == 0 and N <= DECODE_MAX_STATE
             and state.is_contiguous() and conv_w.is_contiguous()
             and conv_state.is_contiguous() and xbc.stride(0) % 8 == 0
             and all(t.data_ptr() % 16 == 0
                     for t in (xbc, conv_w, conv_b, conv_state, state)),
             f"ssm_decode_step: the kernel takes P a multiple of {STEP_ROWS} "
             f"(got {P}), N a multiple of 4 up to {DECODE_MAX_STATE} (got "
             f"{N}), xbc rows at a stride that is a multiple of 8, "
             "contiguous states and weights, all 16-byte aligned")
    y = torch.empty((B, H * P), dtype=xbc.dtype, device=xbc.device)
    counts = tickets(B, xbc.device)
    fn = build.function("ssm", "ssm_decode_step", _STEP_ARGS)
    err = fn(xbc.data_ptr(), xbc.stride(0), dt.data_ptr(), dt.stride(0),
             conv_w.data_ptr(), conv_b.data_ptr(), conv_state.data_ptr(),
             dt_bias.data_ptr(), A_log.data_ptr(), D.data_ptr(),
             state.data_ptr(), _advance("ssm_decode_step", advance, B),
             y.data_ptr(), counts.data_ptr(), B, H, P, N, _stream(xbc))
    build.check(err, "ssm_decode_step")
    ssm_decode_step.launches += 1
    return y


ssm_decode_step.launches = 0


# -- the chunked SSD scan -----------------------------------------------------
def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX ``ssd_chunked``: x (B, S, H, P), dt (B, S, H) positive, A
    (H,) negative, Bm and Cm (B, S, N) → (y (B, S, H, P) in x's dtype,
    the final f32 state (B, H, P, N)). Chunks of ``chunk`` positions,
    halved until they divide S, in the segment-sum form. The intra-chunk
    terms of all chunks are computed at once; only the carried state
    walks the chunks in order (the JAX ``lax.scan`` body, the same sums
    per chunk), so a short chunk costs a few launches, not a dozen."""
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    while S % Q:
        Q //= 2
    nc = S // Q
    xf = x.float().reshape(Bb, nc, Q, H, P)
    dtf = dt.float().reshape(Bb, nc, Q, H)
    Bf = Bm.float().reshape(Bb, nc, Q, N)
    Cf = Cm.float().reshape(Bb, nc, Q, N)
    L = torch.cumsum(dtf * A.float(), dim=2)                 # (B, nc, Q, H)
    CB = torch.einsum("bcqn,bckn->bcqk", Cf, Bf)
    diff = L[:, :, :, None, :] - L[:, :, None, :, :]        # (B, nc, Q, Q, H)
    tril = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    M = torch.where(tril[:, :, None], torch.exp(diff),
                    torch.zeros((), device=x.device))
    M = M * (CB[..., None] * dtf[:, :, None, :, :])
    y = torch.einsum("bcqkh,bckhp->bcqhp", M, xf)           # y_intra
    w_end = torch.exp(L[:, :, -1:, :] - L) * dtf             # decay_to_end dt
    eL = torch.exp(L)[..., None]
    gamma = torch.exp(L[:, :, -1])[..., None, None]          # (B, nc, H, 1, 1)
    s = (torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    for c in range(nc):
        y[:, c] += torch.einsum("bqn,bhpn->bqhp", Cf[:, c], s) * eL[:, c]
        s = s * gamma[:, c] + torch.einsum("bqh,bqn,bqhp->bhpn", w_end[:, c],
                                           Bf[:, c], xf[:, c])
    return y.reshape(Bb, S, H, P).to(x.dtype), s


def ssd_prefill_plain(xbc: torch.Tensor, dt: torch.Tensor,
                      dt_bias: torch.Tensor, A_log: torch.Tensor,
                      D: torch.Tensor, state: torch.Tensor,
                      carry: bool = True, chunk: int = 256) -> torch.Tensor:
    """The JAX ``ssm_forward``'s scan and D skip (ssm.py:135-141)."""
    B, S = xbc.shape[:2]
    H, P, N = _check_ssd("ssd_prefill", xbc, dt, (dt_bias, A_log, D), state)
    xs, Bm, Cm = _split(xbc, H, P, N)
    dtp = softplus(dt.float() + dt_bias.float())
    A = -torch.exp(A_log.float())
    y, final = ssd_chunked(xs, dtp, A, Bm, Cm, chunk,
                           init_state=state if carry else None)
    y = y + xs.to(y.dtype) * D.to(y.dtype)[None, None, :, None]
    state.copy_(final)
    return y.reshape(B, S, H * P)


def split3(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """The scan kernel's split of an f32 operand into three bf16 parts,
    hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid): 24
    significant bits, so hi + mid + lo == v for a normal f32 v (each
    difference is exact), and a product with a bf16 operand taken as the
    three products summed in f32 is as exact as the f32 product."""
    hi = v.to(torch.bfloat16)
    r = v - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def scan_launches(S: int) -> int:
    """The kernel launches of one ``ssd_prefill`` call over S positions on
    the card: ``SCAN_KERNELS`` for each slice of ``SCAN_SLICE`` chunks."""
    return SCAN_KERNELS * -(-S // (SCAN_CHUNK * SCAN_SLICE))


def ssd_prefill(xbc: torch.Tensor, dt: torch.Tensor, dt_bias: torch.Tensor,
                A_log: torch.Tensor, D: torch.Tensor, state: torch.Tensor,
                carry: bool = True, chunk: int = 256) -> torch.Tensor:
    """xbc (B, S, H P + 2 N), dt (B, S, H) → y (B, S, H P); the final f32
    state goes into ``state`` (B, H, P, N). ``chunk`` is the plain
    version's (the kernel's is ``SCAN_CHUNK``). On the card one call is
    ``scan_launches(S)`` launches, through f32 scratch for the incoming
    states of one slice's chunks (at most ``SCAN_SLICE`` a sequence: 21 MB
    a sequence at mamba2-2.7b's widths, whatever S)."""
    if xbc.device.type == "cpu":
        return ssd_prefill_plain(xbc, dt, dt_bias, A_log, D, state, carry,
                                 chunk)
    B, S = xbc.shape[:2]
    H, P, N = _check_ssd("ssd_prefill", xbc, dt, (dt_bias, A_log, D), state)
    _check_cuda("ssd_prefill", xbc, dt, dt_bias, A_log, D, state)
    _bf16("ssd_prefill", xbc, dt, dt_bias, A_log, D)
    _require(P == SCAN_HEAD_DIM and N % 8 == 0 and N <= MAX_STATE
             and state.is_contiguous(),
             f"ssd_prefill: the kernel takes P {SCAN_HEAD_DIM} (got {P}), N "
             f"a multiple of 8 up to {MAX_STATE} (got {N}) and a contiguous "
             "state")
    _require(xbc.data_ptr() % 16 == 0 and xbc.stride(0) % 8 == 0
             and xbc.stride(1) % 8 == 0,
             "ssd_prefill: xbc's rows must be 16-byte aligned")
    depth = min(-(-S // SCAN_CHUNK), SCAN_SLICE)
    y = torch.empty((B, S, H * P), dtype=xbc.dtype, device=xbc.device)
    states = torch.empty((B, depth, H, P, N), dtype=torch.float32,
                         device=xbc.device)
    fn = build.function("ssm", "ssd_prefill", _SCAN_ARGS)
    err = fn(xbc.data_ptr(), xbc.stride(0), xbc.stride(1), dt.data_ptr(),
             dt.stride(0), dt.stride(1), dt_bias.data_ptr(), A_log.data_ptr(),
             D.data_ptr(), state.data_ptr(), states.data_ptr(), y.data_ptr(),
             B, S, H, P, N, int(carry), SCAN_SLICE, _stream(xbc))
    build.check(err, "ssd_prefill")
    ssd_prefill.launches += 1
    return y


ssd_prefill.launches = 0


# -- the gated RMSNorm --------------------------------------------------------
def gated_rmsnorm_plain(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                        eps: float = 1e-6) -> torch.Tensor:
    """``layers.rmsnorm(y * silu(z), w, eps)`` (ssm.py:143, :173)."""
    return rmsnorm_plain(y * F.silu(z), w, eps)


def norm_plan(d: int) -> int:
    """Run-warps a CTA of the gated norm kernel for rows of d: the d / 8
    16-byte runs in run-warps of 32, one CTA a row, a thread a run. It
    fixes the order of the row's sum (``gated_rmsnorm_planned``) from d
    alone."""
    return -(-(d // 8) // 32)


def gated_rmsnorm_planned(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                          eps: float = 1e-6) -> torch.Tensor:
    """The gated norm kernel's order of sums in f32, from ``norm_plan(d)``:
    g = y * silu(z) in y's dtype; each run's 8 squares in order, a
    run-warp's 32 runs pairwise by lane bit 4, 3, 2, 1, 0, then the CTA's
    run-warp sums (zeros past them, 32 in all) pairwise the same way; then
    g * rsqrt(sum / d + eps) * w, rounded once. Row by row: a row's bits
    do not depend on the others."""
    d = y.shape[-1]
    per = norm_plan(d)
    g = (y * F.silu(z)).float().reshape(-1, d)
    M = g.shape[0]
    sq = torch.zeros((M, per * 32 * 8), dtype=torch.float32)
    sq[:, :d] = g * g
    sq = sq.view(M, per, 32, 8)
    ss = sq[..., 0]
    for j in range(1, 8):
        ss = ss + sq[..., j]
    for h in (16, 8, 4, 2, 1):
        ss = ss[..., :h] + ss[..., h:2 * h]
    part = torch.zeros((M, 32), dtype=torch.float32)
    part[:, :per] = ss[..., 0]
    for h in (16, 8, 4, 2, 1):
        part = part[..., :h] + part[..., h:2 * h]
    r = torch.rsqrt(part[:, 0] / d + eps)
    return (g * r[:, None] * w.float()).to(y.dtype).reshape(y.shape)


def gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """y (..., d) and z (..., d) (rows of z may be strided), w (d,) → y's
    shape and dtype."""
    d = y.shape[-1]
    _require(z.shape == y.shape and tuple(w.shape) == (d,),
             f"gated_rmsnorm: y {tuple(y.shape)}, z {tuple(z.shape)}, w "
             f"{tuple(w.shape)}")
    if y.device.type == "cpu":
        return gated_rmsnorm_plain(y, z, w, eps)
    _check_cuda("gated_rmsnorm", y, z, w)
    _bf16("gated_rmsnorm", y, z, w)
    y2 = y.reshape(-1, d)
    z2 = z.reshape(-1, d)
    out = torch.empty_like(y2)
    _require(y2.is_contiguous() and z2.stride(-1) == 1 and d % 8 == 0
             and d <= NORM_MAX_D and z2.stride(0) % 8 == 0
             and all(t.data_ptr() % 16 == 0 for t in (y2, z2, w, out)),
             f"gated_rmsnorm: the kernel takes a contiguous y, z rows at a "
             f"stride that is a multiple of 8, d a multiple of 8 up to "
             f"{NORM_MAX_D} (got {d}) and 16-byte aligned rows")
    if y2.shape[0]:
        fn = build.function("ssm", "gated_rmsnorm", _NORM_ARGS)
        err = fn(y2.data_ptr(), z2.data_ptr(), z2.stride(0), w.data_ptr(),
                 out.data_ptr(), y2.shape[0], d, float(eps), norm_plan(d),
                 _stream(y))
        build.check(err, "gated_rmsnorm")
        gated_rmsnorm.launches += 1
    return out.reshape(y.shape)


gated_rmsnorm.launches = 0
