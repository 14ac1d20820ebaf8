"""The RG-LRU recurrence of the hybrid family (recurrentgemma,
``csrc/rglru.cu``): the prefill scan over a whole prompt and the decode
step of one token.

No Pallas kernel of the JAX package stands behind them: its
``models/hybrid.py`` computes the gates, the recurrence (an associative
scan in the prefill) and the gelu-gated output with ``jnp`` outside any
kernel. Each kernel here is one launch; the design is described in the
source.

Both take the layer's tensors as the model hands them over: x, the causal
conv's output (B, [S,] w); gx, the products of ``wa`` and ``wx`` side by
side in one row, [x wa | x wx] (B, [S,] 2w), without their biases; the
gate, a column view of ``in_proj``'s output (B, [S,] w); the biases ``ba``,
``bx`` and ``a_param`` (w,); and the layer's f32 state (B, w), updated in
place. Per channel, with the JAX layer's rounding points:

    r = sigmoid(gx_a + ba), i = sigmoid(gx_x + bx)  (each add and sigmoid
                                                     rounded to x's dtype)
    a = exp(-8 softplus(a_param) r)                 (f32)
    h_t = a h_(t-1) + sqrt(max(1 - a^2, 1e-12)) xg  (f32)
    y_t = h_t gelu(gate_t)                          (gelu in f32, y in x's
                                                     dtype)

with xg = x i in f32 in the prefill (the JAX ``rglru_forward``) and
rounded to x's dtype at decode (the JAX ``rglru_decode``).

- ``rglru_scan(x, gx, gate, ba, bx, a_param, state)``: the recurrence
  over S positions from zeros (a prompt's start), → y (B, S, w). The state
  becomes the last position's y, not its h: the JAX ``Model.prefill``
  stores the gated output of the last position as the layer's state
  (``hybrid.py:89-90``), and the port keeps that reference behaviour. The
  plain version runs the recurrence in the kernel's sequential order; the
  JAX prefill's associative scan sums in another order, so the two differ
  in f32 rounding only.
- ``rglru_decode_step(x, gx, gate, ba, bx, a_param, state, advance)``: one
  step, → y (B, w); the rows where ``advance`` (B,) bool is False keep
  their state bit for bit.

The kernels take bf16 activations and parameters, channel-contiguous rows
(any row strides) and an f32 state; the wrappers raise otherwise. Each
``*_plain`` function is the plain PyTorch version; a wrapper runs it for
CPU tensors only, and a CUDA tensor reaches the kernel or the wrapper
raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_ops import gelu
from repro_torch.kernels.ssm import softplus

DECAY_C = 8.0                # the RG-LRU decay sharpness (the JAX _C)
SCAN_CHANNELS = 32           # a scan CTA's channels (a warp's lanes)
SCAN_THREADS = 544           # its threads: the chain warp and 16 producers
STEP_THREADS = 256           # the decode step's threads a CTA

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SCAN_ARGS = (_P, _L, _L, _P, _L, _L, _P, _L, _L, _P, _P, _P, _P, _P, _I, _I,
              _I, _P)
_STEP_ARGS = (_P, _L, _P, _L, _P, _L, _P, _P, _P, _P, _P, _P, _I, _I, _P)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def scan_grid(B: int, W: int) -> Tuple[int, int]:
    """The scan kernel's grid: (CTAs along the channels, B)."""
    return (-(-W // SCAN_CHANNELS), B)


def step_grid(B: int, W: int) -> Tuple[int, int]:
    """The decode step's grid: (CTAs along the channels, B)."""
    return (-(-W // STEP_THREADS), B)


def gates_plain(gx: torch.Tensor, ba: torch.Tensor, bx: torch.Tensor,
                a_param: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a f32, i in gx's dtype) from [x wa | x wx] (..., 2w): the JAX
    ``_gates`` after its two biased linears."""
    w = a_param.shape[-1]
    dt = gx.dtype
    r = torch.sigmoid((gx[..., :w] + ba.to(dt)).float()).to(dt)
    i = torch.sigmoid((gx[..., w:] + bx.to(dt)).float()).to(dt)
    log_a = -DECAY_C * softplus(a_param.float())
    return torch.exp(log_a * r.float()), i


def _decay_input(a: torch.Tensor, xg: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * xg


def linear_scan(a: torch.Tensor, x_gated: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_(t-1) + sqrt(max(1 - a_t^2, 1e-12)) x_t over axis 1 of
    (B, S, w), in f32, sequentially from zeros: the function of the JAX
    ``hybrid.rglru_scan`` (whose associative scan sums in another order)
    and the scan kernel's order."""
    a = a.float()
    b = _decay_input(a, x_gated.float())
    h = torch.zeros_like(b[:, 0])
    hs = torch.empty_like(b)
    for t in range(b.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs[:, t] = h
    return hs


def rglru_scan_plain(x: torch.Tensor, gx: torch.Tensor, gate: torch.Tensor,
                     ba: torch.Tensor, bx: torch.Tensor, a_param: torch.Tensor,
                     state: torch.Tensor) -> torch.Tensor:
    a, i = gates_plain(gx, ba, bx, a_param)
    hs = linear_scan(a, x.float() * i.float())
    y = (hs * gelu(gate.float())).to(x.dtype)
    state.copy_(y[:, -1].float())
    return y


def _check(what: str, x: torch.Tensor, gx: torch.Tensor, gate: torch.Tensor,
           vectors, state: torch.Tensor, advance: Optional[torch.Tensor]
           ) -> None:
    w = x.shape[-1]
    _require(gx.shape[:-1] == x.shape[:-1] and gx.shape[-1] == 2 * w
             and gate.shape == x.shape
             and all(tuple(v.shape) == (w,) for v in vectors)
             and tuple(state.shape) == (x.shape[0], w)
             and state.dtype == torch.float32,
             f"{what}: x {tuple(x.shape)}, gx {tuple(gx.shape)}, gate "
             f"{tuple(gate.shape)}, state {tuple(state.shape)} "
             f"{state.dtype}")
    if x.device.type == "cpu":
        return
    dev = x.device
    for t in (x, gx, gate, *vectors, state):
        _require(t.is_cuda and t.device == dev,
                 f"{what}: all inputs must be on one CUDA device")
        _require(t.stride(-1) == 1, f"{what}: the channels must be "
                 "contiguous")
    _require(all(t.dtype == torch.bfloat16 for t in (x, gx, gate, *vectors)),
             f"{what} kernel takes bf16 activations and parameters, got "
             f"{[t.dtype for t in (x, gx, gate, *vectors)]}")
    _require(state.is_contiguous(), f"{what}: the state must be contiguous")
    if advance is not None:
        _require(advance.is_cuda and advance.device == dev
                 and advance.dtype == torch.bool
                 and tuple(advance.shape) == (x.shape[0],)
                 and advance.is_contiguous(),
                 f"{what}: advance must be a contiguous bool ({x.shape[0]},) "
                 "on the card")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def rglru_scan(x: torch.Tensor, gx: torch.Tensor, gate: torch.Tensor,
               ba: torch.Tensor, bx: torch.Tensor, a_param: torch.Tensor,
               state: torch.Tensor) -> torch.Tensor:
    """x (B, S, w), gx (B, S, 2w), gate (B, S, w), ba, bx, a_param (w,),
    state (B, w) f32 → y (B, S, w); the state is written in place (see
    the module docstring)."""
    _check("rglru_scan", x, gx, gate, (ba, bx, a_param), state, None)
    if x.device.type == "cpu":
        return rglru_scan_plain(x, gx, gate, ba, bx, a_param, state)
    B, S, W = x.shape
    y = torch.empty((B, S, W), dtype=x.dtype, device=x.device)
    if B == 0 or S == 0:
        return y
    fn = build.function("rglru", "rglru_scan", _SCAN_ARGS)
    err = fn(x.data_ptr(), x.stride(0), x.stride(1), gx.data_ptr(),
             gx.stride(0), gx.stride(1), gate.data_ptr(), gate.stride(0),
             gate.stride(1), ba.data_ptr(), bx.data_ptr(), a_param.data_ptr(),
             state.data_ptr(), y.data_ptr(), B, S, W, _stream(x))
    build.check(err, "rglru_scan")
    rglru_scan.launches += 1
    return y


rglru_scan.launches = 0


def rglru_decode_step_plain(x: torch.Tensor, gx: torch.Tensor,
                            gate: torch.Tensor, ba: torch.Tensor,
                            bx: torch.Tensor, a_param: torch.Tensor,
                            state: torch.Tensor,
                            advance: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    a, i = gates_plain(gx, ba, bx, a_param)
    h = a * state + _decay_input(a, (x * i).float())
    y = (h * gelu(gate.float())).to(x.dtype)
    if advance is None:
        state.copy_(h)
    else:
        state.copy_(torch.where(advance[:, None], h, state))
    return y


def rglru_decode_step(x: torch.Tensor, gx: torch.Tensor, gate: torch.Tensor,
                      ba: torch.Tensor, bx: torch.Tensor,
                      a_param: torch.Tensor, state: torch.Tensor,
                      advance: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, w), gx (B, 2w), gate (B, w), ba, bx, a_param (w,), state
    (B, w) f32, advance (B,) bool or None → y (B, w); the state is
    updated in place where ``advance`` is set."""
    _check("rglru_decode_step", x, gx, gate, (ba, bx, a_param), state,
           advance)
    if x.device.type == "cpu":
        return rglru_decode_step_plain(x, gx, gate, ba, bx, a_param, state,
                                       advance)
    B, W = x.shape
    y = torch.empty((B, W), dtype=x.dtype, device=x.device)
    if B == 0:
        return y
    fn = build.function("rglru", "rglru_decode_step", _STEP_ARGS)
    err = fn(x.data_ptr(), x.stride(0), gx.data_ptr(), gx.stride(0),
             gate.data_ptr(), gate.stride(0), ba.data_ptr(), bx.data_ptr(),
             a_param.data_ptr(), state.data_ptr(),
             None if advance is None else advance.data_ptr(), y.data_ptr(),
             B, W, _stream(x))
    build.check(err, "rglru_decode_step")
    rglru_decode_step.launches += 1
    return y


rglru_decode_step.launches = 0
