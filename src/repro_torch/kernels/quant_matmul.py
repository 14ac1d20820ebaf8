"""W8A16 / W4A16 groupwise dequant GEMM: ``x @ dequant(w)``.

Replaces the JAX package's Pallas kernel ``quant_matmul``
(``src/repro/kernels/quant_matmul.py``: ``_qmm_kernel``,
``_dequant_block_q8`` / ``_dequant_block_q4``) with the CUDA kernel in
``csrc/quant_matmul.cu``: one tensor-core kernel (``mma.sync`` m16n8k16,
bf16 in, f32 accumulate) for every M. At decode M (the number of slots)
it is bound by the weight bytes, K*N*(1 + 2/32) for q8_0 and
K*N*(0.5 + 2/32) for q4_0; at prefill M by the tensor cores' rate. Its
design (weights as the A operand, dequantized into the fragments from a
TMA-fed shared-memory ring, element copies where N % 16 != 0;
activations as the B operand 8 rows at a time; K cut into chunks
planned from the weight's shape and the SM count alone: split across
CTAs with a deterministic second pass
when there is one M tile, walked inside each CTA otherwise, summed in
chunk order either way, so that an output row does not depend on M) is
described in the source. Any M and any N work; the quantization group
must be a multiple of 32 that divides K.

``quant_matmul(x, w, out=view)`` writes the (M, N) result into a view
of a wider row-major buffer (unit column stride, rows ``ldc`` >= N
elements apart): the unfused V0 projections write q, k and v (or g and
u) side by side into one row this way, with no copy after the products.
On the card the view's start and its row pitch must be 16-byte aligned;
any other view raises. The bits are those of the call without ``out=``.

``quant_matmul_swiglu(x, w)`` is the FFN's gate-up product with the
SwiGLU after it as the GEMM's last step: h (M, F) = silu(g) * u of the
halves g, u of ``x @ dequant(w)`` for the fused weight w (K, 2F) =
[gate | up], the JAX package's ``models/mlp.py:42-48``. On the card it
returns the bits of ``swiglu(quant_matmul(x, w))`` without writing the
(M, 2F) product to device memory: the split-K merge applies the SwiGLU
where K is split across CTAs (decode M), and two CTAs of a cluster
combine the gate and up blocks through distributed shared memory where
it is not (prefill M). ``quant_matmul_swiglu(x, w, act="gelu")`` is the
GeGLU form of the same kernel (the activation is a template parameter):
h = gelu(g) * u with the JAX rounding points (gelu rounded to bf16, then
the product), the bits of ``fused_ops.geglu(quant_matmul(x, w))``.

``quant_matmul_plain`` is the plain PyTorch version, the JAX package's
XLA path: dequantize to the activation dtype, multiply in f32, cast to
``out_dtype``; ``quant_matmul_swiglu_plain`` is it followed by
``fused_ops.swiglu_plain`` (or ``geglu_plain``). The wrappers run them
for CPU tensors only; a CUDA tensor always goes through the kernel, or
the wrapper raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_ops import geglu_plain, swiglu_plain
from repro_torch.quant.quantize import QuantizedTensor, dequantize

FORMATS = {"q8_0": 0, "q4_0": 1}
ACTIVATIONS = {"silu": 1, "gelu": 2}    # the gate-up epilogue's, as the C enum

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)
_SWIGLU_ARGTYPES = (_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)


def check_out(name: str, out: torch.Tensor, M: int, N: int,
              dtype: torch.dtype) -> None:
    """Raise unless ``out`` can take an (M, N) ``dtype`` result in place:
    that shape and dtype, unit column stride, rows at least N apart."""
    if (tuple(out.shape) != (M, N) or out.dtype != dtype
            or (N > 1 and out.stride(1) != 1) or out.stride(0) < N):
        raise ValueError(
            f"{name}: out must be an ({M}, {N}) {dtype} row-major view with "
            f"unit column stride, got {tuple(out.shape)} {out.dtype} "
            f"strides {out.stride()}")


def quant_matmul_plain(x: torch.Tensor, w: QuantizedTensor,
                       out_dtype: Optional[torch.dtype] = None,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (M, K) @ dequant(w) (K, N) → (M, N) in ``out_dtype``, written into
    ``out`` when given (a view as ``check_out`` takes)."""
    out_dtype = out_dtype or x.dtype
    if out is not None:
        check_out("quant_matmul", out, x.shape[0], w.logical_shape[1],
                  out_dtype)
    wd = dequantize(w, x.dtype)
    y = torch.matmul(x.float(), wd.float()).to(out_dtype)
    return y if out is None else out.copy_(y)


@functools.lru_cache(maxsize=None)
def _workspace(M: int, K: int, N: int, group: int) -> int:
    """f32 elements of split-K scratch the kernel asks for at this shape
    (its plan lives in the CUDA source): nonzero only with one M tile
    (M <= 128), where K is split across CTAs; -1 for a group it does not
    take. The kernel checks the size again at launch."""
    fn = build.function("quant_matmul", "quant_matmul_workspace",
                        (_I, _I, _I, _I))
    return fn(M, K, N, group)


def launch_grid(M: int, K: int, N: int, group: int):
    """(CTAs, CTAs along K, K chunks) of the kernel at this shape on the
    current device, from the plan in the CUDA source; None for a group
    it does not take."""
    fn = build.function("quant_matmul", "quant_matmul_grid",
                        (_I, _I, _I, _I, _P))
    grid = (ctypes.c_int * 3)()
    return None if fn(M, K, N, group, grid) else tuple(grid)


def _check_shapes(name: str, x: torch.Tensor, w: QuantizedTensor) -> None:
    K, (Kw, _) = x.shape[-1], w.logical_shape
    if K != Kw:
        raise ValueError(f"{name}: x has K={K} but the weight "
                         f"{w.logical_shape} has K={Kw}")
    if w.fmt not in FORMATS:
        raise ValueError(f"{name}: unknown format {w.fmt!r}")
    if K % w.group:
        raise ValueError(f"{name}: K={K} is not a multiple of the "
                         f"group {w.group}")


def _check_cuda(name: str, x: torch.Tensor, w: QuantizedTensor) -> None:
    """The kernel's own conditions on its operands (the CUDA route)."""
    K, N = w.logical_shape
    if (w.data.dtype != torch.int8 or w.scales.dtype != torch.bfloat16
            or tuple(w.scales.shape) != (K // w.group, N)):
        raise ValueError(f"{name}: payload must be int8 and scales "
                         f"bf16 ({K // w.group}, {N})")
    for t in (x, w.data, w.scales):
        if not (t.is_cuda and t.device == x.device):
            raise ValueError(f"{name}: all inputs must be on x's CUDA "
                             "device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be contiguous and "
                             "16-byte aligned")


def _partial(M: int, K: int, N: int, group: int, device) -> Optional[
        torch.Tensor]:
    """The split-K scratch the kernel's plan asks for (None without a
    split); raises for a group the kernel does not take."""
    ws = _workspace(M, K, N, group)
    if ws < 0:
        raise ValueError(f"quant_matmul.cu does not take group {group} "
                         f"at K={K}")
    return (torch.empty((ws,), dtype=torch.float32, device=device)
            if ws else None)


def quant_matmul(x: torch.Tensor, w: QuantizedTensor,
                 out_dtype: Optional[torch.dtype] = None,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (M, K) bf16 @ dequant(w) → (M, N) in ``out_dtype`` (default
    x's dtype). w: q8_0 data (K, N) or q4_0 data (K // 2, N) int8,
    scales (K // group, N) bf16. ``out``: a view to write the result into
    (``check_out``; on the card also a 16-byte-aligned start and row
    pitch), which is returned."""
    out_dtype = out_dtype or x.dtype
    M, K = x.shape
    N = w.logical_shape[1]
    _check_shapes("quant_matmul", x, w)
    if x.device.type == "cpu":
        return quant_matmul_plain(x, w, out_dtype, out)
    if x.dtype != torch.bfloat16 or out_dtype not in (torch.bfloat16,
                                                      torch.float32):
        raise ValueError(f"quant_matmul kernel takes bf16 x and a bf16 or "
                         f"f32 out_dtype, got {x.dtype} -> {out_dtype}")
    _check_cuda("quant_matmul", x, w)
    if out is None:
        out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    else:
        check_out("quant_matmul", out, M, N, out_dtype)
        if (out.device != x.device or out.data_ptr() % 16
                or out.stride(0) * out.element_size() % 16):
            raise ValueError("quant_matmul: out must be on x's device with "
                             "a 16-byte-aligned start and row pitch, got "
                             f"address {out.data_ptr():#x} and row stride "
                             f"{out.stride(0)}")
    if M == 0 or N == 0:
        return out
    partial = _partial(M, K, N, w.group, x.device)
    fn = build.function("quant_matmul", "quant_matmul", _ARGTYPES)
    err = fn(FORMATS[w.fmt], x.data_ptr(), w.data.data_ptr(),
             w.scales.data_ptr(), out.data_ptr(),
             None if partial is None else partial.data_ptr(),
             0 if partial is None else partial.numel(),
             int(out_dtype == torch.float32), M, K, N, out.stride(0),
             w.group, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f"quant_matmul[{w.fmt}]")
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0


def quant_matmul_swiglu_plain(x: torch.Tensor, w: QuantizedTensor,
                              act: str = "silu") -> torch.Tensor:
    """swiglu(x (M, K) @ dequant(w) (K, 2F)) → (M, F) in x's dtype: the
    product rounded to x's dtype, then silu(g) * u in f32 with one
    rounding; with ``act`` "gelu" the GeGLU, ``geglu_plain``."""
    gu = quant_matmul_plain(x, w)
    return geglu_plain(gu) if act == "gelu" else swiglu_plain(gu)


def quant_matmul_swiglu(x: torch.Tensor, w: QuantizedTensor,
                        act: str = "silu") -> torch.Tensor:
    """x (M, K) bf16, w the fused gate-up weight (K, 2F) in q8_0 / q4_0
    → h (M, F) bf16, bit-equal on the card to ``swiglu(quant_matmul(x,
    w))``, or with ``act`` "gelu" to ``geglu(quant_matmul(x, w))``."""
    M, K = x.shape
    N = w.logical_shape[1]
    if N % 2:
        raise ValueError(f"quant_matmul_swiglu: odd gate-up width {N}")
    if act not in ACTIVATIONS:
        raise ValueError(f"quant_matmul_swiglu: act must be one of "
                         f"{sorted(ACTIVATIONS)}, got {act!r}")
    _check_shapes("quant_matmul_swiglu", x, w)
    if x.device.type == "cpu":
        return quant_matmul_swiglu_plain(x, w, act)
    if x.dtype != torch.bfloat16:
        raise ValueError("quant_matmul_swiglu kernel takes bf16 x (and "
                         f"writes bf16 h), got {x.dtype}")
    _check_cuda("quant_matmul_swiglu", x, w)
    F = N // 2
    out = torch.empty((M, F), dtype=torch.bfloat16, device=x.device)
    if M == 0 or F == 0:
        return out
    partial = _partial(M, K, N, w.group, x.device)
    fn = build.function("quant_matmul", "quant_matmul_swiglu",
                        _SWIGLU_ARGTYPES)
    err = fn(ACTIVATIONS[act], FORMATS[w.fmt], x.data_ptr(),
             w.data.data_ptr(), w.scales.data_ptr(), out.data_ptr(),
             None if partial is None else partial.data_ptr(),
             0 if partial is None else partial.numel(), M, K, F, w.group,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f"quant_matmul_swiglu[{w.fmt}, {act}]")
    quant_matmul_swiglu.launches += 1
    return out


quant_matmul_swiglu.launches = 0
