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

``quant_matmul_plain`` is the plain PyTorch version, the JAX package's
XLA path: dequantize to the activation dtype, multiply in f32, cast to
``out_dtype``. The wrapper runs it for CPU tensors only; a CUDA tensor
always goes through the kernel, or the wrapper raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.quant.quantize import QuantizedTensor, dequantize

FORMATS = {"q8_0": 0, "q4_0": 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)


def quant_matmul_plain(x: torch.Tensor, w: QuantizedTensor,
                       out_dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """x (M, K) @ dequant(w) (K, N) → (M, N) in ``out_dtype``."""
    out_dtype = out_dtype or x.dtype
    wd = dequantize(w, x.dtype)
    return torch.matmul(x.float(), wd.float()).to(out_dtype)


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


def quant_matmul(x: torch.Tensor, w: QuantizedTensor,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x (M, K) bf16 @ dequant(w) → (M, N) in ``out_dtype`` (default
    x's dtype). w: q8_0 data (K, N) or q4_0 data (K // 2, N) int8,
    scales (K // group, N) bf16."""
    out_dtype = out_dtype or x.dtype
    M, K = x.shape
    Kw, N = w.logical_shape
    if K != Kw:
        raise ValueError(f"quant_matmul: x has K={K} but the weight "
                         f"{w.logical_shape} has K={Kw}")
    if w.fmt not in FORMATS:
        raise ValueError(f"quant_matmul: unknown format {w.fmt!r}")
    if K % w.group:
        raise ValueError(f"quant_matmul: K={K} is not a multiple of the "
                         f"group {w.group}")
    if x.device.type == "cpu":
        return quant_matmul_plain(x, w, out_dtype)
    if x.dtype != torch.bfloat16 or out_dtype not in (torch.bfloat16,
                                                      torch.float32):
        raise ValueError(f"quant_matmul kernel takes bf16 x and a bf16 or "
                         f"f32 out_dtype, got {x.dtype} -> {out_dtype}")
    if (w.data.dtype != torch.int8 or w.scales.dtype != torch.bfloat16
            or tuple(w.scales.shape) != (K // w.group, N)):
        raise ValueError("quant_matmul: payload must be int8 and scales "
                         f"bf16 ({K // w.group}, {N})")
    for t in (x, w.data, w.scales):
        if not (t.is_cuda and t.device == x.device):
            raise ValueError("quant_matmul: all inputs must be on x's "
                             "CUDA device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("quant_matmul: inputs must be contiguous "
                             "and 16-byte aligned")
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    ws = _workspace(M, K, N, w.group)
    if ws < 0:
        raise ValueError(f"quant_matmul.cu does not take group {w.group} "
                         f"at K={K}")
    partial = (torch.empty((ws,), dtype=torch.float32, device=x.device)
               if ws else None)
    fn = build.function("quant_matmul", "quant_matmul", _ARGTYPES)
    err = fn(FORMATS[w.fmt], x.data_ptr(), w.data.data_ptr(),
             w.scales.data_ptr(), out.data_ptr(),
             partial.data_ptr() if ws else None, ws,
             int(out_dtype == torch.float32), M, K, N, w.group,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f"quant_matmul[{w.fmt}]")
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0
