"""The dispatch point between the port's kernels and plain matrix
products (the counterpart of the JAX package's ``kernels/ops.py``).

- ``matmul``: a ``QuantizedTensor`` weight goes to ``quant_matmul``
  (the hand-written kernel on the card, its plain version on the CPU);
  a plain weight goes to the library matrix product, as the JAX package
  leaves it to XLA — with bf16 operands, f32 accumulation and one cast
  to ``out_dtype``. The tied unembedding asks for f32 logits: on the
  card ``torch.mm(..., out_dtype=torch.float32)``, on the CPU an f32
  product of the bf16 values (rounding the logits to bf16 would flip
  greedy tokens against the JAX package).
- ``attention``: prefill attention in the (B, H, S, D) layout, the
  ``flash_attention`` kernel's wrapper. There is no ``use_pallas``
  switch and no tile picking: the kernel takes every Sq and Skv.
- ``decode_attention`` / ``decode_attention_quant``: the kernels'
  wrappers, which take the plain version only for CPU tensors.
- ``quant_matmul_swiglu``: the FFN's gate-up product with the SwiGLU as
  its last step, for a quantized ``w_gate_up`` (``models/mlp.py``); a
  plain ``w_gate_up`` takes ``matmul`` and then ``swiglu``.
- ``rmsnorm``, ``add_rmsnorm``, ``swiglu``, ``rope_cache_write`` and
  ``rope_cache_write_prefill``: the fused small ops of ``fused_ops.py``,
  wrappers of the same kind.
- ``launch_counts``: every kernel wrapper's launch count by name. A
  wrapper counts the launches it enqueues, also into a CUDA graph being
  captured; a graph's replays launch again without counting.

There is no backend switch and no fallback: a CUDA tensor reaches the
kernel or the wrapper raises. The TPU lane-alignment tiling rules of
the JAX ``ops.matmul`` do not carry over; the CUDA kernels take every
shape on the path and mask ragged edges themselves.

Reduced-precision reductions in cuBLAS bf16 products are turned off
here (``allow_bf16_reduced_precision_reduction = False``) and TF32 is
left off, so the library products accumulate in full f32 like XLA's
``preferred_element_type=f32`` dots.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.decode_attention_quant import decode_attention_quant
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_ops import (add_rmsnorm, rmsnorm,
                                           rope_cache_write,
                                           rope_cache_write_prefill, swiglu)
from repro_torch.kernels.quant_matmul import quant_matmul, quant_matmul_swiglu
from repro_torch.quant.quantize import QuantizedTensor

torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

KERNELS = (decode_attention, decode_attention_quant, quant_matmul,
           quant_matmul_swiglu, flash_attention, rmsnorm, add_rmsnorm, swiglu,
           rope_cache_write, rope_cache_write_prefill)

__all__ = ["matmul", "attention", "decode_attention",
           "decode_attention_quant", "flash_attention", "quant_matmul",
           "quant_matmul_swiglu", "rmsnorm", "add_rmsnorm", "swiglu",
           "rope_cache_write", "rope_cache_write_prefill", "KERNELS",
           "launch_counts"]


def launch_counts() -> Dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}


def matmul(x: torch.Tensor, w: Union[torch.Tensor, QuantizedTensor], *,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x @ w for plain or quantized (K, N) weights; x's leading dims are
    flattened into M."""
    out_dtype = out_dtype or x.dtype
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    if isinstance(w, QuantizedTensor):
        y = quant_matmul(x2, w, out_dtype=out_dtype)
    elif x.is_cuda:
        w = w.to(x.dtype)
        y = (torch.mm(x2, w) if out_dtype == x.dtype
             else torch.mm(x2, w, out_dtype=out_dtype))
    else:
        y = torch.matmul(x2.float(), w.float()).to(out_dtype)
    return y.reshape(*lead, y.shape[-1])


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              q_offset: int = 0) -> torch.Tensor:
    """Prefill attention; q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D)."""
    return flash_attention(q, k, v, causal=causal, window=window,
                           q_offset=q_offset)
