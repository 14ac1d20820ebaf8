"""Carry the JAX package's parameters and caches over to the port.

The JAX side hands its trees over with every array turned into numpy
(``jax.tree_util.tree_map(np.asarray, tree)``). This module imports
neither JAX nor the JAX package:

- bf16 arrays (numpy dtype name ``"bfloat16"``) are reinterpreted bit for
  bit, ``arr.view(np.uint16)`` → ``torch.from_numpy(...).view(torch.bfloat16)``;
- a quantized leaf is recognised by its attributes (``data``,
  ``scales``, ``fmt``, ``group``) and becomes a ``QuantizedTensor``;
- the JAX stacked layer leaves (L, ...) under ``"layers"`` are split
  into the port's list of per-layer dicts;
- a cache's stacked per-layer ``lens`` (L, B), equal across layers,
  becomes the port's single ``lens`` (B,).
"""
from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.quant.quantize import QuantizedTensor


def to_tensor(arr, device: torch.device) -> torch.Tensor:
    arr = np.array(arr)             # a writable copy for torch.from_numpy
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def _is_quantized(leaf) -> bool:
    # (an ndarray has a .data buffer too, so arrays are ruled out first)
    return not isinstance(leaf, np.ndarray) and all(
        hasattr(leaf, a) for a in ("data", "scales", "fmt", "group"))


def _convert(node, device: torch.device):
    if _is_quantized(node):
        return QuantizedTensor(to_tensor(node.data, device),
                               to_tensor(node.scales, device),
                               node.fmt, int(node.group))
    if isinstance(node, dict):
        return {k: _convert(v, device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_convert(v, device) for v in node]
    return to_tensor(node, device)


def _split_layers(tree) -> list:
    """Stacked (L, ...) leaves → a list of L trees of (...) leaves."""
    def num_layers(node):
        if isinstance(node, QuantizedTensor):
            return node.data.shape[0]
        if isinstance(node, dict):
            return num_layers(next(iter(node.values())))
        return node.shape[0]

    def take(node, i):
        if isinstance(node, QuantizedTensor):
            return QuantizedTensor(node.data[i].contiguous(),
                                   node.scales[i].contiguous(),
                                   node.fmt, node.group)
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        return node[i].contiguous()

    return [take(tree, i) for i in range(num_layers(tree))]


def from_jax(tree: Dict[str, Any],
             device: Union[str, torch.device, None] = None) -> Dict:
    """The JAX package's dense-model params, or its dense KV cache, with
    numpy leaves → the port's params or cache on ``device`` (default:
    the card)."""
    dev = resolve_device(device)
    out = _convert(tree, dev)
    lens = out["layers"].pop("lens", None)
    out["layers"] = _split_layers(out["layers"])
    if lens is not None:
        if not bool((lens == lens[0]).all()):
            raise ValueError("per-layer cache lens differ; the port keeps "
                             "one lens for all layers")
        out["lens"] = lens[0].to(torch.int32).contiguous()
    return out
