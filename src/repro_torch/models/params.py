"""Parameter specs and seeded initialization.

Each model builds a nested dict (and, for the layer stack, a list) of
:class:`ParamSpec`; ``init_params`` turns it into tensors drawn from an
explicit ``torch.Generator``, with the JAX package's std rules
(``models/params.py``): ``fan_out`` for the embedding, ``fan_in`` for
the other matrices, ones for norms, zeros for biases, and 4.0 for the
RG-LRU's ``a_param`` (``small_a``). A
``torch.Generator`` does not give JAX's random bits, so tests that
compare the two packages draw the JAX parameters and carry them over
with ``repro_torch.bridge``.

``leaf`` (optional) maps each drawn tensor, with its path in the tree
(``"/layers/3/attn/wqkv/w"``, the path ``quantize_tree`` walks), to what
the tree keeps: ``Model.init`` quantizes each matrix there as soon as it
is drawn, so the whole float tree never exists. The draws keep their
order whatever ``leaf`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "normal"              # normal | ones | zeros | fan_out | small_a


def init_params(specs, generator: torch.Generator, *,
                dtype: torch.dtype = torch.bfloat16,
                device: Union[str, torch.device, None] = None,
                leaf: Optional[Callable[[str, torch.Tensor], object]] = None):
    """Tensors for a spec tree, on ``device`` (default: the card), each
    passed through ``leaf(path, tensor)`` when given. ``generator`` must
    live on the same device."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, params go "
                         f"to {dev}: make the generator on the same device")

    def make(spec: ParamSpec) -> torch.Tensor:
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=dev)
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=dev)
        if spec.init == "small_a":
            # the RG-LRU recurrence parameter: a constant logit, as the
            # JAX params.py draws it (no random bits)
            return torch.full(spec.shape, 4.0, dtype=dtype, device=dev)
        if spec.init == "fan_out":
            # embeddings: std 1/sqrt(d_model) so the tied unembedding
            # gives O(1) logits
            std = spec.shape[-1] ** -0.5
        else:
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            std = fan_in ** -0.5
        w = torch.randn(spec.shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return w.mul_(std).to(dtype)

    def walk(node, path: str):
        if isinstance(node, ParamSpec):
            t = make(node)
            return t if leaf is None else leaf(path, t)
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in node.items()}
        return [walk(v, f"{path}/{i}") for i, v in enumerate(node)]

    return walk(specs, "")
