"""Parameter specs and seeded initialization.

Each model builds a nested dict (and, for the layer stack, a list) of
:class:`ParamSpec`; ``init_params`` turns it into tensors drawn from an
explicit ``torch.Generator``, with the JAX package's std rules
(``models/params.py``): ``fan_out`` for the embedding, ``fan_in`` for
the other matrices, ones for norms. A ``torch.Generator`` does not give
JAX's random bits, so tests that compare the two packages draw the
JAX parameters and carry them over with ``repro_torch.bridge``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "normal"              # normal | ones | fan_out


def init_params(specs, generator: torch.Generator, *,
                dtype: torch.dtype = torch.bfloat16,
                device: Union[str, torch.device, None] = None):
    """Tensors for a spec tree, on ``device`` (default: the card).
    ``generator`` must live on the same device."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, params go "
                         f"to {dev}: make the generator on the same device")

    def make(spec: ParamSpec) -> torch.Tensor:
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=dev)
        if spec.init == "fan_out":
            # embeddings: std 1/sqrt(d_model) so the tied unembedding
            # gives O(1) logits
            std = spec.shape[-1] ** -0.5
        else:
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            std = fan_in ** -0.5
        w = torch.randn(spec.shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return (w * std).to(dtype)

    def walk(node):
        if isinstance(node, ParamSpec):
            return make(node)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return [walk(v) for v in node]

    return walk(specs)
