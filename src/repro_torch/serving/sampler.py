"""Token sampling: greedy / temperature / top-k / top-p.

Counterpart of the JAX package's ``serving/sampler.py``:

- ``sample_batched`` takes per-row (per-slot) parameters, so one decode
  batch serves greedy and stochastic requests side by side. Rows with
  ``temperature <= 0`` are an exact argmax. Top-k is applied before
  top-p, in the same order as the JAX package.
- ``sample`` takes one :class:`SamplingConfig` for every row.

Randomness comes from an explicit ``torch.Generator``. It cannot give
JAX's threefry bits, so stochastic rows agree with the JAX package in
distribution only; greedy rows agree exactly.

``sample_batched`` reads nothing back to the host, so the serving
engine captures it into its CUDA graph (with the generator registered
to the graph). The categorical draw is the one ``torch.multinomial``
makes for a single sample, ``argmax(p / E)`` with E ~ Exp(1) drawn from
the generator, written out: ``torch.multinomial`` first checks the
probabilities on the host, which a captured graph cannot do.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.0    # 0 → greedy
    top_k: int = 0              # 0 → off
    top_p: float = 1.0          # 1 → off


def sample_batched(logits: torch.Tensor, generator: torch.Generator,
                   temperature: torch.Tensor, top_k: torch.Tensor,
                   top_p: torch.Tensor) -> torch.Tensor:
    """logits (B, V) + per-row params (B,) → int32 tokens (B,)."""
    B, V = logits.shape
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    t = temperature.float()
    k = top_k.long()
    p = top_p.float()
    neg_inf = torch.full((), float("-inf"), device=logits.device)
    lf = logits.float() / torch.where(t > 0, t, torch.ones_like(t))[:, None]

    # top-k: the k-th largest per row from one ascending sort
    asc = torch.sort(lf, dim=-1).values
    kth = torch.gather(asc, -1, torch.clamp(V - k, 0, V - 1)[:, None])
    lf = torch.where((k > 0)[:, None] & (lf < kth), neg_inf, lf)

    # top-p over the top-k-filtered logits
    desc = torch.sort(lf, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(desc, dim=-1), dim=-1)
    cutoff_idx = torch.sum(cum < p[:, None], dim=-1)
    cutoff = torch.gather(desc, -1, torch.clamp(cutoff_idx, 0, V - 1)[:, None])
    lf = torch.where((p < 1.0)[:, None] & (lf < cutoff), neg_inf, lf)

    probs = torch.softmax(lf, dim=-1)
    race = torch.empty_like(probs).exponential_(1.0, generator=generator)
    drawn = torch.argmax(probs / race, dim=-1).to(torch.int32)
    return torch.where(t > 0, drawn, greedy)


def sample(logits: torch.Tensor, generator: torch.Generator,
           cfg: SamplingConfig) -> torch.Tensor:
    """logits (B, V) → int32 tokens (B,) under one config."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    B = logits.shape[0]
    dev = logits.device
    return sample_batched(
        logits, generator,
        torch.full((B,), cfg.temperature, device=dev),
        torch.full((B,), cfg.top_k, dtype=torch.int32, device=dev),
        torch.full((B,), cfg.top_p, device=dev))
