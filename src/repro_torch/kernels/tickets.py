"""The int32 ticket counts that a kernel's CTAs take in turn, so that the
last to finish one piece of work (decode attention's split merge, the SSM
decode step's conv-state write, the one-launch MoE route) knows it is the
last, without waiting on the others.

Each kernel leaves the counts it used at zero when its launch ends, so
launches on one stream, which run one after another, share one set of
counts; each stream has its own, so launches on two streams at once never
share a count.
"""
from __future__ import annotations

import torch

_TICKETS = {}                  # (device, stream) -> int32 ticket counts
_OUTGROWN = []                 # ticket counts replaced by larger ones


def tickets(n: int, device) -> torch.Tensor:
    """At least n int32 ticket counts of ``device`` and its current stream
    (stream 0 on the CPU), zero between launches: allocated zeroed once.
    A stream's first counts must not be made inside a CUDA graph's capture
    (the engine's warm-up on its capture stream makes them before); a graph
    keeps its capture stream's counts, so the graphs of one capture stream
    are replayed on one stream. Counts that a larger launch outgrows stay
    allocated: a captured CUDA graph may still hold their address."""
    device = torch.device(device)
    stream = (torch.cuda.current_stream(device).cuda_stream
              if device.type == "cuda" else 0)
    key = (device, stream)
    t = _TICKETS.get(key)
    if t is None and device.type == "cuda" \
            and torch.cuda.is_current_stream_capturing():
        raise ValueError("the stream being captured has no ticket counts "
                         "yet; launch the kernel once on it before the "
                         "capture")
    if t is None or t.numel() < n:
        if t is not None:
            _OUTGROWN.append(t)
        t = torch.zeros((max(n, 256),), dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t
