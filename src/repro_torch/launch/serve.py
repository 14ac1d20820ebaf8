"""Serving CLI: build a model with seeded random weights, serve a
synthetic batch of requests through the continuous-batching engine and
print throughput.

    python -m repro_torch.launch.serve --arch llama3.2-1b --no-reduced \\
        --precision q8_0

Runs on the card by default (``--device cpu`` for a CPU run). On the
card the warmup request also captures the engine's megastep graph, so
every megastep of the timed run is one graph replay. ``--page-size``
pages the KV cache (``--cache-blocks`` sizes its pool), and
``--prefix-cache`` shares whole prompt pages across requests: every
prompt then opens with the same seeded "system prompt" of two pages and
one token, so that the shared pages hit. ``--audit`` checks the
engine's invariants after every step. The
counterpart of the JAX package's synchronous ``launch/serve.py`` path;
the asyncio front-end is not ported yet, and there is no ``--kernels``
switch: CUDA tensors always run the hand-written kernels.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import CONFIGS, get_config, reduced
from repro_torch.configs.base import WEIGHT_FORMATS
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import Model
from repro_torch.serving.engine import EngineStats, Request, ServingEngine
from repro_torch.serving.sampler import SamplingConfig


@dataclasses.dataclass
class ServeResult:
    engine: ServingEngine
    requests: List[Request]
    warmup_stats: EngineStats           # the warmup request's stats
    launches_after_warmup: Dict[str, int]   # ops.launch_counts() then


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b", choices=sorted(CONFIGS))
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="shrink the config for smoke runs "
                         "(--no-reduced for the full-size model)")
    ap.add_argument("--precision", default="bf16", choices=WEIGHT_FORMATS,
                    help="weight format")
    ap.add_argument("--kv-quant", dest="kv_quant", default="bf16",
                    choices=WEIGHT_FORMATS, help="KV-cache format")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--megastep-k", type=int, default=None,
                    help="decode substeps per megastep (default 8)")
    ap.add_argument("--admission", default="chunked",
                    choices=["chunked", "stall"],
                    help="prompt admission: ride inside the megastep "
                         "(chunked) or batched prefill calls between "
                         "megasteps (stall)")
    ap.add_argument("--page-size", type=int, default=0,
                    help="KV-cache page size in tokens; 0 = dense cache")
    ap.add_argument("--cache-blocks", type=int, default=0,
                    help="pool blocks of a paged cache (default: one a "
                         "page a slot, plus the garbage block)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="reuse whole prompt-prefix pages across "
                         "requests (needs --page-size > 0 and chunked "
                         "admission)")
    ap.add_argument("--audit", action="store_true",
                    help="run engine.audit() after every step (block "
                         "pool partition, refcounts, slot and queue "
                         "invariants)")
    ap.add_argument("--temperature", type=float, default=0.8,
                    help="sampling temperature (0 = greedy); top-k 40")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the prompts")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    return ap


def make_requests(vocab_size: int, n: int, max_new: int,
                  seed: int = 0, shared_prefix: int = 0) -> List[Request]:
    """n requests of 4-8 seeded prompt tokens, each opened by the same
    ``shared_prefix`` tokens (drawn from seed + 1, so that the tails do
    not depend on it)."""
    rng = np.random.default_rng(seed)
    shared = np.random.default_rng(seed + 1).integers(
        1, vocab_size, size=shared_prefix).astype(np.int32)
    return [Request(uid=i,
                    prompt=np.concatenate([shared, rng.integers(
                        1, vocab_size, size=4 + i % 5).astype(np.int32)]),
                    max_new_tokens=max_new)
            for i in range(n)]


def main(argv: Optional[List[str]] = None) -> ServeResult:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    cfg = dataclasses.replace(cfg, kv_quant=args.kv_quant)
    model = Model(cfg, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = model.init(gen, quantize=False)
    engine = ServingEngine(
        model, params, slots=args.slots, max_len=args.max_len,
        sampling=SamplingConfig(temperature=args.temperature, top_k=40),
        seed=args.seed, megastep_k=args.megastep_k,
        quant_policy=args.precision, admission=args.admission,
        page_size=args.page_size, cache_blocks=args.cache_blocks,
        prefix_cache=args.prefix_cache)
    engine.audit_every_step = args.audit

    # warmup: first-use costs (kernel build and load, library handles,
    # the megastep graph's capture) stay out of the timed run
    t0 = time.perf_counter()
    engine.submit(Request(uid=-1, prompt=np.arange(1, 6, dtype=np.int32),
                          max_new_tokens=max(args.max_new, 1)))
    engine.run()
    warmup_s = time.perf_counter() - t0
    warmup_stats = engine.stats
    launches_after_warmup = ops.launch_counts()
    engine.reset()

    shared = 2 * engine.page_size + 1 if engine.prefix_cache else 0
    requests = make_requests(cfg.vocab_size, args.requests, args.max_new,
                             args.seed, shared_prefix=shared)
    for r in requests:
        engine.submit(r)
    engine.run()

    st = engine.stats
    decode_s = max(st.decode_wall_s, 1e-9)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"arch={cfg.name} precision={args.precision} "
          f"kv_quant={engine.kv_quant} device={where}: "
          f"{st.tokens_generated} tokens / {decode_s:.3f}s = "
          f"{st.tokens_generated / decode_s:.1f} tok/s, "
          f"{1e3 * decode_s / max(st.steps, 1):.3f} ms per decode step "
          f"({st.steps} steps in {st.megasteps} megasteps "
          f"[K={engine.megastep_k}], {st.prefills} admissions "
          f"({engine.admission}: {st.chunk_refills} chunk refills, "
          f"{st.prefill_batches} prefill batches); "
          f"{st.graph_replays} graph replays, "
          f"{warmup_stats.graph_captures + st.graph_captures} graph "
          f"captures; warmup {warmup_s:.2f}s excluded)")
    if engine.paged:
        print(f"paged cache: page_size={engine.page_size}, "
              f"{engine.cache_blocks} blocks ({engine.cache_nbytes()} "
              f"bytes), prefix_cache={engine.prefix_cache}: "
              f"prefix_hits={st.prefix_hits} "
              f"prefix_hit_tokens={st.prefix_hit_tokens} "
              f"blocks_in_use={engine.blocks_in_use} "
              f"blocks_recycled={st.blocks_recycled}")
    return ServeResult(engine, requests, warmup_stats, launches_after_warmup)


if __name__ == "__main__":
    main()
