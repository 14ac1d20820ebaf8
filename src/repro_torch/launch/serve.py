"""Serving CLI and the asyncio front-end.

``AsyncServingFrontend``
    An asyncio actor around :class:`ServingEngine`. One coroutine owns
    the engine and alternates ``engine.step()``, run in a thread-pool
    executor so that the event loop stays live while the card computes,
    with a pass between steps that submits the requests staged since,
    cancels those whose deadline expired or whose caller gave up
    (``engine.cancel``: the slot turns idle on the device, so a megastep
    in flight leaves its cache alone), and streams the tokens drained
    since to each request's callback. Only that coroutine touches the
    engine, so nothing is locked; ``generate()`` stages a request and
    awaits its future. A semaphore bounds the requests submitted and
    not finished (``max_pending``).

CLI (``main``)
    Builds a model with seeded random weights and serves a synthetic
    batch of requests, through ``engine.run()`` or, with ``--frontend``,
    through the front-end with staggered arrivals and optional
    deadlines; prints throughput.

    python -m repro_torch.launch.serve --arch llama3.2-1b --no-reduced \\
        --precision q8_0 --pipeline-depth 2

Runs on the card by default (``--device cpu`` for a CPU run). On the
card the warmup request also captures the engine's megastep graph, so
every megastep of the timed run is one graph replay. The run's output
ends with the weight-streaming floor of a decode step (``step_floor``):
for a mixture-of-experts config it counts the experts the run's routing
actually read, beside the floor of reading every expert; for a recurrent
config (mamba2-2.7b, recurrentgemma-2b) it adds the state every slot
reads and writes once a step, whatever the context, and for the hybrid
(recurrentgemma-2b) also each local-attention layer's ring read at the
run's kv_len and one row written. A recurrent config takes ``--page-size``,
``--prefix-cache`` and ``--kv-quant`` as the JAX package does, as no-ops
(the engine warns that the prefix cache is disabled), and the output
names the cache format and paging actually served. An MoE config
takes bf16 weights only: ``--precision q8_0`` / ``q4_0`` exits with the
engine's error. ``--pipeline-depth
2`` keeps one megastep in flight while the host drains the one before.
``--num-layers`` cuts the depth (phi3.5-moe-42b-a6.6b's bf16 weights
fill one 80 GB card at 24 of its 32 layers). Each weight is quantized to
``--precision`` as ``Model.init`` draws it, so deepseek-67b (q4_0 /
q8_0) and qwen1.5-110b (q4_0) serve at full depth on one card.
``--prefill-chunk`` sets the prompt tokens staged a slot for chunked
admission (default ``max(megastep_k, 16)``; under K a slot waits for its
refill). ``--page-size`` pages the
KV cache (``--cache-blocks`` sizes its pool),
and ``--prefix-cache`` shares whole prompt pages across requests: every
prompt then opens with the same seeded "system prompt" of two pages and
one token, so that the shared pages hit. ``--max-queue`` bounds the
engine's queue (a submit past it is shed), and ``--audit`` checks the
engine's invariants after every step. There is no ``--kernels`` switch:
CUDA tensors always run the hand-written kernels.
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import CONFIGS, get_config, reduced
from repro_torch.configs.base import WEIGHT_FORMATS
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import Model
from repro_torch.models.moe import check_weight_format
from repro_torch.quant.quantize import QuantizedTensor
from repro_torch.serving.engine import (EngineStats, QueueFull, Request,
                                        ServingEngine, SubmitReject)
from repro_torch.serving.sampler import SamplingConfig


HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate (NVIDIA data sheet)


@dataclasses.dataclass
class ServeResult:
    engine: ServingEngine
    requests: List[Request]             # the timed run's (empty with
                                        # --frontend: the front-end made them)
    warmup_stats: EngineStats           # the warmup request's stats
    launches_after_warmup: Dict[str, int]   # ops.launch_counts() then
    floor: Dict[str, float]             # step_floor() of the timed run


class DeadlineExceeded(Exception):
    """Raised by ``AsyncServingFrontend.generate`` when a request's
    deadline expires before it finishes; ``tokens`` holds what it
    generated before it was cancelled."""

    def __init__(self, uid: int, tokens: List[int]):
        super().__init__(f"request {uid} cancelled at its deadline after "
                         f"{len(tokens)} token(s)")
        self.uid = uid
        self.tokens = tokens


class Backpressure(Exception):
    """Raised by ``generate`` when the engine sheds the request at its
    queue bound (``QueueFull``). ``retry_after_s`` is the predicted
    backlog drain time: from the engine's measured substep time when it
    has one, else the front-end's ``drain_hint_s`` times the queue
    depth."""

    def __init__(self, uid: int, retry_after_s: Optional[float],
                 queue_depth: int):
        hint = (f"retry after ~{retry_after_s:.3f}s"
                if retry_after_s is not None else "retry after a drain")
        super().__init__(f"request {uid} shed at the queue bound (depth "
                         f"{queue_depth}); {hint}")
        self.uid = uid
        self.retry_after_s = retry_after_s
        self.queue_depth = queue_depth


class RequestFailed(Exception):
    """Raised by ``generate`` when the engine retires the request with an
    error (``nonfinite-logits``); ``tokens`` holds what it generated
    before. The requests batched with it are unaffected."""

    def __init__(self, uid: int, reason: str, tokens: List[int]):
        super().__init__(f"request {uid} failed: {reason} (after "
                         f"{len(tokens)} token(s))")
        self.uid = uid
        self.reason = reason
        self.tokens = tokens


@dataclasses.dataclass
class _Handle:
    req: Request
    future: asyncio.Future
    on_token: Optional[Callable[[int], None]]
    deadline: Optional[float]        # absolute time.monotonic() deadline
    sent: int = 0                    # tokens already streamed
    admitted: bool = False           # engine.submit() has run
    expired: bool = False            # cancelled by the deadline sweep


class AsyncServingFrontend:
    """Actor-style asyncio front-end over a :class:`ServingEngine`::

        fe = AsyncServingFrontend(engine, max_pending=32)
        toks = await fe.generate(prompt, max_new_tokens=16,
                                 deadline_s=0.5, on_token=print)
        await fe.close()

    ``generate`` resolves with the request's tokens, or raises
    :class:`DeadlineExceeded` (with the partial tokens) when its deadline
    expires, :class:`Backpressure` (with a retry-after hint) when the
    engine sheds it at its ``max_queue`` bound, :class:`RequestFailed`
    when the engine retires it with an error, and ``ValueError`` for a
    request ``submit()`` rejects (empty prompt, negative budget,
    ``PromptTooLong``). Cancelling the awaiting task cancels the request
    in the engine too. ``drain_hint_s`` is the retry-after estimate per
    queued request before the engine has measured a step."""

    def __init__(self, engine: ServingEngine, *, max_pending: int = 32,
                 drain_hint_s: Optional[float] = None):
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1 (got {max_pending})")
        self.engine = engine
        self.max_pending = max_pending
        self.drain_hint_s = drain_hint_s
        self._sem = asyncio.Semaphore(max_pending)
        self._incoming: List[_Handle] = []   # staged, not yet submitted
        self._live: List[_Handle] = []       # submitted, future pending
        self._to_cancel: List[_Handle] = []  # staged explicit cancels
        self._wake: Optional[asyncio.Event] = None
        self._task: Optional[asyncio.Task] = None
        self._closed = False
        self._uid = 0

    # -- public API ---------------------------------------------------------
    async def generate(self, prompt, *, max_new_tokens: int = 32,
                       eos_id: int = -1,
                       temperature: Optional[float] = None,
                       top_k: Optional[int] = None,
                       top_p: Optional[float] = None,
                       deadline_s: Optional[float] = None,
                       on_token: Optional[Callable[[int], None]] = None,
                       ) -> List[int]:
        if self._closed:
            raise RuntimeError("front-end is closed")
        await self._sem.acquire()
        loop = asyncio.get_running_loop()
        self._ensure_loop()
        self._uid += 1
        req = Request(uid=self._uid, prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=max_new_tokens, eos_id=eos_id,
                      temperature=temperature, top_k=top_k, top_p=top_p)
        handle = _Handle(
            req=req, future=loop.create_future(), on_token=on_token,
            deadline=(time.monotonic() + deadline_s
                      if deadline_s is not None else None))
        self._incoming.append(handle)
        self._wake.set()
        try:
            return await handle.future
        except asyncio.CancelledError:
            # the caller gave up: retire the request between steps
            self._to_cancel.append(handle)
            self._wake.set()
            raise

    async def close(self) -> None:
        """Stop the serve loop once the staged work has drained."""
        self._closed = True
        if self._wake is not None:
            self._wake.set()
        if self._task is not None:
            await self._task
            self._task = None

    # -- serve loop ---------------------------------------------------------
    def _ensure_loop(self) -> None:
        if self._wake is None:
            self._wake = asyncio.Event()
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(
                self._serve())

    def _admit_incoming(self) -> None:
        staged, self._incoming = self._incoming, []
        for h in staged:
            try:
                self.engine.submit(h.req)
                h.admitted = True
                self._live.append(h)
            except QueueFull as e:       # shed: back pressure
                retry = e.retry_after_s
                if retry is None and self.drain_hint_s is not None:
                    retry = self.drain_hint_s * max(e.queue_depth, 1)
                if not h.future.done():
                    h.future.set_exception(Backpressure(
                        h.req.uid, retry, e.queue_depth))
                self._sem.release()
            except ValueError as e:      # rejected at submit
                if not h.future.done():
                    h.future.set_exception(e)
                self._sem.release()

    def _sweep_cancellations(self) -> None:
        staged, self._to_cancel = self._to_cancel, []
        for h in staged:
            self.engine.cancel(h.req)
        now = time.monotonic()
        for h in self._live:
            if (h.deadline is not None and now >= h.deadline
                    and not h.req.done):
                h.expired = True
                self.engine.cancel(h.req)

    def _publish(self) -> None:
        still = []
        for h in self._live:
            fresh = h.req.output[h.sent:]
            h.sent += len(fresh)
            if h.on_token is not None:
                for tok in fresh:
                    h.on_token(tok)
            if not h.req.done:
                still.append(h)
                continue
            if not h.future.done():
                if h.expired:
                    h.future.set_exception(DeadlineExceeded(
                        h.req.uid, list(h.req.output)))
                elif h.req.error is not None:
                    h.future.set_exception(RequestFailed(
                        h.req.uid, h.req.error, list(h.req.output)))
                else:
                    h.future.set_result(list(h.req.output))
            self._sem.release()
        self._live = still

    async def _serve(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            self._admit_incoming()
            self._sweep_cancellations()
            self._publish()
            if not self.engine.has_work() and not self._live:
                if self._closed and not self._incoming:
                    return
                self._wake.clear()
                if not self._incoming and not self._to_cancel:
                    await self._wake.wait()
                continue
            # the event loop stays live while the engine steps: calls of
            # generate() meanwhile stage work for the next pass
            await loop.run_in_executor(None, self.engine.step)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b", choices=sorted(CONFIGS))
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="shrink the config for smoke runs "
                         "(--no-reduced for the full-size model)")
    ap.add_argument("--num-layers", type=int, default=0,
                    help="serve the first N layers only (0: the config's "
                         "depth), for a model whose weights outgrow the "
                         "card at full depth")
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
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="on-device prompt chunk size for chunked "
                         "admission (default: max(megastep_k, 16))")
    ap.add_argument("--page-size", type=int, default=0,
                    help="KV-cache page size in tokens; 0 = dense cache")
    ap.add_argument("--cache-blocks", type=int, default=0,
                    help="pool blocks of a paged cache (default: one a "
                         "page a slot, plus the garbage block)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="reuse whole prompt-prefix pages across "
                         "requests (needs --page-size > 0 and chunked "
                         "admission)")
    ap.add_argument("--pipeline-depth", type=int, default=1,
                    help="megasteps kept in flight: 1 = serial dispatch "
                         "and drain, 2 = the host drains megastep N while "
                         "the card runs N+1")
    ap.add_argument("--frontend", action="store_true",
                    help="serve the synthetic requests through the asyncio "
                         "front-end (staggered arrivals, streaming "
                         "callbacks) instead of engine.run()")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request deadline for --frontend runs")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bound the engine's queue: a submit past it "
                         "raises QueueFull (the front-end turns it into "
                         "Backpressure with a retry-after hint); 0 = "
                         "unbounded")
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


def _nbytes(node) -> int:
    if isinstance(node, QuantizedTensor):
        return sum(t.numel() * t.element_size()
                   for t in (node.data, node.scales))
    if isinstance(node, dict):
        return sum(_nbytes(v) for v in node.values())
    if isinstance(node, list):
        return sum(_nbytes(v) for v in node)
    return node.numel() * node.element_size()


def step_floor(engine: ServingEngine,
               reads: Optional[torch.Tensor] = None,
               kv_len: float = 0.0) -> Dict[str, float]:
    """The weight-streaming floor of one decode step: the bytes it must
    read once (every layer weight as stored, the final norm and the
    unembedding: the tied table whole, or the untied head) over the H100's
    memory rate. A recurrent config's step also reads and writes every
    slot's recurrent states once (``state_bytes``: the SSM layers' conv
    and SSD states, the RG-LRU layers' conv and recurrent states, read
    plus written, at the engine's slot count), which the floor adds. A
    hybrid's step also reads each local-attention layer's bf16 K and V
    rows at ``kv_len`` positions a slot (the run's mean, which the caller
    gives) and writes one row of each (``ring_bytes``); its rings are not
    counted whole, since a step reads only the visible positions. For an
    MoE config the routed experts count only as often as the routing read
    them:
    ``reads`` (``Model.expert_reads`` over a run: experts with a pair,
    summed over MoE layer passes, and the passes) gives the mean experts
    a layer pass, and the floor counts that many experts a layer;
    ``all_experts_*`` counts every expert.
    Arithmetic from the weights' shapes, not a measurement."""
    p, cfg = engine.params, engine.cfg
    head = p["embedding"] if cfg.tie_embeddings else p["lm_head"]
    total = _nbytes(p["layers"]) + _nbytes(head) + _nbytes(p["final_norm"])
    out = dict(bytes=total, ms=total / HBM_BYTES_PER_S * 1e3)
    if cfg.is_recurrent:
        kinds = engine.model.kinds
        state = 2 * _nbytes([c for c, kind in zip(engine.cache["layers"],
                                                  kinds) if kind != "attn"])
        row = 2 * cfg.num_kv_heads * cfg.head_dim * 2   # K and V, bf16
        ring = int(kinds.count("attn") * engine.slots * row * (kv_len + 1))
        out = dict(bytes=total + state + ring,
                   ms=(total + state + ring) / HBM_BYTES_PER_S * 1e3,
                   weight_bytes=total, state_bytes=state, ring_bytes=ring,
                   kv_len=kv_len, slots=engine.slots)
    if not cfg.is_moe:
        return out
    experts = _nbytes([p_l["moe"]["experts"] for p_l in p["layers"]])
    per_expert = experts / (cfg.num_layers * cfg.num_experts)
    read, passes = (int(v) for v in reads.tolist()) if reads is not None \
        else (0, 0)
    mean = read / passes if passes else float(cfg.num_experts)
    routed = total - experts + cfg.num_layers * mean * per_expert
    return dict(bytes=routed, ms=routed / HBM_BYTES_PER_S * 1e3,
                all_experts_bytes=total, all_experts_ms=out["ms"],
                experts_a_layer=mean, moe_layer_passes=passes)


def _run_frontend(engine: ServingEngine, vocab_size: int, args) -> int:
    """Serve ``args.requests`` seeded prompts through the asyncio
    front-end, one arrival per event-loop turn. Returns how many were
    not served to the end (deadline expired, shed or failed)."""
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(1, vocab_size, size=4 + i % 5).astype(np.int32)
               for i in range(args.requests)]

    async def drive():
        fe = AsyncServingFrontend(engine,
                                  max_pending=max(2 * args.slots, 4))

        async def one(p):
            try:
                await fe.generate(p, max_new_tokens=args.max_new,
                                  deadline_s=args.deadline_s)
                return 0
            except (DeadlineExceeded, Backpressure, RequestFailed):
                return 1

        tasks = []
        for p in prompts:
            tasks.append(asyncio.ensure_future(one(p)))
            await asyncio.sleep(0)       # staggered arrivals
        missed = sum(await asyncio.gather(*tasks))
        await fe.close()
        return missed

    return asyncio.run(drive())


def main(argv: Optional[List[str]] = None) -> ServeResult:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    cfg = dataclasses.replace(cfg, kv_quant=args.kv_quant)
    if args.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=args.num_layers)
    try:
        # the engine's own check, before the weights are drawn
        check_weight_format(cfg, args.precision)
    except ValueError as e:
        raise SystemExit(f"repro_torch.launch.serve: {e}") from e
    # each weight is quantized to --precision as soon as it is drawn, so
    # that the float tree of a large model never exists (Model.init)
    model = Model(dataclasses.replace(cfg, quant_policy=args.precision),
                  device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = model.init(gen)
    engine = ServingEngine(
        model, params, slots=args.slots, max_len=args.max_len,
        sampling=SamplingConfig(temperature=args.temperature, top_k=40),
        seed=args.seed, megastep_k=args.megastep_k,
        prefill_chunk=args.prefill_chunk,
        quant_policy=args.precision, admission=args.admission,
        page_size=args.page_size, cache_blocks=args.cache_blocks,
        prefix_cache=args.prefix_cache, pipeline_depth=args.pipeline_depth,
        max_queue=args.max_queue)
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
    reads = engine.model.expert_reads
    if reads is not None:
        reads.zero_()

    t0 = time.perf_counter()
    missed, requests = 0, []
    if args.frontend:
        missed = _run_frontend(engine, cfg.vocab_size, args)
    else:
        shared = 2 * engine.page_size + 1 if engine.prefix_cache else 0
        requests = make_requests(cfg.vocab_size, args.requests, args.max_new,
                                 args.seed, shared_prefix=shared)
        for r in requests:
            try:
                engine.submit(r)
            except SubmitReject:
                # shed at the --max-queue bound: counted in stats.shed
                # and reported below (the whole batch is submitted at once)
                pass
        engine.run()
    wall = time.perf_counter() - t0

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
          f"captures; warmup {warmup_s:.2f}s excluded; run wall "
          f"{wall:.3f}s)")
    print(f"pipeline: depth {engine.pipeline_depth}, drain-wait "
          f"{st.drain_wait_s:.4f}s, staging {st.stage_wall_s:.4f}s of "
          f"{decode_s:.4f}s in step()")
    if st.shed or st.preemptions or st.poisoned or st.cancelled:
        print(f"overload: {st.shed} shed, {st.preemptions} preemptions, "
              f"{st.poisoned} poisoned, {st.cancelled} cancelled (queue "
              f"bound {engine.max_queue or 'none'})")
    if cfg.is_recurrent:
        rings = (" (the local-attention rings included)"
                 if "attn" in engine.model.kinds else "")
        print(f"recurrent state: {_nbytes(engine.cache['layers'])} bytes"
              f"{rings} "
              f"for {engine.slots} slots; page_size={engine.page_size} "
              f"(asked {args.page_size}), kv_quant={engine.kv_quant} (asked "
              f"{args.kv_quant}), prefix_cache={engine.prefix_cache}")
    if engine.paged:
        print(f"paged cache: page_size={engine.page_size}, "
              f"{engine.cache_blocks} blocks ({engine.cache_nbytes()} "
              f"bytes), prefix_cache={engine.prefix_cache}: "
              f"prefix_hits={st.prefix_hits} "
              f"prefix_hit_tokens={st.prefix_hit_tokens} "
              f"blocks_in_use={engine.blocks_in_use} "
              f"blocks_recycled={st.blocks_recycled}")
    if args.frontend:
        print(f"frontend: {args.requests - missed} completed, {missed} "
              f"deadline-expired, shed or failed, {st.cancelled} engine "
              "cancellations")
    # a hybrid's rings: the mean over the requests of the positions a slot
    # sees halfway through its stream (prompt and tokens, within the ring)
    ring_len = (Model.cache_len(engine.cache) if "attn" in engine.model.kinds
                and cfg.is_recurrent else 0)
    kv_len = (float(np.mean([min(len(r.prompt) + len(r.output) // 2,
                                 ring_len) for r in requests]))
              if ring_len and requests else 0.0)
    floor = step_floor(engine, reads, kv_len)
    if cfg.is_recurrent:
        line = (f"floor: {floor['ms']:.3f} ms a decode step to read "
                f"{floor['weight_bytes'] / 1e9:.3f} GB of weights and read "
                f"and write {floor['state_bytes'] / 1e9:.3f} GB of state "
                f"({floor['slots']} slots)")
        if floor["ring_bytes"]:
            line += (f" and {floor['ring_bytes'] / 1e9:.6f} GB of the "
                     f"local-attention rings (kv_len {floor['kv_len']:.1f})")
        line += " at 3.35 TB/s"
    else:
        line = (f"floor: {floor['ms']:.3f} ms a decode step to read "
                f"{floor['bytes'] / 1e9:.3f} GB of weights at 3.35 TB/s")
    if cfg.is_moe:
        line += (f" ({floor['experts_a_layer']:.2f} of {cfg.num_experts} "
                 f"experts a layer pass, the mean over "
                 f"{floor['moe_layer_passes']} passes; every expert: "
                 f"{floor['all_experts_ms']:.3f} ms, "
                 f"{floor['all_experts_bytes'] / 1e9:.3f} GB)")
    print(line)
    return ServeResult(engine, requests, warmup_stats, launches_after_warmup,
                       floor)


if __name__ == "__main__":
    main()
