"""Continuous-batching serving engine with chunked or stall prefill
admission and K-substep decode megasteps (the core of the JAX package's
``serving/engine.py``).

The engine owns a fixed decode batch of ``slots``. Every ``step()`` runs
one **megastep**: ``megastep_k`` substeps of ``Model.decode_step`` over
the whole batch, with per-slot sampling, per-slot EOS/length retirement
and the per-slot prompt cursor all kept on the device. The host reads
one packed ``(4, K, slots)`` block (tokens, emission mask, prefill
progress, nonfinite flag) per megastep, so one device→host transfer
serves K tokens per slot.

- **Chunked admission**: a request's prompt rides inside the megastep,
  one prompt token per substep through ``decode_step`` (the path that
  ``Model.reference_decode`` takes), from a per-slot on-device chunk of
  ``max(megastep_k, 16)`` prompt tokens that the host refreshes between
  megasteps. The slot emits its first token in the substep that feeds
  its last prompt token; decoding neighbours never stall.
- **Stall admission** (``admission="stall"``): between megasteps, the
  queued requests that fit into free slots are grouped by padded
  length (the next power of two, at least 8, capped at the cache's
  length; a prompt longer than the cache, such as a windowed model's
  past its ring or a resumed request past ``max_len``, at its exact
  length, which the prefill writes into the ring; every prompt of a
  recurrent family at its exact length, since its state runs through
  every position) and each group is
  prefilled in one ``Model.prefill`` call into a scratch cache, whose
  rows are copied into the live cache at the slots. The first token is
  sampled from the prefill's logits; decoding slots stall meanwhile.
- **Retirement**: a slot that emits EOS or reaches its budget turns
  idle; idle and waiting slots ride the fixed-shape batch with
  ``advance_mask`` False, so their cache rows are never written.
- **Nonfinite logits**: a slot whose logits hold a NaN or inf emits
  nothing, turns idle at once, and its request ends with
  ``error = "nonfinite-logits"``; the other slots are untouched.
- **Recurrent families** (mamba2 and the recurrentgemma hybrid,
  ``cfg.is_recurrent``): the cache is each layer's conv and SSD (or
  RG-LRU) states, and the hybrid's local-attention rings, of a fixed
  size a slot, so paging, the prefix cache and ``kv_quant`` are no-ops
  (the JAX package's contract: the prefix cache warns and disables
  itself), a prompt longer than ``max_len`` is served, and a fresh
  slot's states are zeroed at its admission like its K/V rows.
- **Paged cache** (``page_size`` > 0): every layer's K/V is a pool of
  ``cache_blocks`` blocks of ``page_size`` positions, and a block table
  (slots, max_pages) maps each slot's pages onto blocks, so the cache's
  memory follows the live tokens rather than ``slots × max_len``. A host
  allocator hands out blocks at admission (a request whose pages the
  pool cannot supply waits at the head of the queue, FIFO) and takes
  them back when the request ends. The decode kernels read and write
  the pool through the table; stall admission prefills into a dense
  scratch cache and scatters its pages into the slots' blocks
  (``_paged_splice``).
- **Prefix cache** (``prefix_cache``, paged and chunked admission only):
  once a prompt's pages are written, each whole page is registered
  under the prompt prefix it ends (an LRU registry that holds its own
  reference); a later prompt with the same prefix maps those blocks into
  its table copy-on-write and feeds only its tail. Decode writes land
  past the prompt, so shared pages are never written again.

- **Pipelined dispatch and drain** (``pipeline_depth``): ``step()``
  stages the admissions from the host's view of the slots and dispatches
  a megastep, then drains the oldest megastep in flight once
  ``pipeline_depth`` are outstanding. At depth 1 that is the megastep
  just dispatched (the serial loop); at depth 2 the previous one, so the
  host's drain and the next staging overlap the megastep on the device.
  Each megastep in flight carries a snapshot of its slots' occupants,
  and its drain hands tokens to those requests, advancing the prompt
  cursor and registering prefix pages only while the slot still serves
  that request. Greedy streams are the depth-1 engine's; only latency
  moves (a freed slot is refilled one megastep later, and one all-idle
  megastep runs per queue drain).
- **Overload** (the JAX package's failure semantics): ``submit`` sheds
  with a typed ``SubmitReject`` before the request holds anything
  (``QueueFull`` at the ``max_queue`` bound, with a ``retry_after_s``
  hint from the measured substep time; ``InfeasibleDeadline`` when
  ``Request.deadline_s`` cannot be met by an empty engine;
  ``PromptTooLong``). The queue is ordered earliest deadline first,
  FIFO among requests without one. A pool-starved paged admission
  preempts a victim whose deadline key is strictly later (``_pick_victim``),
  else blocks FIFO; a preempted request is requeued and resumes from its
  prompt plus the tokens it already generated, so a greedy stream is the
  uninterrupted one. ``cancel`` retires a queued or active request, and
  ``inject_logit_poison`` turns a request's logits to NaN inside the
  megastep, so that it ends with ``error = "nonfinite-logits"``.

On the card a megastep is one device program, as the JAX package's
jitted megastep is: the admission merge and the K substeps
(``_megastep_body``) are captured once as a CUDA graph per value of
``all_greedy`` (at most two graphs, the second when first needed), and
each megastep is one host→device copy of the packed admission buffer,
one ``graph.replay()`` and one device→host copy of the block, after
which it records a CUDA event; its drain waits on that event alone, never
on the stream. The pinned host buffers are rings with one entry per
megastep in flight (the device buffers, whose addresses the graphs hold,
stay single). Every device write of the engine (the megasteps, the stall
prefill, ``cancel``, ``preempt``, ``reset``, the captures) is issued on
one stream the engine owns, so it lands between two replays in the order
the host issued it, whichever thread calls (the asyncio front-end steps
the engine in an executor thread and cancels from its event loop's). On
the CPU the same body runs eagerly and synchronously. The cache, the
slot state, the admission buffers, the block and the sampling generator
keep their addresses for the engine's life (``reset()`` zeroes and
reseeds them in place), so the graphs stay valid; that also replaces the
JAX package's donated megastep carries, so the port has no
``donate_carries`` knob. ``audit()`` checks the allocator's and the
slots' invariants between steps (``audit_every_step`` runs it after
each).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
import warnings
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import WEIGHT_FORMATS
from repro_torch.kernels import ops
from repro_torch.models import Model
from repro_torch.models.moe import check_weight_format
from repro_torch.quant.quantize import (FLOAT_FORMATS, QuantizedTensor,
                                        quantize_tree)
from repro_torch.serving.sampler import SamplingConfig, sample_batched

DEFAULT_MEGASTEP_K = 8
ADMISSIONS = ("chunked", "stall")
PAD_ID = 0

PHASE_IDLE = 0      # retired / never filled: cache frozen, no emission
PHASE_PREFILL = 1   # consuming prompt tokens, no emission yet
PHASE_DECODE = 2    # generating: sample + emit every substep

_INF = float("inf")

# The packed admission buffer: one int32 row of ``slots`` per field
# (``temp`` and ``top_p`` hold f32 bits; ``poison`` marks the slots whose
# logits the megastep turns to NaN; a paged engine adds ``start_pos``,
# the cached-prefix length a fresh slot starts at), then the (slots,
# chunk) prompt tokens, then (paged) the fresh slots' (slots, max_pages)
# block-table rows.
ADMIT_ROWS = ("new", "refill", "base", "prompt_len", "max_new", "eos",
              "temp", "top_k", "top_p", "poison")
ADMIT_PAGED_ROWS = ("start_pos",)
ADMIT_F32_ROWS = ("temp", "top_p")


class SubmitReject(ValueError):
    """A typed reject at ``submit()``: the request was refused before it
    held any engine resource. ``retry_after_s`` is a hint (None while the
    engine has measured no step); ``reason`` names the class."""
    reason = "rejected"

    def __init__(self, msg: str, *, uid: Optional[int] = None,
                 retry_after_s: Optional[float] = None,
                 queue_depth: int = 0):
        super().__init__(msg)
        self.uid = uid
        self.retry_after_s = retry_after_s
        self.queue_depth = queue_depth


class QueueFull(SubmitReject):
    """Load shed: the bounded queue (``max_queue``) is full."""
    reason = "queue_full"


class InfeasibleDeadline(SubmitReject):
    """Load shed: ``Request.deadline_s`` cannot be met even if the
    request were admitted at once (measured substep time)."""
    reason = "infeasible_deadline"


class PromptTooLong(SubmitReject):
    """The prompt can never fit this engine's cache: admitting it would
    write past the slot's rows and corrupt its own stream."""
    reason = "prompt_too_long"


class EngineAuditError(AssertionError):
    """An allocator or scheduler invariant does not hold (``audit()``)."""


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray               # (S,) int32
    max_new_tokens: int = 32
    eos_id: int = -1                 # -1 → never stops early
    # per-request sampling overrides (None → the engine's SamplingConfig)
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    # completion deadline in seconds from submit: orders the queue (EDF)
    # and arms the infeasibility shed; the engine never cancels on expiry
    # itself (the front-end's deadline sweep does)
    deadline_s: Optional[float] = None
    # filled by the engine:
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    cancelled: bool = False          # retired by ServingEngine.cancel()
    error: Optional[str] = None      # e.g. "nonfinite-logits"
    preemptions: int = 0             # times evicted and requeued
    # the scheduler's: submission order and absolute deadline
    _seq: int = dataclasses.field(default=0, repr=False)
    _deadline_abs: Optional[float] = dataclasses.field(default=None,
                                                       repr=False)


@dataclasses.dataclass
class EngineStats:
    steps: int = 0               # decode substeps executed (K per megastep)
    megasteps: int = 0
    tokens_generated: int = 0
    prefills: int = 0            # requests admitted
    prefill_batches: int = 0     # stall-path prefill calls
    inscan_admissions: int = 0   # requests admitted inside the megastep
    chunk_refills: int = 0       # prompt chunks refreshed after the first
    cancelled: int = 0           # requests retired by cancel()
    preemptions: int = 0         # slots evicted and requeued
    shed: int = 0                # submits rejected (queue full, deadline)
    poisoned: int = 0            # requests retired on nonfinite logits
    graph_captures: int = 0      # megastep graphs captured (card only)
    graph_replays: int = 0       # megasteps served by a graph replay
    prefix_hits: int = 0         # admissions that reused cached blocks
    prefix_hit_tokens: int = 0   # prompt tokens skipped via shared pages
    blocks_recycled: int = 0     # pool blocks returned to the free list
    decode_wall_s: float = 0.0   # wall time in step()
    stage_wall_s: float = 0.0    # host time staging admissions
    drain_wait_s: float = 0.0    # host time waiting for a megastep's block


@dataclasses.dataclass
class SlotState:
    """Per-slot serving state on the device, (slots,) each."""
    last_token: torch.Tensor    # int32, input token of the next substep
    gen_len: torch.Tensor       # int32, tokens generated so far
    max_new: torch.Tensor       # int32
    eos_id: torch.Tensor        # int32
    phase: torch.Tensor         # int32, PHASE_IDLE/PREFILL/DECODE
    prefill_pos: torch.Tensor   # int32, next prompt index to feed
    prompt_len: torch.Tensor    # int32
    chunk_base: torch.Tensor    # int32, prompt index of prompt_buf[:, 0]
    prompt_buf: torch.Tensor    # int32 (slots, chunk)
    temperature: torch.Tensor   # float32
    top_k: torch.Tensor         # int32
    top_p: torch.Tensor         # float32


def _init_slot_state(slots: int, chunk: int, device) -> SlotState:
    def i32(fill=0, shape=(slots,)):
        return torch.full(shape, fill, dtype=torch.int32, device=device)
    return SlotState(
        last_token=i32(), gen_len=i32(), max_new=i32(), eos_id=i32(-1),
        phase=i32(PHASE_IDLE), prefill_pos=i32(), prompt_len=i32(),
        chunk_base=i32(), prompt_buf=i32(0, (slots, chunk)),
        temperature=torch.zeros((slots,), device=device),
        top_k=i32(), top_p=torch.ones((slots,), device=device))


class ServingEngine:
    """Serves ``Request``s on ``model.device`` (the card unless the
    model was built with ``device="cpu"``)."""

    def __init__(self, model: Model, params, *, slots: int = 4,
                 max_len: int = 1024,
                 sampling: SamplingConfig = SamplingConfig(),
                 seed: int = 0,
                 megastep_k: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 quant_policy: Optional[str] = None,
                 kv_quant: Optional[str] = None,
                 admission: str = "chunked",
                 page_size: int = 0, cache_blocks: int = 0,
                 prefix_cache: bool = False, pipeline_depth: int = 1,
                 max_queue: int = 0):
        if admission not in ADMISSIONS:
            raise ValueError(f"admission must be 'chunked' or 'stall' "
                             f"(got {admission!r})")
        self.admission = admission
        if kv_quant is not None:
            if kv_quant not in WEIGHT_FORMATS:
                raise ValueError(
                    f"kv_quant must be bf16|q8_0|q4_0 (got {kv_quant!r})")
            if kv_quant != model.cfg.kv_quant:
                model = Model(dataclasses.replace(model.cfg,
                                                  kv_quant=kv_quant),
                              device=model.device)
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.kv_quant = model.kv_quant_effective()
        if quant_policy is not None and quant_policy not in FLOAT_FORMATS:
            check_weight_format(model.cfg, quant_policy)
            for fmt in _quantized_formats(params):
                if fmt != quant_policy:
                    raise ValueError(
                        f"params already quantized as {fmt!r}; cannot "
                        f"serve them under quant_policy={quant_policy!r}")
            params = quantize_tree(params, quant_policy,
                                   model.cfg.quant_group)
        self.quant_policy = quant_policy or "bf16"
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.sampling = sampling
        self.seed = seed
        if megastep_k is not None and int(megastep_k) < 1:
            raise ValueError(f"megastep_k must be >= 1 (got {megastep_k})")
        self.megastep_k = int(megastep_k) if megastep_k else \
            DEFAULT_MEGASTEP_K
        # prompt tokens staged on the device per slot (the JAX engine's
        # prefill_chunk, default max(megastep_k, 16)); any value >=
        # megastep_k keeps a prefilling slot fed for a whole megastep, a
        # smaller one leaves it waiting, cache frozen, for the host's
        # refill once its chunk runs dry (the starved-slot branch)
        if prefill_chunk is not None and int(prefill_chunk) < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1 (got {prefill_chunk})")
        self.prefill_chunk = int(prefill_chunk) if prefill_chunk else \
            max(self.megastep_k, 16)
        # megasteps dispatched and not yet drained that step() keeps: 1
        # is the serial loop, 2 drains megastep N while N+1 runs. Host
        # orchestration only, so it may be reassigned between steps.
        if int(pipeline_depth) < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1 (got {pipeline_depth}); "
                "1 is the serial loop, 2 keeps one megastep in flight")
        self.pipeline_depth = int(pipeline_depth)
        # the EDF queue; ``max_queue`` bounds it (0 = unbounded), and
        # submit() sheds with QueueFull at the bound
        if int(max_queue) < 0:
            raise ValueError(f"max_queue must be >= 0 (got {max_queue})")
        self.max_queue = int(max_queue)
        self.queue: Deque[Request] = collections.deque()
        self.audit_every_step = False     # audit() after every step()
        if int(page_size) < 0:
            raise ValueError(f"page_size must be >= 0 (got {page_size})")
        # a windowed model's cache is a ring of the window's length
        window = model.window_for(max_len)
        self._has_window = bool(window)
        self._cache_seq = min(max_len, window) if window else max_len
        self.page_size = model.paging_effective(max_len, int(page_size))
        self.paged = bool(self.page_size)
        if self.paged and max_len % self.page_size:
            raise ValueError(
                f"page_size {self.page_size} must divide the cache length "
                f"{max_len} so the gathered paged view stays "
                "shape-identical to the dense cache")
        self.max_pages = max_len // self.page_size if self.paged else 0
        if self.paged:
            self.cache_blocks = (int(cache_blocks) if cache_blocks
                                 else slots * self.max_pages + 1)
            if self.cache_blocks < 2:
                raise ValueError(
                    f"cache_blocks must be >= 2 (got {cache_blocks}): "
                    "block 0 is the reserved garbage block")
        else:
            self.cache_blocks = 0
        # prefix reuse needs chunked admission: only then are a prompt's
        # pages written by the decode step that every admission of that
        # prompt runs, so shared pages hold what the slot would write
        self.prefix_cache = bool(prefix_cache and self.paged
                                 and admission == "chunked")
        if prefix_cache and not self.prefix_cache:
            warnings.warn("prefix_cache requires a paged cache and chunked "
                          "admission; disabled for this engine",
                          RuntimeWarning, stacklevel=2)
        # device state, allocated once: reset() zeroes it in place
        dev = self.device
        self._on_card = on_card = dev.type == "cuda"
        n, k = slots, self.megastep_k
        self.generator = torch.Generator(device=dev)
        self.cache = model.init_cache(slots, max_len, self.page_size,
                                      self.cache_blocks)
        self.state = _init_slot_state(slots, self.prefill_chunk, dev)
        self._admit_rows = ADMIT_ROWS + (ADMIT_PAGED_ROWS if self.paged
                                         else ())
        self._admit_size = (len(self._admit_rows) * n + n * self.prefill_chunk
                            + n * self.max_pages)
        self._admit_dev = torch.zeros((self._admit_size,), dtype=torch.int32,
                                      device=dev)
        self._admit = self._admit_fields(self._admit_dev)
        self._block = torch.zeros((4, k, n), dtype=torch.int32, device=dev)
        # pinned host rings, one entry per megastep in flight (grown by
        # _grow_rings when pipeline_depth rises); ``_stage`` is the entry
        # the next megastep stages into and copies its block out to
        self._admit_ring: List[torch.Tensor] = []
        self._block_ring: List[torch.Tensor] = []
        self._stage = 0
        self._grow_rings()
        self._graphs: Dict[bool, "torch.cuda.CUDAGraph"] = {}
        # kernel launches one capture recorded, by graph (all_greedy)
        self.graph_launches: Dict[bool, Dict[str, int]] = {}
        self._capture_stream = torch.cuda.Stream(dev) if on_card else None
        # every later device write of the engine goes to its own stream
        # (_on_stream), whichever thread calls
        self._stream = torch.cuda.Stream(dev) if on_card else None
        # (ring entry, CUDA event or None, slot-occupant snapshot) per
        # megastep dispatched and not yet drained, oldest first
        self._inflight: Deque = collections.deque()
        self.reset()

    @contextlib.contextmanager
    def _on_stream(self):
        """Issue the device work of the block on the engine's stream and
        device (on the card), after the caller's stream's work so far;
        the caller's stream then orders its later work after the
        engine's, on the device, without the host waiting."""
        if not self._on_card:
            yield
            return
        with torch.cuda.device(self.device):
            caller = torch.cuda.current_stream()
            self._stream.wait_stream(caller)
            with torch.cuda.stream(self._stream):
                yield
            caller.wait_stream(self._stream)

    def _grow_rings(self) -> None:
        """One pinned admission and block entry per megastep in flight:
        ``pipeline_depth`` entries (never fewer than before)."""
        while len(self._admit_ring) < max(self.pipeline_depth, 1):
            self._admit_ring.append(torch.zeros(
                (self._admit_size,), dtype=torch.int32,
                pin_memory=self._on_card))
            self._block_ring.append(torch.zeros(
                (4, self.megastep_k, self.slots), dtype=torch.int32,
                pin_memory=self._on_card))

    @property
    def _admit_host(self) -> torch.Tensor:
        """The pinned admission entry the next megastep stages into."""
        return self._admit_ring[self._stage]

    @property
    def _block_host(self) -> torch.Tensor:
        """The pinned block entry the next megastep copies out to."""
        return self._block_ring[self._stage]

    def reset(self) -> None:
        """Drop all requests and zero the device state in place (cache or
        pools, lens, block table, slot state; the sampling generator
        reseeded), so that the captured graphs, which hold these
        addresses, stay valid. Waits first for every megastep in flight
        (its copies and replay must not land on the zeroed state or a
        reused ring entry) and drops their blocks. The block allocator
        starts empty."""
        while self._inflight:
            _, event, _ = self._inflight.popleft()
            if event is not None:
                event.synchronize()
        self._stage = 0
        with self._on_stream():
            self.generator.manual_seed(self.seed)
            for layer in self.cache["layers"]:
                for leaf in layer.values():
                    leaf.zero_()
            self.cache["lens"].zero_()
            if self.paged:
                self.cache["block_table"].zero_()
            fresh = _init_slot_state(self.slots, self.prefill_chunk,
                                     self.device)
            for f in dataclasses.fields(SlotState):
                getattr(self.state, f.name).copy_(getattr(fresh, f.name))
        # the block allocator: a free list and refcounts. Block 0 is the
        # garbage block and never handed out. ``_prefix_reg`` maps a
        # prompt prefix (its tokens' bytes, whole pages) to the pool
        # block of its last page, LRU first; the registry holds its own
        # reference, so a cached page outlives its request.
        self._free: List[int] = list(range(self.cache_blocks - 1, 0, -1))
        self._ref = np.zeros((self.cache_blocks,), np.int64)
        self._slot_blocks: List[List[int]] = [[] for _ in range(self.slots)]
        # per slot: how many of its blocks are mapped shared prefix pages
        # (_pick_victim prefers slots without any)
        self._slot_shared: List[int] = [0] * self.slots
        self._slot_reg_done: List[bool] = [False] * self.slots
        self._prefix_reg: "collections.OrderedDict[bytes, int]" = \
            collections.OrderedDict()
        # blocks withheld from the allocator: an owner class of their own
        self._quarantined: List[int] = []
        self.active: List[Optional[Request]] = [None] * self.slots
        # host mirror of each slot's prompt cursor, and the prompt it
        # was admitted with (a resumed request's: its prompt and the
        # tokens it generated before its preemption)
        self._prefill_pos: List[int] = [0] * self.slots
        self._slot_prompt: List[Optional[np.ndarray]] = [None] * self.slots
        self._stochastic_slots: set = set()
        # uids whose logits the megastep turns to NaN (fault injection)
        self._poison_uids: set = set()
        self._submit_seq = 0
        self.queue.clear()
        self.stats = EngineStats()

    def cache_nbytes(self) -> int:
        """Device bytes of the live cache: every layer's leaves (pools
        when paged), ``lens`` and the block table."""
        leaves = [self.cache["lens"]] + [
            t for layer in self.cache["layers"] for t in layer.values()]
        if self.paged:
            leaves.append(self.cache["block_table"])
        return sum(t.numel() * t.element_size() for t in leaves)

    # -- block allocator (paged cache) ---------------------------------------
    @property
    def blocks_in_use(self) -> int:
        """Pool blocks currently referenced (block 0 excluded)."""
        if not self.paged:
            return 0
        return self.cache_blocks - 1 - len(self._free)

    def _decref(self, blk: int) -> None:
        self._ref[blk] -= 1
        assert self._ref[blk] >= 0, f"block {blk} refcount underflow"
        if self._ref[blk] == 0:
            self._free.append(blk)
            self.stats.blocks_recycled += 1

    def _release_slot_blocks(self, s: int) -> None:
        """Drop a finished slot's references. Blocks the prefix registry
        (or another slot) still references survive: only a refcount that
        reaches zero recycles a block."""
        for blk in self._slot_blocks[s]:
            self._decref(blk)
        self._slot_blocks[s] = []
        self._slot_shared[s] = 0
        self._slot_reg_done[s] = False

    def _reserve_blocks(self, n: int) -> bool:
        """Ensure ``n`` free blocks, evicting LRU prefix-registry entries
        if needed (an evicted page that a slot still references is only
        unhooked from the registry, not recycled)."""
        while len(self._free) < n and self._prefix_reg:
            _, blk = self._prefix_reg.popitem(last=False)
            self._decref(blk)
        return len(self._free) >= n

    def _admit_paged(self, s: int, req: Request) -> Optional[int]:
        """Allocate slot s's blocks for ``req``. Returns the position its
        admission starts at (> 0 on a prefix hit: that many prompt tokens
        are already cached in shared pages), or None when the pool cannot
        supply the blocks even after registry eviction (the caller
        preempts a victim or puts the request back at the head of the
        queue). A resumed request allocates for its prompt and generated
        tokens and its remaining budget."""
        P = self.page_size
        prompt = self._eff_prompt(req)
        max_new = self._eff_max_new(req)
        need = min(len(prompt) + max_new, self.max_len)
        n_pages = -(-need // P)
        # a request that outgrows the cache wraps its ring cursor back
        # over its own first pages, which must then be its own: it
        # neither shares nor registers
        wraps = len(prompt) + max_new > self.max_len
        shared = []
        if self.prefix_cache and not wraps:
            # the longest cached prefix, capped so that at least one
            # prompt token is left to feed (the slot emits its first
            # token in the substep that feeds its last prompt token)
            for i in range((len(prompt) - 1) // P):
                key = prompt[:(i + 1) * P].tobytes()
                blk = self._prefix_reg.get(key)
                if blk is None:
                    break
                shared.append((key, blk))
        # the shared blocks are pinned before any eviction, so that
        # evicting their registry entries cannot recycle them
        for _, blk in shared:
            self._ref[blk] += 1
        if not self._reserve_blocks(n_pages - len(shared)):
            for _, blk in shared:
                self._decref(blk)
            return None
        blocks = []
        for key, blk in shared:
            if key in self._prefix_reg:
                self._prefix_reg.move_to_end(key)
            blocks.append(blk)
        for _ in range(n_pages - len(shared)):
            blk = self._free.pop()
            self._ref[blk] = 1
            blocks.append(blk)
        self._slot_blocks[s] = blocks
        self._slot_shared[s] = len(shared)
        self._slot_reg_done[s] = wraps or not self.prefix_cache
        start = len(shared) * P
        if start:
            self.stats.prefix_hits += 1
            self.stats.prefix_hit_tokens += start
        return start

    def _register_prefix(self, s: int, prompt: np.ndarray) -> None:
        """Publish slot s's whole prompt pages to the prefix registry, once
        its drained prompt cursor has passed the prompt (the pages'
        contents then exist on the device). Decode writes land at
        positions past the prompt, so published pages are never written
        again: copy-on-write without a copy."""
        self._slot_reg_done[s] = True
        P = self.page_size
        blocks = self._slot_blocks[s]
        for i in range(len(prompt) // P):
            key = prompt[:(i + 1) * P].tobytes()
            if key in self._prefix_reg:
                self._prefix_reg.move_to_end(key)
                continue
            self._ref[blocks[i]] += 1       # the registry's reference
            self._prefix_reg[key] = blocks[i]

    def _slot_table_row(self, s: int) -> np.ndarray:
        row = np.zeros((self.max_pages,), np.int32)
        blocks = self._slot_blocks[s]
        row[:len(blocks)] = blocks
        return row

    def quarantine_blocks(self, n: int) -> int:
        """Withhold up to ``n`` free blocks from the allocator (returns how
        many were taken): admissions cannot use them, ``audit()``
        accounts for them as an owner class of their own, and
        ``release_quarantined`` returns them."""
        if not self.paged:
            return 0
        n = min(int(n), len(self._free))
        for _ in range(n):
            self._quarantined.append(self._free.pop())
        return n

    def release_quarantined(self, n: Optional[int] = None) -> int:
        """Return up to ``n`` quarantined blocks (all when None) to the
        free list; returns how many were released."""
        k = len(self._quarantined) if n is None else \
            min(int(n), len(self._quarantined))
        for _ in range(k):
            self._free.append(self._quarantined.pop())
        return k

    def audit(self) -> None:
        """Check the invariants between steps (raises
        ``EngineAuditError``): no request is both active and done or
        queued; the free list, the quarantine and the referenced blocks
        partition the pool; every refcount equals the live references to
        its block (slot tables and the prefix registry); block 0 is never
        handed out; an empty slot holds no block. Reads host state only."""
        for s, r in enumerate(self.active):
            if r is None:
                continue
            if r.done or r.cancelled:
                raise EngineAuditError(
                    f"slot {s}: active request {r.uid} is already done")
            if any(q is r for q in self.queue):
                raise EngineAuditError(
                    f"request {r.uid} is both active (slot {s}) and queued")
        if not self.paged:
            return
        refs = np.zeros((self.cache_blocks,), np.int64)
        for s, blocks in enumerate(self._slot_blocks):
            if blocks and self.active[s] is None:
                raise EngineAuditError(
                    f"slot {s}: empty slot still holds blocks {blocks}")
            for b in blocks:
                if not 1 <= b < self.cache_blocks:
                    raise EngineAuditError(
                        f"slot {s}: table maps block {b} (0 is the "
                        "reserved garbage block)")
                refs[b] += 1
        for b in self._prefix_reg.values():
            refs[b] += 1
        free, quar = set(self._free), set(self._quarantined)
        if len(free) != len(self._free):
            raise EngineAuditError("duplicate block in the free list")
        if len(quar) != len(self._quarantined):
            raise EngineAuditError("duplicate block in quarantine")
        if 0 in free or 0 in quar or refs[0] or self._ref[0]:
            raise EngineAuditError("block 0 escaped the garbage role")
        for b in range(1, self.cache_blocks):
            if self._ref[b] != refs[b]:
                raise EngineAuditError(
                    f"block {b}: refcount {int(self._ref[b])} != "
                    f"{int(refs[b])} live references")
            owners = (b in free) + (b in quar) + bool(refs[b] > 0)
            if owners != 1:
                raise EngineAuditError(
                    f"block {b}: {owners} owners (free={b in free}, "
                    f"quarantined={b in quar}, refs={int(refs[b])})")

    # -- preemption and resume ----------------------------------------------
    def _eff_prompt(self, req: Request) -> np.ndarray:
        """The prompt a request is admitted with: its own, then the tokens
        it generated before a preemption. Feeding them through the same
        decode path rebuilds its cache, so a resumed greedy request goes
        on as an uninterrupted run would."""
        prompt = np.asarray(req.prompt, np.int32)
        if not req.output:
            return prompt
        return np.concatenate([prompt, np.asarray(req.output, np.int32)])

    def _eff_max_new(self, req: Request) -> int:
        """The budget left in the slot: the total minus what it emitted."""
        return req.max_new_tokens - len(req.output)

    def _edf_key(self, req: Request):
        d = req._deadline_abs if req._deadline_abs is not None else _INF
        return (d, req._seq)

    def _enqueue(self, req: Request) -> None:
        """Insert keeping the queue sorted by (deadline, submission
        order): plain FIFO when no request has a deadline."""
        key = self._edf_key(req)
        if not self.queue or self._edf_key(self.queue[-1]) <= key:
            self.queue.append(req)
            return
        for i, r in enumerate(self.queue):
            if self._edf_key(r) > key:
                self.queue.insert(i, req)
                return
        self.queue.append(req)

    def _measured_substep_s(self) -> Optional[float]:
        """Measured wall seconds per decode substep (None before any
        megastep ran): the basis of the retry-after hints and the
        infeasible-deadline shed."""
        if self.stats.steps == 0 or self.stats.decode_wall_s == 0.0:
            return None
        return self.stats.decode_wall_s / self.stats.steps

    def _service_substeps(self, req: Request) -> int:
        """Substeps a request holds a slot for: chunked admission feeds
        the prompt one token a substep, stall admission prefills it in
        one call."""
        gen = max(self._eff_max_new(req), 1)
        if self.admission == "chunked":
            return len(self._eff_prompt(req)) + gen
        return gen

    def _pick_victim(self, incoming: Request) -> Optional[int]:
        """The slot a pool-starved admission of ``incoming`` may preempt:
        only one whose EDF key is strictly later (a later deadline, or
        none and a later submission), so that a requeued request can
        never preempt the one that displaced it (no livelock). Among
        those, a slot without shared prefix pages first (it frees more
        blocks and loses no registry value), then the least progress
        (the least to recompute)."""
        key = self._edf_key(incoming)
        cands = [s for s, r in enumerate(self.active)
                 if r is not None and not r.done
                 and self._edf_key(r) > key]
        if not cands:
            return None
        return min(cands, key=lambda s: (
            self._slot_shared[s] > 0,
            len(self.active[s].output) + self._prefill_pos[s]))

    def _retire_on_device(self, s: int) -> None:
        """Set slot s idle on the device, on the engine's stream: the
        frozen-write retirement EOS takes, landing after the megastep in
        flight and before the next one."""
        with self._on_stream():
            self.state.phase[s] = PHASE_IDLE

    def _preempt_slot(self, s: int,
                      admit: Optional[Dict[str, np.ndarray]] = None
                      ) -> Request:
        """Evict slot s: retire it on the device (a megastep in flight
        still emits its tokens, which its drain appends before the
        request can be readmitted), recycle its blocks (shared ones
        survive through their refcount), clear its staged chunk refill
        when the admission buffer is already built, and requeue the
        request to resume from its prompt and generated tokens."""
        req = self.active[s]
        self._retire_on_device(s)
        self.active[s] = None
        self._stochastic_slots.discard(s)
        self._prefill_pos[s] = 0
        self._slot_prompt[s] = None
        if self.paged:
            self._release_slot_blocks(s)
        if admit is not None:
            admit["refill"][s] = 0
            admit["tokens"][s, :] = 0
            admit["base"][s] = 0
        req.preemptions += 1
        self.stats.preemptions += 1
        self._enqueue(req)
        return req

    def preempt(self, req: Request) -> bool:
        """Preempt an active request (what a pool-starved admission does;
        also the fault injector's ``preempt`` event). Returns False when
        the request holds no slot. It resumes through the queue, with the
        same greedy tokens."""
        if req.done or req.cancelled:
            return False
        for s, r in enumerate(self.active):
            if r is req:
                self._preempt_slot(s)
                return True
        return False

    def inject_logit_poison(self, req: Request) -> None:
        """Fault injection: the megastep turns this request's logits to
        NaN while it holds a slot, so that the finiteness check retires
        it (the path a real nonfinite output takes)."""
        self._poison_uids.add(req.uid)

    # -- public API --------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Queue a request, in EDF order. An empty prompt or a negative
        budget is rejected, and a zero budget completes at once with no
        output. Typed rejects (``SubmitReject``): ``PromptTooLong`` for a
        request that can never fit the cache (more pages than a paged
        pool holds, or a prompt longer than a dense full-attention
        cache, whose prefill write would corrupt the slot; a windowed
        ring, or a paged cache, takes a longer prompt over its own
        positions, and a recurrent state any length), as the JAX
        ``submit`` rejects,
        ``QueueFull`` at the ``max_queue`` bound, ``InfeasibleDeadline``
        when ``req.deadline_s`` cannot be met by an empty engine."""
        prompt_len = len(np.asarray(req.prompt))
        if prompt_len == 0:
            raise ValueError(
                f"request {req.uid}: empty prompt — decode needs at least "
                "one prompt token")
        if req.max_new_tokens < 0:
            raise ValueError(f"request {req.uid}: max_new_tokens must be "
                             f">= 0 (got {req.max_new_tokens})")
        if req.max_new_tokens == 0:
            req.done = True
            return
        if self.paged:
            need = min(prompt_len + req.max_new_tokens, self.max_len)
            pages = -(-need // self.page_size)
            if pages > self.cache_blocks - 1:
                raise PromptTooLong(
                    f"request {req.uid}: needs {pages} cache pages but the "
                    f"pool holds {self.cache_blocks - 1}: it can never be "
                    "admitted (raise cache_blocks or shrink the request)",
                    uid=req.uid)
        elif (not self._has_window and not self.cfg.is_recurrent
              and prompt_len > self._cache_seq):
            raise PromptTooLong(
                f"request {req.uid}: prompt of {prompt_len} tokens exceeds "
                f"the cache capacity {self._cache_seq}", uid=req.uid)
        if self.max_queue and len(self.queue) >= self.max_queue:
            self.stats.shed += 1
            sub = self._measured_substep_s()
            hint = None
            if sub is not None:
                backlog = sum(self._service_substeps(r) for r in self.queue)
                hint = sub * backlog / max(self.slots, 1)
            raise QueueFull(
                f"request {req.uid}: queue at its bound ({self.max_queue});"
                f" retry after "
                f"{'%.3fs' % hint if hint is not None else 'a drain'}",
                uid=req.uid, retry_after_s=hint,
                queue_depth=len(self.queue))
        if req.deadline_s is not None:
            est = (self._measured_substep_s() or 0.0) * \
                self._service_substeps(req)
            if req.deadline_s <= 0 or est > req.deadline_s:
                self.stats.shed += 1
                raise InfeasibleDeadline(
                    f"request {req.uid}: deadline {req.deadline_s:.3f}s < "
                    f"estimated service {est:.3f}s even unqueued",
                    uid=req.uid, queue_depth=len(self.queue))
            req._deadline_abs = time.monotonic() + req.deadline_s
        req._seq = self._submit_seq
        self._submit_seq += 1
        self._enqueue(req)

    def cancel(self, req: Request) -> bool:
        """Retire a request at once. A queued one leaves the queue; an
        active one has its slot set idle on the device (the frozen-write
        retirement EOS takes, so a megastep in flight leaves its cache
        alone, and its late tokens are dropped at the drain) and its
        blocks recycled (shared prefix pages survive through their
        refcount). The slot is refilled at the next admission. Returns
        True if the request was live. A preempted request is in the
        queue, so its cancel takes the queue path: its slot and blocks
        were released at the preemption."""
        if req.done:
            return False
        self._poison_uids.discard(req.uid)
        try:
            self.queue.remove(req)
        except ValueError:
            pass
        else:
            req.done = req.cancelled = True
            self.stats.cancelled += 1
            return True
        for s, r in enumerate(self.active):
            if r is req:
                self._retire_on_device(s)
                self._free_slot(s)
                req.done = req.cancelled = True
                self.stats.cancelled += 1
                return True
        return False

    @property
    def in_flight(self) -> int:
        """Megasteps dispatched and not yet drained (< pipeline_depth
        between steps)."""
        return len(self._inflight)

    def has_work(self) -> bool:
        """True while anything is queued, holds a slot, or rides a
        megastep not yet drained."""
        return bool(self.queue) or bool(self._inflight) or \
            any(r is not None for r in self.active)

    def step(self) -> int:
        """Admit what fits, dispatch one megastep, and drain the oldest
        in flight once ``pipeline_depth`` are outstanding: at depth 1 the
        one just dispatched, at depth 2 the previous one, so its drain
        and the next staging overlap the megastep on the device. With no
        slot occupied in the host's view it dispatches nothing and drains
        every megastep in flight. Returns the number of slots occupied."""
        t0 = time.perf_counter()
        with self._on_stream():
            if self._dispatch_megastep():
                while len(self._inflight) >= max(self.pipeline_depth, 1):
                    self._drain_oldest()
            else:
                while self._inflight:
                    self._drain_oldest()
        self.stats.decode_wall_s += time.perf_counter() - t0
        if self.audit_every_step:
            self.audit()
        return sum(r is not None for r in self.active)

    def run(self, max_steps: int = 10000) -> None:
        """Serve until the queue, the slots and the pipeline are empty
        (at most ``max_steps`` steps)."""
        for _ in range(max_steps):
            if not self.has_work():
                return
            self.step()

    # -- admission -----------------------------------------------------------
    def _req_sampling(self, req: Request):
        smp = self.sampling
        return (smp.temperature if req.temperature is None else req.temperature,
                smp.top_k if req.top_k is None else req.top_k,
                smp.top_p if req.top_p is None else req.top_p)

    def _admit_fields(self, buf: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Views of the packed admission buffer ``buf``, by field."""
        n, rows = self.slots, len(self._admit_rows)
        head = buf[:rows * n].view(rows, n)
        fields = {name: head[i] for i, name in enumerate(self._admit_rows)}
        for name in ADMIT_F32_ROWS:
            fields[name] = fields[name].view(torch.float32)
        at = rows * n + n * self.prefill_chunk
        fields["tokens"] = buf[rows * n:at].view(n, self.prefill_chunk)
        if self.paged:
            fields["block_table"] = buf[at:].view(n, self.max_pages)
        return fields

    def _empty_admit(self) -> Dict[str, np.ndarray]:
        """The ring entry the next megastep stages into, cleared to
        "nothing admitted", as numpy views by field. The entry is one no
        megastep in flight uses: its host→device copy has run, so it may
        be written."""
        busy = {entry for entry, _, _ in self._inflight}
        self._grow_rings()
        self._stage = next(i for i in range(len(self._admit_ring))
                           if i not in busy)
        self._admit_host.zero_()
        admit = {name: t.numpy() for name, t in
                 self._admit_fields(self._admit_host).items()}
        admit["eos"][:] = -1
        admit["top_p"][:] = 1.0
        return admit

    def _fill_slots(self) -> Dict[str, np.ndarray]:
        """Stage the next megastep's admissions (and, under stall
        admission, run the prefill calls); returns the staged buffer."""
        if self.admission == "chunked":
            admit = self._fill_slots_chunked()
        else:
            self._fill_slots_stall()
            admit = self._empty_admit()
        if self._poison_uids:
            for s, r in enumerate(self.active):
                if r is not None and r.uid in self._poison_uids:
                    admit["poison"][s] = 1
        return admit

    def _bucket_len(self, prompt_len: int) -> int:
        """Padded prefill length: the next power of two (at least 8),
        capped at the cache's length, so that a padded prefill never
        takes the ring write; a prompt longer than the cache (which only
        the ring takes), and any prompt of a recurrent family (whose state
        padding would corrupt), at its exact length."""
        if self.cfg.is_recurrent or prompt_len > self._cache_seq:
            return prompt_len
        return min(max(8, 1 << (prompt_len - 1).bit_length()),
                   self._cache_seq)

    def _take_free(self, admit: Optional[Dict[str, np.ndarray]] = None
                   ) -> List:
        """Pair free slots with queued requests, in EDF order; returns
        (slot, request, start position) triples. A request that still
        rides the occupant snapshot of a megastep in flight (preempted
        since) waits: that drain appends its pre-preemption tokens, and a
        resume before it would generate them again. A paged engine
        allocates each one's blocks; a request the pool cannot serve
        preempts an eligible victim (``_pick_victim``; ``admit`` is the
        staged buffer whose refill entry the victim's preemption clears)
        or goes back to the head of the queue with every request taken
        behind it (FIFO blocking: a later request must not jump an
        admission-starved head)."""
        free = [s for s in range(self.slots) if self.active[s] is None]
        pending = {id(r) for _, _, occ in self._inflight
                   for r in occ if r is not None}
        taken, held = [], []
        while free and self.queue:
            req = self.queue.popleft()
            # a request cancelled or finished while requeued: drop it
            if req.done or req.cancelled:
                continue
            if id(req) in pending:
                held.append(req)
                continue
            taken.append((free.pop(0), req))
        # held requests came off the head: back at the head, in order
        self.queue.extendleft(reversed(held))
        if not self.paged:
            return [(s, req, 0) for s, req in taken]
        admitted, putback = [], []
        for s, req in taken:
            start = None if putback else self._admit_paged(s, req)
            while start is None and not putback:
                v = self._pick_victim(req)
                if v is None:
                    break
                self._preempt_slot(v, admit)
                start = self._admit_paged(s, req)
            if start is None:
                putback.append(req)
            else:
                admitted.append((s, req, start))
        self.queue.extendleft(reversed(putback))
        return admitted

    def _fill_slots_stall(self) -> None:
        """Stall admission: length-bucketed prefill calls into the free
        slots, run between megasteps while decoding slots wait."""
        buckets: Dict[int, List] = {}
        for s, req, _ in self._take_free():
            p = self._eff_prompt(req)
            buckets.setdefault(self._bucket_len(len(p)), []).append(
                (s, req, p))
        for blen, group in buckets.items():
            n = len(group)
            toks = np.full((n, blen), PAD_ID, np.int32)
            for i, (_, _, p) in enumerate(group):
                toks[i, :len(p)] = p
            smp = [self._req_sampling(r) for _, r, _ in group]
            table_rows = (np.stack([self._slot_table_row(s)
                                    for s, _, _ in group])
                          if self.paged else None)
            first = self._prefill_impl(
                toks, np.asarray([len(p) for _, _, p in group], np.int32),
                np.asarray([s for s, _, _ in group], np.int64),
                np.asarray([self._eff_max_new(r) for _, r, _ in group],
                           np.int32),
                np.asarray([r.eos_id for _, r, _ in group], np.int32),
                np.asarray([v[0] for v in smp], np.float32),
                np.asarray([v[1] for v in smp], np.int32),
                np.asarray([v[2] for v in smp], np.float32), table_rows)
            self.stats.prefill_batches += 1
            for i, (s, req, p) in enumerate(group):
                tok = int(first[i])
                req.output.append(tok)
                self.stats.prefills += 1
                self.stats.tokens_generated += 1
                self._prefill_pos[s] = len(p)
                if tok == req.eos_id or len(req.output) >= req.max_new_tokens:
                    req.done = True       # the first token already ends it
                    if self.paged:
                        self._release_slot_blocks(s)
                    continue
                self.active[s] = req
                self._slot_prompt[s] = p
                if smp[i][0] > 0.0:
                    self._stochastic_slots.add(s)

    def _prefill_impl(self, tokens: np.ndarray, seq_lens: np.ndarray,
                      slot_idx: np.ndarray, max_new: np.ndarray,
                      eos_id: np.ndarray, temp: np.ndarray,
                      top_k: np.ndarray, top_p: np.ndarray,
                      table_rows: Optional[np.ndarray] = None
                      ) -> np.ndarray:
        """Prefill one length bucket (n, S) into a scratch cache, copy
        its rows into the live cache at ``slot_idx`` (n,) (a paged
        engine scatters its pages into the blocks ``table_rows``
        (n, max_pages) name: ``_paged_splice``), sample the first tokens
        and set the slots' state for decoding. Returns the first tokens
        on the host (the call's one sync)."""
        dev = self.device
        n = tokens.shape[0]
        lens = torch.as_tensor(seq_lens, device=dev)
        idx = torch.as_tensor(slot_idx, device=dev)
        one = self.model.init_cache(n, self.max_len)
        logits = self.model.prefill(
            self.params, torch.as_tensor(tokens, device=dev).long(), one,
            seq_lens=lens)
        if self.paged:
            self._paged_splice(one, seq_lens, table_rows)
            self.cache["block_table"].index_copy_(
                0, idx, torch.as_tensor(table_rows, device=dev))
        else:
            for live, scratch in zip(self.cache["layers"], one["layers"]):
                for name, leaf in live.items():
                    leaf.index_copy_(0, idx, scratch[name])
        self.cache["lens"].index_copy_(0, idx, one["lens"])
        st = self.state
        t_temp = torch.as_tensor(temp, device=dev)
        t_topk = torch.as_tensor(top_k, device=dev)
        t_topp = torch.as_tensor(top_p, device=dev)
        if (temp > 0.0).any():
            first = sample_batched(logits, self.generator, t_temp, t_topk,
                                   t_topp)
        else:
            first = torch.argmax(logits, dim=-1).to(torch.int32)
        t_max_new = torch.as_tensor(max_new, device=dev)
        t_eos = torch.as_tensor(eos_id, device=dev)
        alive = (first != t_eos) & (t_max_new > 1)
        lens = lens.to(torch.int32)
        for field, val in (
                ("last_token", first), ("gen_len", torch.ones_like(first)),
                ("max_new", t_max_new), ("eos_id", t_eos),
                ("phase", torch.where(alive, PHASE_DECODE, PHASE_IDLE)),
                ("prefill_pos", lens), ("prompt_len", lens),
                ("temperature", t_temp), ("top_k", t_topk),
                ("top_p", t_topp)):
            t = getattr(st, field)
            t.index_copy_(0, idx, val.to(t.dtype))
        # the call's one sync. On the engine's stream it also waits for a
        # megastep still in flight, which is issued before this prefill:
        # its slots were idle in it, so the order is right, and the wait
        # is the stall that stall admission is
        return first.cpu().numpy()

    def _paged_splice(self, one: Dict, seq_lens: np.ndarray,
                      table_rows: np.ndarray) -> None:
        """Scatter a dense scratch cache's rows into the pools, page by
        page: page j of scratch row i goes to block ``table_rows[i, j]``.
        Only the pages that hold a prompt's positions are written, all
        of them the slot's own blocks (a page past them would name the
        garbage block, and two rows landing on one block in one scatter
        would race); the padding's junk inside the last page lies past
        ``lens``, where decode overwrites it before reading it. A prompt
        longer than the cache was written into the scratch cache's ring,
        whose ``max_pages`` pages are then all copied: position pos sits
        at ring slot ``pos % max_len``, where decode reads it."""
        P = self.page_size
        src_row, src_page, dst = [], [], []
        for i, n in enumerate(seq_lens):
            for j in range(min(-(-int(n) // P), self.max_pages)):
                src_row.append(i)
                src_page.append(j)
                dst.append(int(table_rows[i, j]))
        dev = self.device
        src_row = torch.as_tensor(src_row, device=dev)
        src_page = torch.as_tensor(src_page, device=dev)
        dst = torch.as_tensor(dst, device=dev)
        for live, scratch in zip(self.cache["layers"], one["layers"]):
            for name, pool in live.items():
                rows = scratch[name]               # (n, Hkv, S, d)
                n, Hkv, S, d = rows.shape
                pages = rows.view(n, Hkv, S // P, P, d)[src_row, :, src_page]
                pool.index_copy_(0, dst, pages)

    def _fill_slots_chunked(self) -> Dict[str, np.ndarray]:
        """Host side of admission: the next prompt chunk for slots still
        prefilling, first chunk and metadata for queued requests taken
        into free slots (a resumed request's prompt is its own and the
        tokens it generated), packed into the admission buffer that rides
        into the next megastep."""
        admit = self._empty_admit()
        chunk = self.prefill_chunk
        for s, req in enumerate(self.active):
            prompt = self._slot_prompt[s]
            pos = self._prefill_pos[s]
            if req is None or prompt is None or pos >= len(prompt):
                continue
            admit["refill"][s] = 1
            admit["base"][s] = pos
            seg = prompt[pos:pos + chunk]
            admit["tokens"][s, :len(seg)] = seg
            if pos > 0:
                self.stats.chunk_refills += 1
        for s, req, start in self._take_free(admit):
            prompt = self._eff_prompt(req)
            if self.paged:
                admit["start_pos"][s] = start
                admit["block_table"][s] = self._slot_table_row(s)
            admit["new"][s] = 1
            admit["base"][s] = start
            seg = prompt[start:start + chunk]
            admit["tokens"][s, :len(seg)] = seg
            admit["prompt_len"][s] = len(prompt)
            admit["max_new"][s] = self._eff_max_new(req)
            admit["eos"][s] = req.eos_id
            temp, topk, topp = self._req_sampling(req)
            admit["temp"][s] = temp
            admit["top_k"][s] = topk
            admit["top_p"][s] = topp
            self.active[s] = req
            self._slot_prompt[s] = prompt
            self._prefill_pos[s] = start
            if temp > 0.0:
                self._stochastic_slots.add(s)
            self.stats.prefills += 1
            self.stats.inscan_admissions += 1
        return admit

    def _merge_admissions(self) -> None:
        """Fold the admission buffer (on the device) into the device
        state by masked updates, inside the megastep's program as in the
        JAX package: fresh slots get their cache rows and ``lens`` zeroed
        and their slot state rebuilt; chunk refills only swap the prompt
        window. Under paging a fresh slot's ``lens`` and prompt cursor
        start at its cached-prefix length and its table row is mapped in;
        the pools are not zeroed (junk past ``lens`` is never read)."""
        a = self._admit
        new = a["new"] != 0
        upd = new | (a["refill"] != 0)
        st = self.state
        lens = self.cache["lens"]
        if self.paged:
            table = self.cache["block_table"]
            table.copy_(torch.where(new[:, None], a["block_table"], table))
            lens.copy_(torch.where(new, a["start_pos"], lens))
            st.prefill_pos.copy_(torch.where(new, a["start_pos"],
                                             st.prefill_pos))
        else:
            for layer in self.cache["layers"]:
                for leaf in layer.values():
                    leaf.masked_fill_(
                        new.view((-1,) + (1,) * (leaf.dim() - 1)), 0)
            lens.masked_fill_(new, 0)
            st.prefill_pos.masked_fill_(new, 0)
        for field, key in (("max_new", "max_new"), ("eos_id", "eos"),
                           ("prompt_len", "prompt_len"),
                           ("temperature", "temp"), ("top_k", "top_k"),
                           ("top_p", "top_p")):
            t = getattr(st, field)
            t.copy_(torch.where(new, a[key], t))
        for field, val in (("last_token", 0), ("gen_len", 0),
                           ("phase", PHASE_PREFILL)):
            getattr(st, field).masked_fill_(new, val)
        st.chunk_base.copy_(torch.where(upd, a["base"], st.chunk_base))
        st.prompt_buf.copy_(torch.where(upd[:, None], a["tokens"],
                                        st.prompt_buf))

    # -- fused K-substep decode ----------------------------------------------
    def _dispatch_megastep(self) -> bool:
        """Dispatch half of a step: stage the admissions from the host's
        view of the slots and issue one megastep: the staged ring entry
        to the device, the body (one graph replay on the card), the
        packed (4, K, slots) int32 block (tokens, emitted, prefill
        position, nonfinite) back to the same ring entry, and a CUDA
        event after that copy. It rides ``_inflight`` with a snapshot of
        the slots' occupants until ``_drain_oldest``. Returns False when
        no slot is occupied in the host's view (nothing is issued)."""
        t0 = time.perf_counter()
        self._fill_slots()
        self.stats.stage_wall_s += time.perf_counter() - t0
        if not any(r is not None for r in self.active):
            return False
        all_greedy = not self._stochastic_slots
        event = None
        if self._on_card:
            graph = self._graphs.get(all_greedy) or self._capture(all_greedy)
            self._admit_dev.copy_(self._admit_host, non_blocking=True)
            graph.replay()
            self.stats.graph_replays += 1
            self._block_host.copy_(self._block, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            self._admit_dev.copy_(self._admit_host)
            self._megastep_body(all_greedy, self.generator)
            self._block_host.copy_(self._block)
        self._inflight.append((self._stage, event, tuple(self.active)))
        self.stats.megasteps += 1
        self.stats.steps += self.megastep_k
        return True

    def _capture(self, all_greedy: bool) -> "torch.cuda.CUDAGraph":
        """Capture the megastep body as a CUDA graph on the capture
        stream, after a warmup there (``_warm_up``) that sets the
        kernels' one-time state outside the capture: shared-memory
        attributes, decode attention's tickets, cuBLAS's workspace. The
        graph that samples has the engine's generator registered, so each
        replay draws fresh numbers from it. Records the kernel launches
        the capture enqueued (``graph_launches``)."""
        stream = self._capture_stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            self._warm_up(all_greedy)
        stream.synchronize()
        before = ops.launch_counts()
        graph = torch.cuda.CUDAGraph()
        if not all_greedy:
            graph.register_generator_state(self.generator)
        with torch.cuda.graph(graph, stream=stream):
            self._megastep_body(all_greedy, self.generator)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        after = ops.launch_counts()
        self.graph_launches[all_greedy] = {
            name: after[name] - before[name] for name in after}
        self._graphs[all_greedy] = graph
        self.stats.graph_captures += 1
        return graph

    def _warm_up(self, all_greedy: bool) -> None:
        """One eager run of the body with every slot idle and nothing
        admitted: it writes no cache row, advances no ``lens`` and leaves
        the slot state as it was; it samples from a scratch generator, so
        the engine's own is untouched. Only the block is overwritten."""
        st = self.state
        phase = st.phase.clone()
        st.phase.fill_(PHASE_IDLE)
        self._admit_dev.zero_()
        scratch = torch.Generator(device=self.device)
        scratch.manual_seed(self.seed)
        self._megastep_body(all_greedy, scratch)
        st.phase.copy_(phase)

    def _megastep_body(self, all_greedy: bool,
                       generator: torch.Generator) -> None:
        """The device side of a megastep, with no host read: the
        admission merge, then K substeps of decode_step with in-loop
        sampling and retirement, each writing its row of the block."""
        self._merge_admissions()
        poison = self._admit["poison"] != 0
        st = self.state
        chunk = self.prefill_chunk
        for k in range(self.megastep_k):
            is_pre = st.phase == PHASE_PREFILL
            is_dec = st.phase == PHASE_DECODE
            off = torch.clamp(st.prefill_pos - st.chunk_base, 0, chunk - 1)
            ptok = torch.gather(st.prompt_buf, 1, off[:, None].long())[:, 0]
            # a prefilling slot whose chunk ran dry waits, cache frozen,
            # for the host's refill (only when the chunk < megastep_k)
            starved = is_pre & (st.prefill_pos - st.chunk_base >= chunk)
            feeding = is_pre & ~starved
            in_tok = torch.where(is_pre, ptok, st.last_token)
            logits = self.model.decode_step(
                self.params, in_tok[:, None].long(), self.cache,
                advance_mask=feeding | is_dec)
            # a poisoned slot's logits turn NaN here, so that the
            # finiteness check below retires it (fault injection)
            logits = torch.where(poison[:, None], float("nan"), logits)
            bad = (is_pre | is_dec) & ~torch.isfinite(logits).all(dim=-1)
            if all_greedy:
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
            else:
                tok = sample_batched(logits, generator, st.temperature,
                                     st.top_k, st.top_p)
            finishing = feeding & (st.prefill_pos + 1 >= st.prompt_len)
            emit = (is_dec | finishing) & ~bad
            tok = torch.where(emit, tok, torch.full_like(tok, PAD_ID))
            st.gen_len += emit.to(torch.int32)
            done_now = emit & ((tok == st.eos_id) | (st.gen_len >= st.max_new))
            phase = torch.where(
                emit, torch.where(done_now, PHASE_IDLE, PHASE_DECODE),
                st.phase)
            st.phase.copy_(torch.where(bad, PHASE_IDLE, phase))
            st.last_token.copy_(torch.where(emit, tok, st.last_token))
            st.prefill_pos += feeding.to(torch.int32)
            self._block[:, k].copy_(torch.stack(
                [tok, emit.to(torch.int32), st.prefill_pos,
                 bad.to(torch.int32)]))

    def _drain_oldest(self) -> None:
        """Drain half: wait for the oldest megastep in flight (its event;
        never the whole stream, which would wait for the next megastep
        too) and hand its block's tokens and retirements to the requests
        that rode it: its occupant snapshot, not the host's view, which
        may have moved on (a slot freed by an earlier drain can already
        hold a newer request, idle throughout this block)."""
        entry, event, occupants = self._inflight.popleft()
        t0 = time.perf_counter()
        if event is not None:
            event.synchronize()
        self.stats.drain_wait_s += time.perf_counter() - t0
        block = self._block_ring[entry].numpy()
        toks, emitted = block[0], block[1].astype(bool)
        last_pos = block[2][-1]
        bad = block[3].astype(bool).any(axis=0)
        for s in range(self.slots):
            # the prompt cursor mirror moves only while the slot still
            # serves this block's request: a retired occupant's position
            # must not become a newer request's refill base. A nonfinite
            # slot is about to be retired: no move, no published page.
            req = occupants[s]
            if req is None or bad[s] or self.active[s] is not req:
                continue
            self._prefill_pos[s] = int(last_pos[s])
            # its own prompt is consumed, so its pages exist on the
            # device: publish them
            if (self.prefix_cache and not self._slot_reg_done[s]
                    and self._prefill_pos[s] >= len(req.prompt)):
                self._register_prefix(s, np.asarray(req.prompt, np.int32))
        for k in range(toks.shape[0]):
            for s in range(self.slots):
                req = occupants[s]
                if req is None or req.cancelled or not emitted[k, s]:
                    continue
                tok = int(toks[k, s])
                req.output.append(tok)
                self.stats.tokens_generated += 1
                if tok == req.eos_id or len(req.output) >= req.max_new_tokens:
                    req.done = True        # the device already froze it
                    if self.active[s] is req:
                        self._free_slot(s)
        # a slot the device flagged nonfinite is frozen already; its
        # request fails with the tokens it emitted before
        for s in range(self.slots):
            req = occupants[s]
            if not bad[s] or req is None or req.done or req.cancelled:
                continue
            req.error = "nonfinite-logits"
            req.done = True
            self.stats.poisoned += 1
            self._poison_uids.discard(req.uid)
            if self.active[s] is req:
                self._free_slot(s)

    def _free_slot(self, s: int) -> None:
        self.active[s] = None
        self._stochastic_slots.discard(s)
        self._slot_prompt[s] = None
        if self.paged:
            self._release_slot_blocks(s)


def _quantized_formats(params) -> set:
    if isinstance(params, QuantizedTensor):
        return {params.fmt}
    if isinstance(params, dict):
        params = list(params.values())
    if isinstance(params, list):
        return set().union(*(_quantized_formats(p) for p in params))
    return set()
