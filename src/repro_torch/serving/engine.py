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
  length (the next power of two, at least 8, capped at ``max_len``) and
  each group is prefilled in one ``Model.prefill`` call into a scratch
  cache, whose rows are copied into the live cache at the slots. The
  first token is sampled from the prefill's logits; decoding slots
  stall meanwhile.
- **Retirement**: a slot that emits EOS or reaches its budget turns
  idle; idle and waiting slots ride the fixed-shape batch with
  ``advance_mask`` False, so their cache rows are never written.
- **Nonfinite logits**: a slot whose logits hold a NaN or inf emits
  nothing, turns idle at once, and its request ends with
  ``error = "nonfinite-logits"``; the other slots are untouched.
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

On the card a megastep is one device program, as the JAX package's
jitted megastep is: the admission merge and the K substeps
(``_megastep_body``) are captured once as a CUDA graph per value of
``all_greedy`` (at most two graphs, the second when first needed), and
each megastep is one host→device copy of the packed admission buffer,
one ``graph.replay()`` and one device→host copy of the block. On the
CPU the same body runs eagerly. The cache, the slot state, the
admission buffers, the block and the sampling generator keep their
addresses for the engine's life (``reset()`` zeroes and reseeds them in
place), so the graphs stay valid; that also replaces the JAX package's
donated megastep carries, so the port has no ``donate_carries`` knob.
``audit()`` checks the allocator's and the slots' invariants between
steps (``audit_every_step`` runs it after each).
Left out so far: pipelined dispatch, preemption and the resume of
preempted requests (a short pool therefore always blocks FIFO, as the
JAX engine does when no request has a deadline), the EDF queue, the
typed overload rejects, cancellation and fault injection.
"""
from __future__ import annotations

import collections
import dataclasses
import time
import warnings
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import WEIGHT_FORMATS
from repro_torch.kernels import ops
from repro_torch.models import Model
from repro_torch.quant.quantize import (FLOAT_FORMATS, QuantizedTensor,
                                        quantize_tree)
from repro_torch.serving.sampler import SamplingConfig, sample_batched

DEFAULT_MEGASTEP_K = 8
ADMISSIONS = ("chunked", "stall")
PAD_ID = 0

PHASE_IDLE = 0      # retired / never filled: cache frozen, no emission
PHASE_PREFILL = 1   # consuming prompt tokens, no emission yet
PHASE_DECODE = 2    # generating: sample + emit every substep

# The packed admission buffer: one int32 row of ``slots`` per field
# (``temp`` and ``top_p`` hold f32 bits; a paged engine adds
# ``start_pos``, the cached-prefix length a fresh slot starts at), then
# the (slots, chunk) prompt tokens, then (paged) the fresh slots'
# (slots, max_pages) block-table rows.
ADMIT_ROWS = ("new", "refill", "base", "prompt_len", "max_new", "eos",
              "temp", "top_k", "top_p")
ADMIT_PAGED_ROWS = ("start_pos",)
ADMIT_F32_ROWS = ("temp", "top_p")


class PromptTooLong(ValueError):
    """The prompt can never fit this engine's cache: admitting it would
    write past the slot's rows and corrupt its own stream."""


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
    # filled by the engine:
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    error: Optional[str] = None      # e.g. "nonfinite-logits"


@dataclasses.dataclass
class EngineStats:
    steps: int = 0               # decode substeps executed (K per megastep)
    megasteps: int = 0
    tokens_generated: int = 0
    prefills: int = 0            # requests admitted
    prefill_batches: int = 0     # stall-path prefill calls
    chunk_refills: int = 0       # prompt chunks refreshed after the first
    poisoned: int = 0            # requests retired on nonfinite logits
    graph_captures: int = 0      # megastep graphs captured (card only)
    graph_replays: int = 0       # megasteps served by a graph replay
    prefix_hits: int = 0         # admissions that reused cached blocks
    prefix_hit_tokens: int = 0   # prompt tokens skipped via shared pages
    blocks_recycled: int = 0     # pool blocks returned to the free list
    decode_wall_s: float = 0.0   # wall time in step()


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
                 quant_policy: Optional[str] = None,
                 kv_quant: Optional[str] = None,
                 admission: str = "chunked",
                 page_size: int = 0, cache_blocks: int = 0,
                 prefix_cache: bool = False):
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
        self.kv_quant = model.cfg.kv_quant
        if quant_policy is not None and quant_policy not in FLOAT_FORMATS:
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
        # prompt tokens staged on the device per slot; any value >=
        # megastep_k keeps a prefilling slot fed for a whole megastep
        self.prefill_chunk = max(self.megastep_k, 16)
        self.queue: Deque[Request] = collections.deque()
        self.audit_every_step = False     # audit() after every step()
        if int(page_size) < 0:
            raise ValueError(f"page_size must be >= 0 (got {page_size})")
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
        on_card = dev.type == "cuda"
        n, k = slots, self.megastep_k
        self.generator = torch.Generator(device=dev)
        self.cache = model.init_cache(slots, max_len, self.page_size,
                                      self.cache_blocks)
        self.state = _init_slot_state(slots, self.prefill_chunk, dev)
        self._admit_rows = ADMIT_ROWS + (ADMIT_PAGED_ROWS if self.paged
                                         else ())
        size = (len(self._admit_rows) * n + n * self.prefill_chunk
                + n * self.max_pages)
        self._admit_host = torch.zeros((size,), dtype=torch.int32,
                                       pin_memory=on_card)
        self._admit_dev = torch.zeros((size,), dtype=torch.int32, device=dev)
        self._admit = self._admit_fields(self._admit_dev)
        self._block = torch.zeros((4, k, n), dtype=torch.int32, device=dev)
        self._block_host = torch.zeros((4, k, n), dtype=torch.int32,
                                       pin_memory=on_card)
        self._graphs: Dict[bool, "torch.cuda.CUDAGraph"] = {}
        # kernel launches one capture recorded, by graph (all_greedy)
        self.graph_launches: Dict[bool, Dict[str, int]] = {}
        self._capture_stream = torch.cuda.Stream(dev) if on_card else None
        self.reset()

    def reset(self) -> None:
        """Drop all requests and zero the device state in place (cache or
        pools, lens, block table, slot state; the sampling generator
        reseeded), so that the captured graphs, which hold these
        addresses, stay valid. The block allocator starts empty."""
        self.generator.manual_seed(self.seed)
        for layer in self.cache["layers"]:
            for leaf in layer.values():
                leaf.zero_()
        self.cache["lens"].zero_()
        if self.paged:
            self.cache["block_table"].zero_()
        # the block allocator: a free list and refcounts. Block 0 is the
        # garbage block and never handed out. ``_prefix_reg`` maps a
        # prompt prefix (its tokens' bytes, whole pages) to the pool
        # block of its last page, LRU first; the registry holds its own
        # reference, so a cached page outlives its request.
        self._free: List[int] = list(range(self.cache_blocks - 1, 0, -1))
        self._ref = np.zeros((self.cache_blocks,), np.int64)
        self._slot_blocks: List[List[int]] = [[] for _ in range(self.slots)]
        self._slot_reg_done: List[bool] = [False] * self.slots
        self._prefix_reg: "collections.OrderedDict[bytes, int]" = \
            collections.OrderedDict()
        # blocks withheld from the allocator: an owner class of their own
        self._quarantined: List[int] = []
        fresh = _init_slot_state(self.slots, self.prefill_chunk, self.device)
        for f in dataclasses.fields(SlotState):
            getattr(self.state, f.name).copy_(getattr(fresh, f.name))
        self.active: List[Optional[Request]] = [None] * self.slots
        # host mirror of each slot's prompt cursor, and the prompt it
        # was admitted with
        self._prefill_pos: List[int] = [0] * self.slots
        self._slot_prompt: List[Optional[np.ndarray]] = [None] * self.slots
        self._stochastic_slots: set = set()
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
        supply the blocks even after registry eviction (the caller puts
        the request back at the head of the queue)."""
        P = self.page_size
        prompt = np.asarray(req.prompt, np.int32)
        need = min(len(prompt) + req.max_new_tokens, self.max_len)
        n_pages = -(-need // P)
        # a request that outgrows the cache wraps its ring cursor back
        # over its own first pages, which must then be its own: it
        # neither shares nor registers
        wraps = len(prompt) + req.max_new_tokens > self.max_len
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
            if r.done:
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

    # -- public API --------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Queue a request. An empty prompt or a negative budget is
        rejected, a zero budget completes at once with no output, and a
        request that can never fit the cache raises ``PromptTooLong``: a
        prompt longer than a dense cache (or than the scratch cache of a
        paged engine's stall prefill), or more pages than a paged pool
        holds (a chunked prompt longer than the cache rings over its own
        pages)."""
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
                    "admitted (raise cache_blocks or shrink the request)")
        if prompt_len > self.max_len and (not self.paged
                                          or self.admission == "stall"):
            raise PromptTooLong(
                f"request {req.uid}: prompt of {prompt_len} tokens exceeds "
                f"the cache capacity {self.max_len}")
        self.queue.append(req)

    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.active)

    def step(self) -> int:
        """Admit what fits, run one megastep and hand its tokens to the
        requests. Returns the number of slots still occupied."""
        t0 = time.perf_counter()
        self._fill_slots()
        if any(r is not None for r in self.active):
            occupants = tuple(self.active)
            block = self._megastep()
            self._drain(block, occupants)
        self.stats.decode_wall_s += time.perf_counter() - t0
        if self.audit_every_step:
            self.audit()
        return sum(r is not None for r in self.active)

    def run(self, max_steps: int = 10000) -> None:
        """Serve until the queue and the slots are empty (at most
        ``max_steps`` megasteps)."""
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
        """The pinned admission buffer, cleared to "nothing admitted", as
        numpy views by field; the next megastep copies it to the card."""
        self._admit_host.zero_()
        admit = {name: t.numpy() for name, t in
                 self._admit_fields(self._admit_host).items()}
        admit["eos"][:] = -1
        admit["top_p"][:] = 1.0
        return admit

    def _fill_slots(self) -> None:
        if self.admission == "chunked":
            self._fill_slots_chunked()
        else:
            self._fill_slots_stall()
            self._empty_admit()

    def _bucket_len(self, prompt_len: int) -> int:
        """Padded prefill length: the next power of two (at least 8),
        capped at ``max_len`` (``submit`` rejects longer prompts)."""
        return min(max(8, 1 << (prompt_len - 1).bit_length()), self.max_len)

    def _take_free(self) -> List:
        """Pair free slots with queued requests, in order. A paged
        engine allocates each one's blocks; a request the pool cannot
        serve goes back to the head of the queue with every request
        behind it (FIFO blocking: a later request must not jump an
        admission-starved head)."""
        free = [s for s in range(self.slots) if self.active[s] is None]
        taken, putback = [], []
        while free and self.queue:
            s, req = free.pop(0), self.queue.popleft()
            if self.paged:
                start = None if putback else self._admit_paged(s, req)
                if start is None:
                    putback.append(req)
                    continue
            else:
                start = 0
            taken.append((s, req, start))
        self.queue.extendleft(reversed(putback))
        return taken

    def _fill_slots_stall(self) -> None:
        """Stall admission: length-bucketed prefill calls into the free
        slots, run between megasteps while decoding slots wait."""
        buckets: Dict[int, List] = {}
        for s, req, _ in self._take_free():
            p = np.asarray(req.prompt, np.int32)
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
                np.asarray([r.max_new_tokens for _, r, _ in group], np.int32),
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
        return first.cpu().numpy()

    def _paged_splice(self, one: Dict, seq_lens: np.ndarray,
                      table_rows: np.ndarray) -> None:
        """Scatter a dense scratch cache's rows into the pools, page by
        page: page j of scratch row i goes to block ``table_rows[i, j]``.
        Only the pages that hold a prompt's positions are written, all
        of them the slot's own blocks (a page past them would name the
        garbage block, and two rows landing on one block in one scatter
        would race); the padding's junk inside the last page lies past
        ``lens``, where decode overwrites it before reading it."""
        P = self.page_size
        src_row, src_page, dst = [], [], []
        for i, n in enumerate(seq_lens):
            for j in range(-(-int(n) // P)):
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

    def _fill_slots_chunked(self) -> None:
        """Host side of admission: the next prompt chunk for slots still
        prefilling, first chunk and metadata for queued requests taken
        into free slots, packed into the admission buffer that rides into
        the next megastep."""
        admit = self._empty_admit()
        chunk = self.prefill_chunk
        for s, req in enumerate(self.active):
            prompt = self._slot_prompt[s]
            pos = self._prefill_pos[s]
            if req is None or prompt is None or pos >= len(prompt):
                continue
            admit["refill"][s] = True
            admit["base"][s] = pos
            seg = prompt[pos:pos + chunk]
            admit["tokens"][s, :len(seg)] = seg
            if pos > 0:
                self.stats.chunk_refills += 1
        for s, req, start in self._take_free():
            prompt = np.asarray(req.prompt, np.int32)
            if self.paged:
                admit["start_pos"][s] = start
                admit["block_table"][s] = self._slot_table_row(s)
            admit["new"][s] = True
            admit["base"][s] = start
            seg = prompt[start:start + chunk]
            admit["tokens"][s, :len(seg)] = seg
            admit["prompt_len"][s] = len(prompt)
            admit["max_new"][s] = req.max_new_tokens
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
            rows = new[:, None, None, None]
            for layer in self.cache["layers"]:
                for leaf in layer.values():
                    leaf.masked_fill_(rows, 0)
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
    def _megastep(self) -> np.ndarray:
        """One megastep: the admission buffer to the device, the body
        (one graph replay on the card), and the packed (4, K, slots)
        int32 block (tokens, emitted, prefill position, nonfinite) back
        to the host, the megastep's one sync point."""
        all_greedy = not self._stochastic_slots
        if self.device.type == "cuda":
            graph = self._graphs.get(all_greedy) or self._capture(all_greedy)
            self._admit_dev.copy_(self._admit_host, non_blocking=True)
            graph.replay()
            self.stats.graph_replays += 1
            self._block_host.copy_(self._block, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
        else:
            self._admit_dev.copy_(self._admit_host)
            self._megastep_body(all_greedy, self.generator)
            self._block_host.copy_(self._block)
        self.stats.megasteps += 1
        self.stats.steps += self.megastep_k
        return self._block_host.numpy()

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

    def _drain(self, block: np.ndarray, occupants) -> None:
        """Hand the block's tokens and retirements to the requests that
        rode the megastep."""
        toks, emitted = block[0], block[1].astype(bool)
        last_pos = block[2][-1]
        bad = block[3].astype(bool).any(axis=0)
        for s in range(self.slots):
            if occupants[s] is not None and not bad[s]:
                self._prefill_pos[s] = int(last_pos[s])
                # the prompt is consumed, so its pages exist on the
                # device: publish them (a nonfinite slot publishes none)
                prompt = self._slot_prompt[s]
                if (self.prefix_cache and not self._slot_reg_done[s]
                        and self._prefill_pos[s] >= len(prompt)):
                    self._register_prefix(s, prompt)
        for k in range(toks.shape[0]):
            for s in range(self.slots):
                req = occupants[s]
                if req is None or not emitted[k, s]:
                    continue
                tok = int(toks[k, s])
                req.output.append(tok)
                self.stats.tokens_generated += 1
                if tok == req.eos_id or len(req.output) >= req.max_new_tokens:
                    req.done = True        # the device already froze it
                    self._free_slot(s)
        for s in range(self.slots):
            req = occupants[s]
            if bad[s] and req is not None and not req.done:
                req.error = "nonfinite-logits"
                req.done = True
                self.stats.poisoned += 1
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
