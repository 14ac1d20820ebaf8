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
Left out so far: paging and the prefix cache,
pipelined dispatch, preemption and the resume of preempted requests,
the EDF queue, cancellation and fault injection.
"""
from __future__ import annotations

import collections
import dataclasses
import time
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
# (``temp`` and ``top_p`` hold f32 bits), then the (slots, chunk) prompt
# tokens.
ADMIT_ROWS = ("new", "refill", "base", "prompt_len", "max_new", "eos",
              "temp", "top_k", "top_p")
ADMIT_F32_ROWS = ("temp", "top_p")


class PromptTooLong(ValueError):
    """The prompt can never fit this engine's cache: admitting it would
    write past the slot's rows and corrupt its own stream."""


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
                 admission: str = "chunked"):
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
        # device state, allocated once: reset() zeroes it in place
        dev = self.device
        on_card = dev.type == "cuda"
        n, k = slots, self.megastep_k
        self.generator = torch.Generator(device=dev)
        self.cache = model.init_cache(slots, max_len)
        self.state = _init_slot_state(slots, self.prefill_chunk, dev)
        size = len(ADMIT_ROWS) * n + n * self.prefill_chunk
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
        """Drop all requests and zero the device state in place (cache,
        lens, slot state; the sampling generator reseeded), so that the
        captured graphs, which hold these addresses, stay valid."""
        self.generator.manual_seed(self.seed)
        for layer in self.cache["layers"]:
            for leaf in layer.values():
                leaf.zero_()
        self.cache["lens"].zero_()
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

    # -- public API --------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Queue a request. An empty prompt or a negative budget is
        rejected, a zero budget completes at once with no output, and a
        prompt longer than the cache raises ``PromptTooLong``."""
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
        if prompt_len > self.max_len:
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
        n, rows = self.slots, len(ADMIT_ROWS)
        head = buf[:rows * n].view(rows, n)
        fields = {name: head[i] for i, name in enumerate(ADMIT_ROWS)}
        for name in ADMIT_F32_ROWS:
            fields[name] = fields[name].view(torch.float32)
        fields["tokens"] = buf[rows * n:].view(n, self.prefill_chunk)
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

    def _fill_slots_stall(self) -> None:
        """Stall admission: length-bucketed prefill calls into the free
        slots, run between megasteps while decoding slots wait."""
        free = [s for s in range(self.slots) if self.active[s] is None]
        buckets: Dict[int, List] = {}
        while free and self.queue:
            req = self.queue.popleft()
            p = np.asarray(req.prompt, np.int32)
            buckets.setdefault(self._bucket_len(len(p)), []).append(
                (free.pop(0), req, p))
        for blen, group in buckets.items():
            n = len(group)
            toks = np.full((n, blen), PAD_ID, np.int32)
            for i, (_, _, p) in enumerate(group):
                toks[i, :len(p)] = p
            smp = [self._req_sampling(r) for _, r, _ in group]
            first = self._prefill_impl(
                toks, np.asarray([len(p) for _, _, p in group], np.int32),
                np.asarray([s for s, _, _ in group], np.int64),
                np.asarray([r.max_new_tokens for _, r, _ in group], np.int32),
                np.asarray([r.eos_id for _, r, _ in group], np.int32),
                np.asarray([v[0] for v in smp], np.float32),
                np.asarray([v[1] for v in smp], np.int32),
                np.asarray([v[2] for v in smp], np.float32))
            self.stats.prefill_batches += 1
            for i, (s, req, p) in enumerate(group):
                tok = int(first[i])
                req.output.append(tok)
                self.stats.prefills += 1
                self.stats.tokens_generated += 1
                self._prefill_pos[s] = len(p)
                if tok == req.eos_id or len(req.output) >= req.max_new_tokens:
                    req.done = True       # the first token already ends it
                    continue
                self.active[s] = req
                self._slot_prompt[s] = p
                if smp[i][0] > 0.0:
                    self._stochastic_slots.add(s)

    def _prefill_impl(self, tokens: np.ndarray, seq_lens: np.ndarray,
                      slot_idx: np.ndarray, max_new: np.ndarray,
                      eos_id: np.ndarray, temp: np.ndarray,
                      top_k: np.ndarray, top_p: np.ndarray) -> np.ndarray:
        """Prefill one length bucket (n, S) into a scratch cache, copy
        its rows into the live cache at ``slot_idx`` (n,), sample the
        first tokens and set the slots' state for decoding. Returns the
        first tokens on the host (the call's one sync)."""
        dev = self.device
        n = tokens.shape[0]
        lens = torch.as_tensor(seq_lens, device=dev)
        idx = torch.as_tensor(slot_idx, device=dev)
        one = self.model.init_cache(n, self.max_len)
        logits = self.model.prefill(
            self.params, torch.as_tensor(tokens, device=dev).long(), one,
            seq_lens=lens)
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
        for s in range(self.slots):
            if self.active[s] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            prompt = np.asarray(req.prompt, np.int32)
            admit["new"][s] = True
            seg = prompt[:chunk]
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
            self._prefill_pos[s] = 0
            if temp > 0.0:
                self._stochastic_slots.add(s)
            self.stats.prefills += 1

    def _merge_admissions(self) -> None:
        """Fold the admission buffer (on the device) into the device
        state by masked updates, inside the megastep's program as in the
        JAX package: fresh slots get their cache rows and ``lens`` zeroed
        and their slot state rebuilt; chunk refills only swap the prompt
        window."""
        a = self._admit
        new = a["new"] != 0
        upd = new | (a["refill"] != 0)
        rows = new[:, None, None, None]
        for layer in self.cache["layers"]:
            for leaf in layer.values():
                leaf.masked_fill_(rows, 0)
        self.cache["lens"].masked_fill_(new, 0)
        st = self.state
        for field, key in (("max_new", "max_new"), ("eos_id", "eos"),
                           ("prompt_len", "prompt_len"),
                           ("temperature", "temp"), ("top_k", "top_k"),
                           ("top_p", "top_p")):
            t = getattr(st, field)
            t.copy_(torch.where(new, a[key], t))
        for field, val in (("last_token", 0), ("gen_len", 0),
                           ("prefill_pos", 0), ("phase", PHASE_PREFILL)):
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


def _quantized_formats(params) -> set:
    if isinstance(params, QuantizedTensor):
        return {params.fmt}
    if isinstance(params, dict):
        params = list(params.values())
    if isinstance(params, list):
        return set().union(*(_quantized_formats(p) for p in params))
    return set()
