#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root, one card

Phases (any failed check raises and the process exits nonzero):

1. the card's name and power limit, torch and CUDA versions;
2. build the hand-written kernels from ``src/repro_torch/kernels/csrc``;
3. hold each kernel against its plain PyTorch version on the card, at
   the paths' shapes (decode and prefill) and at edge shapes, and time
   kernel, plain version and library call beside the least time the
   card could take (with each kernel's launch grid); check that a
   ``quant_matmul`` output
   row does not depend on M, and a decode-attention slot not on the
   batch or the cache length (bit for bit); the gate-up GEMM with the
   SwiGLU folded in (``quant_matmul_swiglu``) bit-equal to
   ``swiglu(quant_matmul(x, w))`` through its split-K merge and its
   two-CTA clusters, rows bit-equal across M, timed beside the unfused
   pair, with no ptxas spill; split decode attention (bf16 and q8_0)
   launched on two streams at once, each launch bit-equal to the launch
   alone (its merge tickets are a stream's own); the fused RMSNorm, residual
   add + RMSNorm (h bit-equal) and SwiGLU kernels at M 4 and 2048, the
   decode RoPE + cache write in the three cache formats, with ring slots
   S - 1 and S and frozen rows, at every (head_dim, G) instance and past
   one CTA's 1024 runs, decode attention also timed at the main path's
   served kv_len (about 40), and the prefill RoPE + cache write at the
   prefill buckets in the three formats (bit-equal but on .5 ties of the
   quantized payloads); the paged decode attention (all three loaders,
   reading a pool through a shuffled block table) bit-equal to the dense
   kernel over ``paged_gather``'s view at P 8, 16, 64 and 128 and kv_len
   0, 1, P - 1, P, P + 1 and the cache length, timed at the paged path's
   shape beside the dense kernel, SDPA on the dense view and
   ``paged_gather`` + the dense kernel; the paged RoPE + cache write
   bit-equal to the dense kernel at the mapped rows, with frozen rows,
   block 0 and unmapped blocks untouched; the (head_dim, G) instances of
   the paper's other models, (64, 7), (128, 6), (128, 3) and (128, 4), in
   both attention kernels (the decode kernel's three loaders), timed at
   their models' decode (4 slots, kv_len 1024) and prefill (4 x 512)
   shapes, flash attention with mistral-7b's window of 4096 at S 4500, a
   pair that is not instantiated raising in both; ``quant_matmul`` and
   the gate-up GEMM at every new linear shape at M 4 and 2048 and at the
   untied heads (N 128256 and 32000, f32 logits); both RoPE + cache
   writes with the fused-QKV bias, and the prefill one with S past the
   cache (the ring write) in the three cache formats; the five MoE
   kernels (``moe_route``, ``moe_gate_up_swiglu``, ``moe_down``,
   ``moe_combine``, and ``moe_down_combine``, the last two in one pass at
   a decode's capacity, bit-equal to ``moe_combine(moe_down(...))`` and
   timed beside the two apart) against their plain versions at
   phi3.5-moe-42b-a6.6b's
   expert layer at T 4, 1 and 2048 and with a skewed router and tied
   logits that force drops, and the route alone at T 2048 with every token
   the same row (each k's pairs all to one expert) and with tied logits
   (the router's logits within 1e-5 and a token's
   bit-equal alone, routing exact, GEMM rows within one bf16 ulp, each
   expert's first row bit-equal alone, rows past the counts never
   written, the combine bit-equal), then at kimi-k2-1t-a32b's expert
   layer with its shared expert at T 4 and 512, each timed beside its
   bound, its plain version and ``torch.bmm`` over all experts, and its
   route alone at T 4 and 16 (at T 4 the three-launch route bit-equal to
   the one-launch route and timed beside it; launches on two streams at
   once exact); the five
   SSM kernels (``ssm_conv``, ``ssm_decode_step``, ``ssd_prefill``,
   ``gated_rmsnorm``) at mamba2-2.7b's widths: decode at
   4 slots (one frozen) and 1 (y within one bf16 ulp, the conv state
   bit-equal, the SSD state within 1e-5 of its scale, frozen rows
   untouched, each slot alone bit-equal to its row of the batch; the
   fused step bit-equal to the conv and update kernels back to back and
   timed beside them, 64 steps in a row with its conv state bit-equal to
   the plain pair's after each, launches on two streams at once exact),
   the conv bit-equal at S 1, 2, 3, 37 and 301, 1 x 300, 4 x 300 and 1 x
   512 (timed beside ``F.conv1d`` + ``F.silu``), the scan at S 1, 3, 37,
   63, 64, 65, 301,
   512 and 1100 (three slices) with and without a carried state (the
   scan's y within one bf16 step, its state within
   ``SSD_STATE_REL_TOL``; a sequence alone bit-equal to its row in a B 4
   call and in a B 2 call of 1100; N 48 on 4 heads; the scan's peak
   allocation at 1 x ``SSM_LONG_PROMPT`` within its output and one
   slice's scratch; the gated norm's row 0 alone bit-equal to its row in
   a B 4 and a 1 x 512 call), each timed beside its bound and its plain
   version; a
   build check that fails on a ptxas spill or a serialized ``wgmma`` in
   ``ssm.cu``;
   ``quant_matmul`` at ``in_proj`` (2560 x 10576, a ragged N) and
   ``out_proj`` under q8_0 and q4_0 at M 1, 4 and 512; the (head_dim
   128, G 8) instances of deepseek-67b and qwen1.5-110b (kimi-k2's
   attention too) in both attention kernels, every loader of the decode
   kernel, ragged and windowed lengths, timed at deepseek-67b's decode (4
   slots, kv_len 1024) and prefill (4 x 512) shapes, with the decode RoPE
   + cache write there and a build check that every (128, 8) instance is
   compiled without a spill; ``quant_matmul`` and the gate-up GEMM at
   every linear shape of mistral-nemo-12b, deepseek-67b and qwen1.5-110b
   at M 4 and 2048 and their untied heads, and at the V0 projections of
   the main path (``wq``, ``wk``, ``w_gate``); ``quant_matmul(out=)`` into
   a column range of a wider row (both routes, both formats, f32 out, an
   N copied element by element) bit-equal to the call without ``out=``
   with the neighbouring columns untouched, an unaligned view refused;
   ``torch.mm(out=)`` (the bf16-weight V0 projections) into a wider row
   with no copy kernel in its trace; the hybrid family's kernels at
   recurrentgemma-2b's widths: ``rglru_scan`` at 1 x 512 and 4 x 300 and
   edge lengths (y within one bf16 ulp, the state y's last row),
   ``rglru_decode_step`` at 4 slots (a row frozen) and 1 (y within one
   bf16 ulp, the state within 1e-5 of its scale), each sequence or slot
   alone bit-equal to its row, timed beside
   their bounds and plain versions; ``geglu`` at (4, 15360) and (2048,
   15360); the GeGLU form of ``quant_matmul_swiglu`` at K 2560, F 7680, M
   1, 4 and 2048 under q8_0 and q4_0 (bit-equal to ``geglu(quant_matmul(x,
   w))``, rows bit-equal to M 1, timed beside that pair); the (256, 10)
   instances of both attention kernels (decode at 4 slots of kv_len 1024
   and of the served kv_len in all three loaders, windowed lengths; flash
   causal at 4 x 512 and windowed (2048) at 1 x 4500, each timed beside
   SDPA) and of the decode and prefill RoPE + cache writes (the ring write
   too); ``quant_matmul`` at the model's linears at M 4 and 2048; a build
   check that fails on a spill in ``rglru.cu`` or in a (256, 10) instance;
4. main path: llama3.2-1b at full width (seeded random weights, q8_0
   weights, bf16 cache) served by ``repro_torch.launch.serve`` with 4
   slots, max_len 1024, 8-substep megasteps and chunked admission, 8
   greedy requests of 32 new tokens; every megastep is one replay of the
   engine's captured CUDA graph; checks outputs, launch counts (the
   captures' launches times the replays, and nothing launched outside a
   replay after the warmup; no plain RoPE or cache write, and no
   standalone SwiGLU, on the card),
   the engine's streams against
   ``Model.reference_decode``, and one decode step through the kernels
   against the plain versions (beside a planted fault the check must
   catch); then serves the same requests again under the profiler for
   the device's idle share, from a trace that holds exactly the
   expected events; then (4b) the same traffic through ``launch.serve
   --prefill-chunk 4`` (chunks under K 8, so a prefilling slot waits for
   its refill: ``chunk_refills`` as the prompts predict, streams equal to
   ``reference_decode`` and to the main path's, the same launches a
   capture and the same CUDA events a megastep), and the unfused V0
   (``get_config("llama3.2-1b", scheduler_version="v0")``: ``wq`` / ``wk``
   / ``wv`` and ``w_gate`` / ``w_up`` apart, the standalone SwiGLU under
   q8_0 weights): launch counts, streams against ``reference_decode``, one
   decode step against the plain versions, a profile with no copy kernel
   more a megastep than the fused main path's, V0 and V1 ms a step in
   turns (four pairs), and a V0 stall leg (one 4 x 512 prefill against the
   plain versions);
5. serving under load: the main path again through ``launch.serve
   --pipeline-depth 2`` (streams equal to depth 1's, the same launch
   counts, no stream-wide or device-wide synchronize inside a served
   step; depth 1 and 2 timed in turns; a profiled depth-2 run for the
   device's idle share); cancel on the paged prefix-cache engine at depth
   2 (one request while it prefills, one while it decodes: prefixes of
   their reference streams, shared pages live, survivors unchanged);
   the asyncio front-end (streams, a deadline, ``Backpressure`` at
   ``max_queue`` 2); seeded fault schedules on 4 layers (dense and
   paged, depth 1 and 2, one leg over a q8_0 cache: survivors equal
   ``reference_decode``, poisoned requests clean prefixes, the pool
   recovered); preemption with resume under chunked and stall admission
   on a 4-block pool, with ``QueueFull`` and ``InfeasibleDeadline``; a
   stall-admission resume whose prompt and generated tokens outgrow
   ``max_len`` (the ring write), dense and paged;
6. prefill path: the same model at full width and depth with stall
   admission, 8 requests with prompts of 270-900 tokens (buckets of 512
   and 1024 positions); checks launch counts, the streams against
   ``reference_decode(stepwise_prefill=False)``, and one fused prefill
   of the first bucket through the kernels against the plain versions
   (beside a planted lookahead fault); times each prefill and profiles
   them for the device's idle share;
7. paged path: the same model at full width and depth, q8_0 weights, a
   bf16 cache paged in blocks of 16 positions, chunked admission with
   the prefix cache: a request with a 256-token system prompt served
   alone (its pages registered), then 5 that share the system prompt and
   2 unrelated ones; checks 5 prefix hits of 256 tokens, launch counts
   equal to the main path's dense capture (no gather: ``paged_gather``
   never runs in a served run), the streams against a dense engine's and
   ``reference_decode``, ``audit()`` after every step of a second run,
   the blocks in use once drained, one decode step against the plain
   versions; times steps and the wall to the first token of the miss and
   the hits, and profiles a replay for the device's idle share;
8. second path: full width, 4 layers, q4_0 weights with a q8_0 and then
   a q4_0 cache (the q4 GEMV and both quantized attention loaders), then
   both caches again under stall admission, with the same
   launch-count and decode-step checks; the same four legs through a
   paged cache (streams equal to the dense legs', stall admission
   through ``_paged_splice``), and a leg whose pool of 13 blocks blocks
   admissions FIFO and evicts registry entries; then the same 4 layers
   with bf16 weights (cuBLAS linears and the standalone SwiGLU kernel;
   profiled), and the same 4 layers under V0, its weights cut by columns
   from them (cuBLAS writing each projection into its columns of one row
   through ``torch.mm(out=)``: streams, launch counts, a decode step
   against the plain versions, a profile with no copy kernel more a
   megastep than the fused leg's);
   then a stochastic leg
   (temperature 0.8) through the sampling graph: greedy rows exact,
   sampled tokens inside their top-k / top-p filters, the same tokens
   from two runs with one seed;
9. paper models: the paper's six models (its Fig. 4) at full width and
   depth, each under bf16, q8_0 and q4_0 weights with a bf16 cache,
   served by ``launch.serve`` through the main path's traffic (4 slots,
   8 requests of 32 new tokens) and one request alone on a 1-slot engine
   (the paper's single user): launch counts from each config's depth and
   head, no plain RoPE, cache write or bias add on the card, streams
   against ``reference_decode``, one decode step against the plain
   versions beside the planted fault; ms a step and tok/s beside the
   weight-streaming floor; a stall leg of each model (q8_0, 4 x 512
   prompts); then mistral-7b's window (q8_0, stall, max_len 8192, a
   4096-position ring): a 4500-token prompt through the ring write and
   the windowed prefill attention, a 4080-token one whose decode crosses
   the ring's edge, both against ``reference_decode(stepwise_prefill=
   False)``; (phase 5 also resumes a stall-admitted request past
   ``max_len``, dense and paged);
10. the mixture-of-experts family (run right after phase 4):
   phi3.5-moe-42b-a6.6b at full width and 24 of its 32 layers (bf16
   weights) served by ``launch.serve`` on 4 slots (launch counts, no
   plain MoE function on the card, streams against
   ``reference_decode``, one decode step against the plain versions
   beside the planted fault, the floor of the experts the routing read
   beside every expert's, a profiled run of the first 4 requests' first
   16 tokens for the idle share and the MoE kernels' device time), a
   stall leg (one 4 x 512 bucket:
   the pairs it drops, streams against a reference of the same bucket and,
   where nothing dropped, ``reference_decode(stepwise_prefill=False)``),
   a q8_0-cache leg and a paged leg with the prefix cache, ``--precision
   q8_0`` refused with the engine's error, and the first request alone
   on 1 slot;
11. one ``{"kernels": [...]}`` line, the card line, and the last line
   ``{"ok": true, "device": {...}}`` (after phase 13);
12. the SSM family (run right after phase 10): mamba2-2.7b at full width
   and all 64 layers, served by ``launch.serve`` under bf16, q8_0 and
   q4_0 weights on 4 slots (8 requests) and its first request alone on 1
   slot: launch counts (the conv, the state update, the gated norm and
   the residual add + norm a layer, ``in_proj`` and ``out_proj`` through
   ``quant_matmul`` when quantized; no plain SSM function on the card),
   streams against ``reference_decode``, one decode step against the
   plain versions within ``SSM_STEP_REL_TOL`` beside a planted fault (the
   state not decayed), and each of its 64 SSM layers on the same input
   within one bf16 ulp of the plain versions (output and SSD state) with
   the fault beyond it in every layer, ms a step and tok/s beside the
   floor with its state term, a profiled q8_0 run for the idle share and
   the SSM kernels' device time; a q8_0 stall leg (prompts of 300, 301,
   480 and 512 tokens: four exact-length buckets, each prefill call's
   device ms by kernel group; then one prompt of ``SSM_LONG_PROMPT``
   tokens served alone, its stream against ``reference_decode`` and the
   card's peak allocation over the engine's while it is served; streams
   against
   ``reference_decode(stepwise_prefill=False)``, one fused 4 x 300
   prefill against the plain versions within ``SSM_PREFILL_REL_TOL``
   beside the planted fault, and layer by layer as the decode step), a
   q4_0 stall leg against the fused
   reference, a leg with ``--kv-quant q8_0 --page-size 16
   --prefix-cache`` (no-ops, the engine's warning, the q8_0 streams), and
   preemption with resume under chunked and stall admission;
13. the assigned dense models (run after phase 9): mistral-nemo-12b under
   bf16, q8_0 and q4_0 weights, deepseek-67b under q4_0 and q8_0 and
   qwen1.5-110b under q4_0, each at full width and depth on the one card,
   every weight quantized as ``Model.init`` draws it (its peak allocation
   over the quantized tree checked to stay within one matrix's draw, and
   under the float tree's bytes), served by ``launch.serve`` through the
   main path's traffic on 4 slots (launch counts with the untied head,
   streams against ``reference_decode``, ms a step and tok/s beside the
   CLI's floor), then the first request alone on one slot (one decode
   step from its cache against the plain versions beside the planted
   fault), and in
   each model's stall format one 512-token prompt under stall admission
   (its 1 x 512 prefill against the plain versions beside the planted
   lookahead fault); each model's memory freed before the next; then
   deepseek-67b's first 4 layers under q8_0 and q4_0 caches (the (128, 8)
   quantized loaders on a served path).

14. the hybrid family (run right after phase 12): recurrentgemma-2b at
   full width and all 26 layers (18 RG-LRU, 8 local attention), served by
   ``launch.serve`` under bf16, q8_0 and q4_0 weights on 4 slots (8
   requests of 32 tokens) and its first request alone on 1 slot: launch
   counts a layer (``hybrid_launches``), no plain RG-LRU, GeGLU or
   attention function on the card, streams against ``reference_decode``,
   one decode step against the plain versions within
   ``HYBRID_STEP_REL_TOL`` beside a planted fault (the state not decayed),
   each RG-LRU layer on the same input within one bf16 ulp of the plain
   versions, ms a step and tok/s beside the CLI's floor, a profiled q8_0
   run for the idle share and device ms by kernel group; a q8_0 stall leg
   (exact-length buckets of 300, 301 and 512 tokens, streams against
   ``reference_decode(stepwise_prefill=False)``, a 2 x 300 prefill layer
   by layer), a window leg at max_len 4096 (a 4500-token prompt through
   the ring write and the windowed flash attention, a 2040-token one whose
   decode crosses the ring's edge), ``--kv-quant q8_0 --page-size 16
   --prefix-cache`` as no-ops with the engine's warning, and preemption
   with resume under chunked and stall admission.

Exits nonzero without printing a result when CUDA is unavailable, or
when run outside a checkout of the repository.
"""
from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12                # dense bf16 tensor-core peak
F32_FLOPS = 67e12                  # f32 outside the tensor cores
MAIN_LAYERS_SECOND_PATH = 4
STEP_SEEDS = 3                     # token batches per decode-step check
# Kernels vs plain versions through one whole decode step, as a share of
# the largest logit. Measured on an H100 over 5 token batches and the 3
# served paths: at most 1.21e-2 for sound kernels, at least 1.15e-1 with
# the attention off by one position (PERF.md, Findings).
STEP_REL_TOL = 3e-2
PREFILL_SEEDS = 5                  # token batches per prefill check
PREFILL_PROMPTS = (300, 310, 480, 500, 700, 760, 900, 270)
# Kernels vs plain versions through one fused prefill of the first bucket
# (4 x 512, seq_lens 300-500), as a share of the largest logit. Measured
# on an H100 over 5 token batches: at most 1.72e-2 for sound kernels, at
# least 3.21e-1 with the attention looking one key ahead (PERF.md).
PREFILL_REL_TOL = 4e-2
PAGE = 16                          # the paged path's and legs' page size
# ssd_prefill's final f32 state against the plain scan's (chunks of 64,
# masked, against the JAX rule's 256 halved to fit S), as a share of its
# largest magnitude. Measured on an H100 at mamba2-2.7b's widths: at most
# 4.5e-6 (B 4, S 512) for the f32 CUDA-core kernel, 8.2e-6 (B 1, S 63,
# from zeros) for the tensor-core kernel with its f32 operands split in
# three; y within one bf16 step of its scale, at most 1.9e-3 of it
# (PERF.md, Findings).
SSD_STATE_REL_TOL = 5e-5
# Kernels vs plain versions through one whole decode step, and one fused
# 4 x 300 prefill, of mamba2-2.7b, as a share of the largest logit. Each of
# the 64 layers is within one bf16 ulp of its plain version on the same
# input (``recurrent_layers_vs_plain``); through the whole depth the two passes
# drift apart about linearly with the layer, and a prefill also carries
# each position's flips into the later positions' states. Measured on an
# H100 (PERF.md, Findings): decode 2.318e-2 to 3.560e-2 over bf16, q8_0
# and q4_0 and 3 token batches, the planted fault (the state not decayed)
# 0.81 or more; the prefill 0.153 to 0.272 over 5 token batches, its
# fault 1.27 or more.
SSM_STEP_REL_TOL = 5e-2
SSM_PREFILL_REL_TOL = 0.35
# the SSM family's stall leg: four exact-length buckets, one of them odd
SSM_STALL_PROMPTS = (300, 301, 480, 512)
# and the longest prompt it serves (the engine takes an SSM prompt of any
# length at its exact length): eight of the scan's slices of 512
SSM_LONG_PROMPT = 4096
# the hybrid family's served model, and its decode-step tolerance: kernels
# vs plain versions through one whole decode step of recurrentgemma-2b (26
# layers: 18 RG-LRU, 8 local attention), as a share of the largest logit
# (PERF.md, Findings: its readings and the planted fault's)
HYBRID_ARCH = "recurrentgemma-2b"
HYBRID_STEP_REL_TOL = 5e-2
# the hybrid's stall leg: three exact-length buckets, one of them odd; its
# window leg serves at max_len 4096, so each attention layer's ring is the
# 2048-position window
HYBRID_STALL_PROMPTS = (300, 301, 512)
HYBRID_WINDOW_MAX_LEN = 4096
# phi3.5-moe-42b-a6.6b's depth on one 80 GB card: its bf16 weights are
# 2.6 GB a layer (16 experts of 157 MB), 83.8 GB at its 32 layers
MOE_LAYERS = 24
# the paper's six models (its Fig. 4), smallest first
PAPER_ORDER = ("qwen2-0.5b", "qwen2-1.5b", "llama3.2-1b", "llama3.2-3b",
               "llama3.2-8b", "mistral-7b-v0.1")
# the assigned dense models at full width and depth on one 80 GB card,
# with the weight formats each is served in (weights as stored:
# mistral-nemo-12b 24.5 / 13.6 / 7.9 GB under bf16 / q8_0 / q4_0,
# deepseek-67b 39.1 / 72.4 GB under q4_0 / q8_0, qwen1.5-110b 64.4 GB
# under q4_0; its q8_0, about 118 GB, does not fit), and the format of
# each one's stall leg
DENSE_CELLS = (("mistral-nemo-12b", ("bf16", "q8_0", "q4_0")),
               ("deepseek-67b", ("q4_0", "q8_0")),
               ("qwen1.5-110b", ("q4_0",)))
DENSE_STALL = {"mistral-nemo-12b": "q8_0", "deepseek-67b": "q4_0",
               "qwen1.5-110b": "q4_0"}
def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0]


# A trace window opens and closes on spin kernels (``torch.cuda._sleep``)
# whose events are left out: on the H100 a window now and then loses the
# first or the last two events it holds, in every trace of one run (the
# first or the last copy of a megastep went with a spin; late in some
# runs every trace lost its first host-to-device copy). So each edge is
# spins, which any such loss takes first. Some 250 s into a run with the
# SSM family's phases ahead of phase 5, each of five traces of a depth-2
# run lost the first three events after four spins, the same three with
# spins of 500,000 and of 5,000,000 cycles: a loss of the window's first
# records, not of its first microseconds. So each edge is sixteen spins.
PAD_CYCLES = 500_000
PAD_SPINS = 16


def pad_window() -> None:
    """The spin kernels at a trace window's edge, run to their end."""
    import torch
    for _ in range(PAD_SPINS):
        torch.cuda._sleep(PAD_CYCLES)
    torch.cuda.synchronize()


def window_events(prof) -> list:
    """A trace window's CUDA events (kernels, copies, fills), without the
    spin kernels at its edges (``pad_names``, read once at start-up)."""
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and e.name not in window_events.pad_names]


window_events.pad_names = frozenset()


def cuda_events(fn, args_list, calls: int) -> list:
    """The CUDA events (kernels, copies, fills) of a torch.profiler trace
    of ``calls`` calls of fn, cycling through ``args_list``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pad_window()
        for i in range(calls):
            fn(*args_list[i % len(args_list)])
        torch.cuda.synchronize()
        pad_window()
    return window_events(prof)


def events_per_call(fn, args_list, what: str, calls: int = 1) -> int:
    """The most CUDA events that a traced call of fn holds, over three
    traces of ``calls`` calls that hold any (a trace's count over its
    calls, rounded up). The profiler now and then returns a few empty
    traces in a row (three in a row once stopped a run on the H100), so
    up to eight are taken; a call that shows no event in all eight fails
    the run. It also now and then loses an event of a short trace (three
    one-call traces of SDPA in a row once held 4 of its 5 events on the
    H100), which a trace of several calls rounds away."""
    counts = []
    for _ in range(8):
        n = len(cuda_events(fn, args_list, calls))
        if n:
            counts.append(-(-n // calls))
        if len(counts) == 3:
            break
    check(bool(counts), f"{what}: eight traced calls show no CUDA event")
    return max(counts)


def time_calls(fn, args_list, reps: int, per_call: int = 0):
    """(device ms, wall ms) per call of fn(*args), cycling through
    ``args_list`` (copies whose bytes together exceed the 50 MB L2, so
    each call finds its inputs in device memory), after a warmup.

    Device ms: the call's kernels' own time, summed from a
    torch.profiler trace of ``reps`` calls. The profiler now and then
    drops events, which would read too low, so the trace must hold
    exactly ``per_call`` CUDA events a call: the kernels a port wrapper
    launches, from its plan; else ``events_per_call`` over traces of four
    calls. A trace that holds another count is taken again, up to four
    times, and then fails the run; ``time_calls.attempts`` keeps how many
    traces the last call took, which each kernel row records. Wall ms:
    CUDA events around ``reps`` back-to-back calls; where the host
    enqueues a call more slowly than the card runs it, this is the
    host's rate, not the kernel's."""
    import torch
    for a in args_list[:3]:
        fn(*a)
    torch.cuda.synchronize()
    if not per_call:
        per_call = events_per_call(fn, args_list, "a timed call", calls=4)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(*args_list[i % len(args_list)])
    end.record()
    torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end) / reps
    for attempt in range(1, 6):
        events = cuda_events(fn, args_list, reps)
        if len(events) == reps * per_call:
            break
    time_calls.attempts = attempt
    check(len(events) == reps * per_call, f"the profiler trace holds "
          f"{len(events)} CUDA events for {reps} calls of {per_call}")
    dev_us = sum(e.time_range.elapsed_us() for e in events)
    return dev_us / 1e3 / reps, wall_ms


def copies_for(nbytes: int) -> int:
    return max(2, math.ceil(160e6 / max(nbytes, 1)))


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_tol(ref) -> float:
    """One bf16 ulp at the output's scale: the kernels and the plain
    versions round at the same points but sum in another order (and the
    attention kernel keeps its online softmax over 64-position tiles),
    so a bf16 output may differ by one rounding step."""
    return 2.0 ** -7 * float(ref.float().abs().max())


# a kernel's group is the first whose name its name holds: gated_rmsnorm
# and add_rmsnorm before rmsnorm, the prefill RoPE before the decode one,
# the fused gate-up GEMM before quant_matmul; the scan's two kernels (its
# state walk and its chunk outputs) apart; the MoE down GEMM's decode sums
# + combine a group of their own
GROUPS = ("decode_attention", "quant_matmul_swiglu", "quant_matmul",
          "gated_rmsnorm", "add_rmsnorm", "rmsnorm", "swiglu",
          "rope_cache_write_prefill", "rope_cache_write", "flash_attention",
          "moe_route", "moe_down_combine", "moe_gemm", "moe_combine", "ssm_decode", "ssd_prefill_state", "ssd_prefill_out", "ssm_conv",
          "rglru_scan", "rglru_decode", "geglu", "memcpy", "other")


def group_of(name: str) -> str:
    """The kernel group a CUDA event of a profiler trace belongs to."""
    if "sum_splits_swiglu" in name:
        return "quant_matmul_swiglu"
    if "sum_splits" in name:
        return "quant_matmul"
    if "Memcpy" in name or "memcpy" in name:
        return "memcpy"
    return next((g for g in GROUPS[:-2] if g in name), "other")


def profile_served(engine, make_requests, prelude=None):
    """Where the served run's time goes: the requests of
    ``make_requests()`` served again by the same (reset) engine, the
    whole run under torch.profiler tracing the card only (after
    ``prelude(engine)``, served unprofiled, whose steps the numbers
    leave out: a long trace loses events now and then). Every
    megastep is the same program (one copy in, one graph replay, one
    copy out), so the trace must hold exactly that many CUDA events a
    dispatched megastep (``graph_replays``; at pipeline depth 2 a step
    may dispatch without draining, and the run ends with a step that
    only drains): ``events_per_call`` over traces of four dispatching
    steps, rounded up (in one H100 run every depth-2 trace of that
    run's late phase lost one event). A trace
    that holds another count (the profiler now and then drops events,
    which would read too low) is taken again, up to five times, and
    then fails the run. The device's idle share is 1 - the events'
    time / this run's own wall time in ``step()``; its ms per step beside
    the unprofiled run's is what the tracing costs. Returns the numbers
    and the requests of the accepted trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def start():
        engine.reset()
        if prelude is not None:
            prelude(engine)
            engine.stats = type(engine.stats)()

    def dispatch():
        """One step that dispatches exactly one megastep (at depth 2 a
        step may also drain the one before, which adds no CUDA event),
        with the requests submitted again once the engine runs dry."""
        if not engine.queue and all(r is None for r in engine.active):
            for r in make_requests():
                engine.submit(r)
        replays = engine.stats.graph_replays
        engine.step()
        check(engine.stats.graph_replays == replays + 1,
              "a profiled step dispatched no megastep")

    start()
    for r in make_requests():
        engine.submit(r)
    per_megastep = events_per_call(dispatch, [()], "a megastep", calls=4)
    for attempt in range(1, 6):
        start()
        requests = make_requests()
        for r in requests:
            engine.submit(r)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pad_window()
            engine.run()
            torch.cuda.synchronize()
            pad_window()
        events = window_events(prof)
        want = per_megastep * engine.stats.graph_replays
        print(f"  profile attempt {attempt}: {len(events)} CUDA events, "
              f"expected {want} ({per_megastep} a megastep x "
              f"{engine.stats.graph_replays} dispatched)", flush=True)
        if len(events) == want:
            break
        # every megastep holds the same events, so a name whose count is
        # not a multiple of the megasteps is what the trace lost (or
        # gained), and where in the window it sits tells an edge loss
        by_time = sorted(events, key=lambda e: e.time_range.start)
        tally = {}
        for e in events:
            tally[e.name] = tally.get(e.name, 0) + 1
        odd = {n[:70]: c for n, c in tally.items()
               if c % engine.stats.graph_replays}
        from torch.autograd import DeviceType
        pads = sum(e.name in window_events.pad_names for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
        print(f"    names off a multiple of {engine.stats.graph_replays}: "
              f"{odd}; first {[e.name[:40] for e in by_time[:3]]}, last "
              f"{[e.name[:40] for e in by_time[-3:]]}; {pads} of "
              f"{2 * PAD_SPINS} spins kept", flush=True)
    check(len(events) == want, f"the served run's trace holds {len(events)} "
          f"CUDA events, not {want}, after {attempt} attempts")
    st = engine.stats
    wall_ms = st.decode_wall_s * 1e3
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    # elementwise copy kernels (not the megastep's host copies): the
    # engine's bookkeeping has some; an unfused projection written into
    # its row adds none
    copies = sum("copy" in e.name.lower() and "memcpy" not in e.name.lower()
                 for e in events)
    groups = dict.fromkeys(GROUPS, 0.0)
    for name, ms in by_name.items():
        groups[group_of(name)] += ms / st.steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"  profile: the served run again under the profiler, {st.steps} "
          f"decode steps in {st.megasteps} megasteps ({st.graph_replays} "
          f"graph replays): wall {wall_ms / st.steps:.3f} ms per step, "
          f"device time {busy_ms / st.steps:.3f} ms per step -> device "
          f"idle share {1 - busy_ms / wall_ms:.3f}", flush=True)
    print("  profile: device ms per step by group "
          + ", ".join(f"{g} {ms:.3f}" for g, ms in groups.items()),
          flush=True)
    for name, ms in top:
        print(f"    {ms:8.3f} ms  {name[:90]}", flush=True)
    return dict(profiled_ms_per_step=wall_ms / st.steps,
                device_ms_per_step=busy_ms / st.steps,
                device_idle_share=1 - busy_ms / wall_ms,
                device_ms_per_step_by_group=groups,
                events_per_megastep=per_megastep,
                copy_kernels_per_megastep=copies / st.graph_replays,
                profile_attempts=attempt), requests


# -- serving under load: the legs of phase 5, on whatever device the engine
# is on (they take no CUDA-only step of their own) --------------------------
@contextlib.contextmanager
def no_stream_sync():
    """While served steps run, a whole-stream or device-wide synchronize
    fails the run: a pipelined step may wait on one megastep's event
    (``torch.cuda.Event.synchronize``), never on the stream, which would
    wait for the megastep behind it too."""
    import torch

    def refuse(*a, **kw):
        fail("a stream-wide or device-wide synchronize inside step()")
    saved = torch.cuda.synchronize, torch.cuda.Stream.synchronize
    torch.cuda.synchronize = torch.cuda.Stream.synchronize = refuse
    try:
        yield
    finally:
        torch.cuda.synchronize, torch.cuda.Stream.synchronize = saved


def cancel_leg(eng, Request, system, reference):
    """Cancel on a paged prefix-cache engine: a request opened by
    ``system`` served alone registers its pages; then three requests that
    share it: one cancelled while it is still prefilling (a 200-token
    tail), one cancelled while it decodes, one that runs to its end;
    ``audit()`` after every step. The shared blocks stay live through
    both cancels, the cancelled outputs are prefixes of their reference
    streams, and the survivors' streams are those of the same traffic
    served without the cancels. ``reference(prompt, n)`` is the greedy
    reference stream. Returns the leg's numbers."""
    import numpy as np
    rng = np.random.default_rng(8)
    vocab = eng.cfg.vocab_size
    tails = [rng.integers(1, vocab, n).astype(np.int32)
             for n in (12, 200, 8, 16)]

    def traffic():
        first = Request(uid=0, prompt=np.concatenate([system, tails[0]]),
                        max_new_tokens=16)
        rest = [Request(uid=i, prompt=np.concatenate([system, tails[i]]),
                        max_new_tokens=24) for i in (1, 2, 3)]
        return first, rest

    def serve(cancels):
        eng.reset()
        eng.audit_every_step = True
        first, rest = traffic()
        eng.submit(first)
        eng.run()
        reg = dict(eng._prefix_reg)
        check(len(reg) == len(system) // eng.page_size,
              f"cancel leg: {len(reg)} registered pages")
        prefilling, decoding, _ = rest
        for r in rest:
            eng.submit(r)
        if cancels:
            eng.step()
            check(not prefilling.output and not prefilling.done,
                  "cancel leg: the long request is no longer prefilling")
            check(eng.cancel(prefilling), "cancel leg: cancel refused")
            while not decoding.output:
                eng.step()
            check(len(decoding.output) < decoding.max_new_tokens,
                  "cancel leg: the decoding request already finished")
            check(eng.cancel(decoding), "cancel leg: cancel refused")
            eng.audit()
            check(all(eng._prefix_reg.get(k) == b and eng._ref[b] >= 1
                      for k, b in reg.items()),
                  "cancel leg: a shared prefix block was dropped")
        eng.run()
        eng.audit_every_step = False
        check(eng.blocks_in_use == len(eng._prefix_reg) and not eng.has_work(),
              f"cancel leg: {eng.blocks_in_use} blocks in use once drained")
        return [first] + rest

    plain = serve(cancels=False)
    got = serve(cancels=True)
    st = eng.stats
    check(st.cancelled == 2 and got[1].cancelled and got[2].cancelled,
          f"cancel leg: {st.cancelled} cancels")
    check(got[1].output == [], "cancel leg: the prefilling request emitted")
    ref = reference(got[2].prompt, got[2].max_new_tokens)
    check(got[2].output == ref[:len(got[2].output)],
          "cancel leg: the cancelled decode is not a prefix of "
          "reference_decode")
    check(ref == plain[2].output, "cancel leg: the uncancelled run differs "
          "from reference_decode")
    for i in (0, 3):
        check(got[i].output == plain[i].output and got[i].error is None,
              f"cancel leg: survivor {i} differs from the run without "
              "cancels")
    print(f"  cancel leg (paged, prefix cache, depth "
          f"{eng.pipeline_depth}): one request cancelled while "
          f"prefilling, one after {len(got[2].output)} tokens (a prefix of "
          f"reference_decode); shared pages live, audit() held after every "
          f"step; survivors == the run without cancels; "
          f"{st.prefix_hits} prefix hits", flush=True)
    return dict(cancelled=st.cancelled, decoded_before_cancel=len(
        got[2].output), prefix_hits=st.prefix_hits)


def preemption_leg(eng, Request, QueueFull, InfeasibleDeadline, reference):
    """Preemption and resume on a paged engine whose pool (4 blocks of
    16) backs one request of 44 positions at a time: a request with a
    later deadline is preempted by an earlier-deadline arrival and
    resumes from its prompt and generated tokens, at pipeline depth 1 and
    2. Under chunked admission the resume feeds those tokens through the
    decode step, so both streams must equal the requests served alone.
    Under stall admission it prefills them (``flash_attention``), whose
    logits are not a decode step's: the victim's tokens before the resume
    must equal its stream served alone, and those after it
    ``reference(prompt + tokens so far, n, stepwise_prefill=False)``;
    where the stream leaves the one served alone is printed. Then, with a
    measured step, ``QueueFull`` with a retry hint at ``max_queue`` 1 and
    ``InfeasibleDeadline`` for a deadline below one substep."""
    import numpy as np
    rng = np.random.default_rng(9)
    vocab = eng.cfg.vocab_size
    prompts = [rng.integers(1, vocab, 20).astype(np.int32) for _ in range(2)]

    def req(i, deadline=None):
        return Request(uid=i, prompt=prompts[i], max_new_tokens=24,
                       deadline_s=deadline)

    alone = []
    for i in (0, 1):
        eng.reset()
        eng.pipeline_depth = 1
        r = req(i)
        eng.submit(r)
        eng.run()
        alone.append(r.output)
    out = {}
    stall = eng.admission == "stall"
    admitted_at = []                    # the victim's tokens at each admission
    eff_prompt = eng._eff_prompt

    def logged(r):
        if r.uid == 0:
            admitted_at.append(len(r.output))
        return eff_prompt(r)
    eng._eff_prompt = logged
    for depth in (1, 2):
        eng.reset()
        eng.pipeline_depth = depth
        eng.audit_every_step = True
        admitted_at.clear()
        victim, urgent = req(0, 120.0), req(1, 30.0)
        eng.submit(victim)
        while not victim.output:
            eng.step()
        eng.submit(urgent)
        eng.step()
        check(victim.preemptions >= 1, f"preemption leg ({eng.admission}, "
              f"depth {depth}): the urgent admission preempted nobody")
        eng.run()
        eng.audit_every_step = False
        label = f"preemption leg ({eng.admission}, depth {depth})"
        check(urgent.output == alone[1], f"{label}: the urgent stream "
              "differs from the request served alone")
        k = max(admitted_at)            # tokens the last resume started from
        check(0 < k < 24, f"{label}: resumed after {k} tokens")
        if stall:
            check(victim.output[:k] == alone[0][:k], f"{label}: the tokens "
                  "before the resume differ from the request served alone")
            ref = reference(np.concatenate([prompts[0], np.asarray(
                victim.output[:k], np.int32)]), 24 - k,
                stepwise_prefill=False)
            check(victim.output[k:] == ref, f"{label}: the tokens after the "
                  "resume differ from reference_decode(stepwise_prefill="
                  "False) of the prompt and the tokens before it")
        else:
            check(victim.output == alone[0], f"{label}: the resumed stream "
                  "differs from the request served alone")
        same = next((i for i, (a, b) in enumerate(zip(victim.output,
                                                      alone[0])) if a != b),
                    len(alone[0]))
        check(eng.blocks_in_use == 0, "preemption leg: blocks leaked")
        out[f"depth{depth}"] = dict(preemptions=eng.stats.preemptions,
                                    victim_preemptions=victim.preemptions,
                                    resumed_after=k, equal_to_alone=same)
    sub = eng.stats.decode_wall_s / eng.stats.steps
    eng.max_queue = 1
    try:
        waiting = req(0)
        eng.submit(waiting)
        try:
            eng.submit(req(1))
        except QueueFull as e:
            hint = e.retry_after_s
        else:
            fail("preemption leg: max_queue 1 took a second request")
        check(hint is not None and hint > 0,
              f"preemption leg: QueueFull hint {hint}")
        eng.cancel(waiting)
    finally:
        eng.max_queue = 0
    try:
        eng.submit(req(1, deadline=sub / 2))
    except InfeasibleDeadline:
        pass
    else:
        fail("preemption leg: a deadline below one substep was admitted")
    del eng._eff_prompt
    check(not eng.has_work(), "preemption leg: work left")
    d1, d2 = out["depth1"], out["depth2"]
    print(f"  preemption leg ({eng.admission} admission, 4 blocks of "
          f"{eng.page_size}): the later-deadline request preempted "
          f"{d1['victim_preemptions']} / {d2['victim_preemptions']} time(s) "
          f"at depth 1 / 2, resumed after {d1['resumed_after']} / "
          f"{d2['resumed_after']} tokens; "
          + ("tokens before the resume == the request served alone, after "
             "it == reference_decode(stepwise_prefill=False) of the prompt "
             "and those tokens; equal to the stream served alone for the "
             f"first {d1['equal_to_alone']} / {d2['equal_to_alone']} of 24"
             if stall else "streams == each request served alone")
          + f"; QueueFull retry hint {hint:.4f} s; InfeasibleDeadline "
          f"below {sub * 1e3:.3f} ms", flush=True)
    out.update(queue_full_retry_after_s=hint, substep_s=sub)
    return out


def resume_past_max_len_leg(eng, Request, reference):
    """A stall-admission resume whose prompt and generated tokens outgrow
    ``max_len``: a 40-token prompt with a budget of 40 on a cache of 64
    positions, preempted once it has 33 tokens, resumes from 73, which
    the engine prefills at their exact length through the ring write (a
    paged engine splices the scratch cache's ring into its pages). The
    stream ends with 40 tokens; those before the resume equal the request
    served alone, those after it ``reference(prompt + tokens so far, n,
    stepwise_prefill=False)``; the request served alone equals
    ``reference(prompt, 40, stepwise_prefill=False)`` (its decode wraps
    the cache's ring too)."""
    import numpy as np
    prompt = np.random.default_rng(5).integers(
        1, eng.cfg.vocab_size, 40).astype(np.int32)
    label = (f"resume past max_len ({'paged' if eng.paged else 'dense'}, "
             f"max_len {eng.max_len})")
    eng.reset()
    alone = Request(uid=0, prompt=prompt, max_new_tokens=40)
    eng.submit(alone)
    eng.run()
    check(alone.output == reference(prompt, 40, stepwise_prefill=False),
          f"{label}: the request served alone differs from reference_decode")
    eng.reset()
    eng.audit_every_step = True
    r = Request(uid=0, prompt=prompt, max_new_tokens=40)
    eng.submit(r)
    while len(r.output) < 33:
        eng.step()
    k = len(r.output)
    check(k < 40 and eng.preempt(r), f"{label}: preempt after {k} tokens")
    eng.run()
    eng.audit_every_step = False
    check(r.done and len(r.output) == 40 and r.preemptions == 1,
          f"{label}: {len(r.output)} tokens, {r.preemptions} preemptions")
    check(len(prompt) + k > eng.max_len, f"{label}: the resume fits the cache")
    check(r.output[:k] == alone.output[:k], f"{label}: the tokens before "
          "the resume differ from the request served alone")
    ref = reference(np.concatenate([prompt, np.asarray(r.output[:k],
                                                       np.int32)]),
                    40 - k, stepwise_prefill=False)
    check(r.output[k:] == ref, f"{label}: the tokens after the resume "
          "differ from reference_decode(stepwise_prefill=False) of the "
          "prompt and the tokens before it")
    check(not eng.has_work() and eng.blocks_in_use == 0,
          f"{label}: work or blocks left")
    same = next((i for i, (a, b) in enumerate(zip(r.output, alone.output))
                 if a != b), 40)
    print(f"  {label}: resumed from {len(prompt) + k} tokens (prompt and "
          f"{k} generated) through the ring write; before the resume == "
          "the request served alone, after it == reference_decode("
          "stepwise_prefill=False); equal to the stream served alone for "
          f"the first {same} of 40", flush=True)
    return dict(resumed_from=len(prompt) + k, equal_to_alone=same)


def fault_leg(eng, Request, FaultInjector, FaultSchedule, seed, reference):
    """One seeded storm (``FaultSchedule.seeded``: pool exhaustion,
    preemption, poisoned logits, host stalls, transient exceptions) on a
    reset engine at its current depth, ``audit()`` after every step:
    survivors equal ``reference(prompt, n)``, a poisoned request ends with
    "nonfinite-logits" and a clean prefix of its reference, and the pool
    is whole again. Returns the counts it saw."""
    import numpy as np
    eng.reset()
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 6))
    reqs = [Request(uid=i, prompt=rng.integers(
        1, eng.cfg.vocab_size, size=int(rng.integers(2, 14))).astype(
            np.int32), max_new_tokens=int(rng.integers(1, 12)))
        for i in range(n)]
    sched = FaultSchedule.seeded(seed, n_requests=n, paged=eng.paged)
    for r in reqs:
        eng.submit(r)
    inj = FaultInjector(eng, sched, audit=True, backoff_s=0.0)
    inj.run(reqs)
    label = (f"fault leg (seed {seed}, {'paged' if eng.paged else 'dense'}, "
             f"{eng.kv_quant} cache, depth {eng.pipeline_depth})")
    check(not eng.has_work() and not eng._quarantined
          and eng.blocks_in_use == 0, f"{label}: the pool was not recovered")
    poisoned = 0
    for r in reqs:
        ref = reference(r.prompt, r.max_new_tokens)
        check(r.done, f"{label}: request {r.uid} not done")
        if r.error is not None:
            check(r.error == "nonfinite-logits" and
                  r.output == ref[:len(r.output)],
                  f"{label}: request {r.uid} failed with {r.error} after "
                  "tokens off its reference")
            poisoned += 1
        else:
            check(r.output == ref, f"{label}: survivor {r.uid} differs from "
                  "reference_decode")
    kinds = sorted({e.kind for e in sched.events})
    return dict(requests=n, poisoned=poisoned,
                preemptions=eng.stats.preemptions, retries=inj.retries,
                kinds=kinds, label=label)


def capture_in_flight_leg(eng, Request, reference):
    """At pipeline depth 2 a sampled request arrives while a greedy replay
    is in flight, so the sampling graph is first captured then: the
    capture stream waits for the engine's stream, so the capture's
    warmup cannot overwrite the block before the replay in flight has
    copied it out. The greedy stream equals ``reference(prompt, n)``, and
    the sampled one is the same in a second run with the same seed."""
    import numpy as np
    check(False not in eng.graph_launches,
          "capture leg: the engine already has a sampling graph")
    rng = np.random.default_rng(10)
    prompts = [rng.integers(1, eng.cfg.vocab_size, 6).astype(np.int32)
               for _ in range(2)]

    def serve():
        eng.reset()
        eng.pipeline_depth = 2
        greedy = Request(uid=0, prompt=prompts[0], max_new_tokens=16)
        hot = Request(uid=1, prompt=prompts[1], max_new_tokens=16,
                      temperature=0.8, top_k=40)
        eng.submit(greedy)
        eng.step()
        eng.step()
        eng.submit(hot)
        eng.run()
        return greedy.output, hot.output

    captured_at = []
    capture = eng._capture

    def watched(all_greedy):
        captured_at.append((all_greedy, len(eng._inflight)))
        return capture(all_greedy)
    eng._capture = watched
    try:
        first = serve()
    finally:
        del eng._capture
    check(captured_at == [(False, 1)], f"capture leg: captures (all_greedy,"
          f" megasteps in flight) {captured_at}, not one sampling capture "
          "with a greedy replay in flight")
    again = serve()
    check(first[0] == again[0] == reference(prompts[0], 16),
          "capture leg: the greedy stream differs from reference_decode")
    check(first[1] == again[1] and len(first[1]) == 16,
          "capture leg: two runs with one seed sampled other tokens")
    print("  capture leg (depth 2): the sampling graph captured with a greedy"
          " replay in flight; greedy stream == reference_decode, sampled "
          "tokens equal in two runs with one seed", flush=True)
    return dict(captured_with_in_flight=captured_at[0][1])


async def frontend_leg(eng, AsyncServingFrontend, DeadlineExceeded,
                       Backpressure, prompts, streams):
    """The asyncio front-end over ``eng``: the ``prompts`` arriving one
    every 2 ms stream tokens equal to their futures' results and to
    ``streams`` (engine.run's); a deadline that expires mid-decode raises
    DeadlineExceeded with a prefix of the stream, and the next request is
    served; at ``max_queue`` 2 a burst is partly shed with Backpressure.
    ``step`` must run in the executor's thread."""
    import asyncio
    import threading
    main_thread = threading.get_ident()
    threads = set()
    step = eng.step

    def watched_step():
        threads.add(threading.get_ident())
        return step()
    eng.step = watched_step
    try:
        fe = AsyncServingFrontend(eng, max_pending=16)
        streamed = [[] for _ in prompts]
        tasks = []
        for i, p in enumerate(prompts):
            tasks.append(asyncio.ensure_future(fe.generate(
                p, max_new_tokens=len(streams[i]),
                on_token=streamed[i].append)))
            await asyncio.sleep(0.002)
        outs = await asyncio.gather(*tasks)
        check(outs == streamed == streams, "front-end: streamed tokens, "
              "futures and engine.run's streams differ")
        try:
            await fe.generate(prompts[0], max_new_tokens=900,
                              deadline_s=0.1)
        except DeadlineExceeded as e:
            partial = e.tokens
        else:
            fail("front-end: a 0.1 s deadline on 900 tokens did not expire")
        k = min(len(partial), len(streams[0]))
        check(0 < len(partial) < 900 and partial[:k] == streams[0][:k],
              f"front-end: {len(partial)} partial tokens off the stream")
        after = await fe.generate(prompts[1], max_new_tokens=len(streams[1]))
        check(after == streams[1], "front-end: the request after the "
              "deadline was served other tokens")
        eng.max_queue = 2
        try:
            burst = await asyncio.gather(*[
                fe.generate(p, max_new_tokens=len(s))
                for p, s in zip(prompts, streams)], return_exceptions=True)
        finally:
            eng.max_queue = 0
        shed = sum(isinstance(b, Backpressure) for b in burst)
        served = [(b, s) for b, s in zip(burst, streams)
                  if isinstance(b, list)]
        check(shed > 0 and all(b == s for b, s in served) and
              shed + len(served) == len(prompts),
              f"front-end: burst at max_queue 2 gave {burst}")
        await fe.close()
    finally:
        del eng.step
    check(threads and main_thread not in threads,
          "front-end: engine.step ran on the event loop's thread")
    return dict(partial_tokens=len(partial), burst_shed=shed,
                burst_served=len(served))


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run it from a "
             "checkout of the repository")
    sys.path.insert(0, os.path.join(ROOT, "src"))

    import numpy as np
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain,
                                                      num_splits,
                                                      paged_gather)
    from repro_torch.kernels.decode_attention_quant import (
        decode_attention_quant, decode_attention_quant_plain)
    from repro_torch.kernels import decode_attention as da_mod
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels import fused_ops
    from repro_torch.kernels.fused_ops import (
        add_rmsnorm, add_rmsnorm_plain, rmsnorm, rmsnorm_plain,
        rope_cache_write, rope_cache_write_plain, rope_cache_write_prefill,
        rope_cache_write_prefill_plain, swiglu, swiglu_plain, geglu,
        geglu_plain)
    from repro_torch.kernels.quant_matmul import (
        launch_grid, quant_matmul, quant_matmul_plain, quant_matmul_swiglu,
        quant_matmul_swiglu_plain)
    from repro_torch.kernels import moe as moe_kernels
    from repro_torch.kernels.moe import (
        moe_combine, moe_combine_plain, moe_down, moe_down_combine,
        moe_down_combine_plain, moe_down_plain, moe_gate_up_swiglu,
        moe_gate_up_swiglu_plain, moe_route, moe_route_plain,
        route_from_logits_plain, router_logits_plain)
    from repro_torch.kernels import ssm as ssm_kernels
    from repro_torch.kernels.ssm import (
        gated_rmsnorm, gated_rmsnorm_plain, ssd_prefill, ssd_prefill_plain,
        ssm_conv, ssm_conv_plain, ssm_decode_step, ssm_decode_step_plain)
    from repro_torch.kernels import rglru as rglru_kernels
    from repro_torch.kernels.rglru import (
        rglru_decode_step, rglru_decode_step_plain, rglru_scan,
        rglru_scan_plain)
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models import hybrid as hybrid_mod
    from repro_torch.quant import (QuantizedTensor, dequantize,
                                   dequantize_rows, quantize, quantize_rows,
                                   quantize_tree, unpack_int4_rows)
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.sampler import SamplingConfig, sample_batched

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", flush=True)

    # -- 2. build ---------------------------------------------------------
    libs, secs = build.build()
    print(f"build: {sorted(libs)} in {secs:.1f}s "
          f"({build.BUILD_DIR})", flush=True)
    # flash_attention overlaps its wgmma groups with the softmax, the
    # grouped expert GEMM its k steps with the next stage's wait and the
    # SSD scan its products with the decay matrix; ptxas may serialize
    # them instead, which it reports
    for stem in sorted(libs):
        notes = build.perf_notes(stem)
        print(f"  ptxas on {stem}.cu: {len(notes)} performance warnings"
              + "".join(f"\n    {n[:200]}" for n in notes), flush=True)
        check(stem not in ("flash_attention", "moe", "ssm") or not notes,
              f"ptxas serialized {stem}.cu's wgmma groups")
    # the GEMM with its output row stride, and the fused gate-up kernels,
    # keep quant_matmul's budget (two CTAs an SM, at most 128 registers a
    # thread) without spilling
    for fn, regs, st_b, ld_b in build.ptxas_usage("quant_matmul"):
        short = re.search(r"\d([a-z_]+_kernel)(I\w*?EE)?", fn)
        if not short:
            continue
        print(f"  ptxas on quant_matmul.cu: {short.group(0)[1:]}: {regs} "
              f"registers, {st_b} / {ld_b} bytes spill stores / loads",
              flush=True)
        check(st_b == 0 and ld_b == 0, f"ptxas spilled registers in {fn}")
    # the decode RoPE + cache write (up to 1024 threads a CTA, so at most
    # 64 registers a thread) does not spill in any cache format
    for fn, regs, st_b, ld_b in build.ptxas_usage("fused_ops"):
        short = re.search(r"rope_cache_write_kernelILi(\d)EE", fn)
        if not short:
            continue
        print(f"  ptxas on fused_ops.cu: rope_cache_write_kernel format "
              f"{short.group(1)}: {regs} registers, {st_b} / {ld_b} bytes "
              "spill stores / loads", flush=True)
        check(st_b == 0 and ld_b == 0, f"ptxas spilled registers in {fn}")
    # both attention kernels' instances at the (head_dim, G) pairs of the
    # paper's other models and of deepseek-67b / qwen1.5-110b (128, 8)
    # keep their registers too (every loader)
    new_pairs_ptx = {(64, 7), (128, 6), (128, 3), (128, 4), (128, 8),
                     (256, 10)}
    seen_128_8, seen_256_10 = [], []
    for stem, pat in (
            ("decode_attention",
             r"decode_attention_split_kernelILi(\d)ELi(\d+)ELi(\d+)EE"),
            ("flash_attention",
             r"flash_attention_kernelILi(\d+)ELi(\d+)ELi(\d+)EE")):
        for fn, regs, st_b, ld_b in build.ptxas_usage(stem):
            m = re.search(pat, fn)
            if not m:
                continue
            a, b_, c = (int(x) for x in m.groups())
            pair = (b_, c) if stem == "decode_attention" else (a, b_)
            print(f"  ptxas on {stem}.cu: " + (
                f"loader {a}, D {b_}, G {c}" if stem == "decode_attention"
                else f"D {a}, G {b_}, BK {c}") + f": {regs} registers, "
                f"{st_b} / {ld_b} bytes spill stores / loads", flush=True)
            check(pair not in new_pairs_ptx or (st_b == 0 and ld_b == 0),
                  f"ptxas spilled registers in {fn}")
            if pair == (128, 8):
                seen_128_8.append((stem, a))
            if pair == (256, 10):
                seen_256_10.append((stem, a))
    check(set(seen_128_8) == {("decode_attention", 0),
                              ("decode_attention", 1),
                              ("decode_attention", 2), ("flash_attention", 128)},
          f"the (128, 8) instances in ptxas's report: {sorted(seen_128_8)}")
    # recurrentgemma-2b's (256, 10): the decode kernel's three loaders, and
    # the flash kernel at block_k 32 (Q in shared memory)
    check(set(seen_256_10) == {("decode_attention", 0),
                               ("decode_attention", 1),
                               ("decode_attention", 2),
                               ("flash_attention", 256)},
          f"the (256, 10) instances in ptxas's report: {sorted(seen_256_10)}")
    # the RG-LRU kernels keep their registers
    for fn, regs, st_b, ld_b in build.ptxas_usage("rglru"):
        short = re.search(r"\d(rglru_\w+?_kernel)", fn)
        print(f"  ptxas on rglru.cu: {short.group(1) if short else fn}: "
              f"{regs} registers, {st_b} / {ld_b} bytes spill stores / "
              "loads", flush=True)
        check(st_b == 0 and ld_b == 0, f"ptxas spilled registers in {fn}")
    # the MoE kernels (the grouped GEMM's four instances and its two
    # split-sum kernels among them) keep their registers
    gemm_instances = 0
    for fn, regs, st_b, ld_b in build.ptxas_usage("moe"):
        gemm_instances += "moe_gemm_kernel" in fn
        short = re.search(r"\d(moe_[a-z_]+?_kernel(?:I\w*?EE)?)", fn)
        print(f"  ptxas on moe.cu: {short.group(1) if short else fn}: "
              f"{regs} registers, {st_b} / {ld_b} bytes spill stores / "
              "loads", flush=True)
        check(st_b == 0 and ld_b == 0, f"ptxas spilled registers in {fn}")
    check(gemm_instances == 4, f"moe.cu: {gemm_instances} moe_gemm_kernel "
          "instances in ptxas's report, not 4")
    # the SSM kernels keep their registers (the scan's output kernel holds
    # C B^T, the split decay matrix and its accumulator a thread)
    for fn, regs, st_b, ld_b in build.ptxas_usage("ssm"):
        short = re.search(r"\d((?:ssm|ssd|gated)_\w+?_kernel)", fn)
        print(f"  ptxas on ssm.cu: {short.group(1) if short else fn}: "
              f"{regs} registers, {st_b} / {ld_b} bytes spill stores / "
              "loads", flush=True)
        check(st_b == 0 and ld_b == 0, f"ptxas spilled registers in {fn}")
    # the profiler's first window starts its tracing; keep that out of
    # the timed ones
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1024, device=dev).sum()
        torch.cuda.synchronize()
    from torch.autograd import DeviceType
    for _ in range(8):              # the spin kernel's event names
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pad_window()
        names = {e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA}
        if names:
            break
    check(bool(names), "eight traces of the spin kernel show no CUDA event")
    window_events.pad_names = frozenset(names)
    print(f"  trace windows open and close on {sorted(names)}", flush=True)

    def zero_counts():
        for k in ops.KERNELS:
            k.launches = 0

    def off_by_one(fn):
        """A planted fault: the decode attention reads one position
        fewer."""
        return lambda *a, **kw: fn(*a[:-1], a[-1] - 1, **kw)

    def lookahead(q, k, v, *, causal=True, window=0, q_offset=0):
        """A planted fault: each prefill query also sees the next key
        (kpos <= qpos + 1), the causal off-by-one a kernel mask could
        make."""
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset + 1)

    def no_decay(fn, at=3):
        """A planted fault: the SSD state is not decayed (A_log, argument
        ``at`` of fn, -inf, so A = -exp(A_log) = 0 and exp(dt A) = 1); or
        the RG-LRU state (a_param -inf, so a = exp(-8 softplus(-inf) r) =
        1)."""
        def run(*a, **kw):
            a = list(a)
            a[at] = torch.full_like(a[at], -math.inf)
            return fn(*a, **kw)
        return run

    @contextlib.contextmanager
    def plain_versions(fault: bool = False):
        """Route the model's kernel calls to the plain versions (the
        reference pass of the kernel-vs-plain checks), with the planted
        faults in the attention, and in the SSD and RG-LRU recurrences (no
        decay), where ``fault``."""
        names = ("quant_matmul", "quant_matmul_swiglu", "decode_attention",
                 "decode_attention_quant", "flash_attention", "rmsnorm",
                 "add_rmsnorm", "swiglu", "rope_cache_write",
                 "rope_cache_write_prefill", "moe_route",
                 "moe_gate_up_swiglu", "moe_down", "moe_combine",
                 "moe_down_combine", "ssm_conv", "ssm_decode_step",
                 "ssd_prefill", "gated_rmsnorm", "geglu", "rglru_scan",
                 "rglru_decode_step")
        saved = {n: getattr(ops, n) for n in names}
        wrap = off_by_one if fault else (lambda fn: fn)
        ops.quant_matmul = quant_matmul_plain
        ops.quant_matmul_swiglu = quant_matmul_swiglu_plain
        ops.decode_attention = wrap(decode_attention_plain)
        ops.decode_attention_quant = wrap(decode_attention_quant_plain)
        ops.flash_attention = lookahead if fault else flash_attention_plain
        ops.rmsnorm = rmsnorm_plain
        ops.add_rmsnorm = add_rmsnorm_plain
        ops.swiglu = swiglu_plain
        ops.rope_cache_write = rope_cache_write_plain
        ops.rope_cache_write_prefill = rope_cache_write_prefill_plain
        ops.moe_route = moe_route_plain
        ops.moe_gate_up_swiglu = moe_gate_up_swiglu_plain
        ops.moe_down = moe_down_plain
        ops.moe_combine = moe_combine_plain
        ops.moe_down_combine = moe_down_combine_plain
        ops.ssm_conv = ssm_conv_plain
        ops.ssm_decode_step = (no_decay(ssm_decode_step_plain, at=6) if fault
                               else ssm_decode_step_plain)
        ops.ssd_prefill = (no_decay(ssd_prefill_plain) if fault
                           else ssd_prefill_plain)
        ops.gated_rmsnorm = gated_rmsnorm_plain
        ops.geglu = geglu_plain
        # the RG-LRU's a_param (argument 5) -inf: softplus 0, a = 1, the
        # state carried on undecayed
        ops.rglru_scan = (no_decay(rglru_scan_plain, at=5) if fault
                          else rglru_scan_plain)
        ops.rglru_decode_step = (no_decay(rglru_decode_step_plain, at=5)
                                 if fault else rglru_decode_step_plain)
        try:
            yield
        finally:
            for n, fn in saved.items():
                setattr(ops, n, fn)

    @contextlib.contextmanager
    def kernels_only(quantized: bool = True):
        """While a path is served, the parts of the RoPE + cache-write
        plain versions refuse to run: every RoPE, cache write and
        fused-QKV bias add on the card goes through the fused kernels,
        and the MoE and SSM plain versions refuse too (an MoE FFN or an
        SSM layer on the card runs its kernels). With quantized weights
        the standalone SwiGLU refuses too: the gate-up GEMM computes it."""
        names = ("apply_rope", "kv_cache_write", "kv_cache_write_prefill",
                 "_with_bias")
        moe_names = ("moe_route_plain", "moe_gate_up_swiglu_plain",
                     "moe_down_plain", "moe_combine_plain",
                     "moe_down_combine_plain")
        ssm_names = ("ssm_conv_plain", "ssm_decode_update_plain",
                     "ssm_decode_step_plain",
                     "ssd_prefill_plain", "gated_rmsnorm_plain",
                     "causal_conv", "ssd_chunked")
        # the hybrid's: the RG-LRU's and the GeGLU's plain versions, and
        # the attention kernels' (its local attention runs the kernels)
        other = [(rglru_kernels, n) for n in (
            "rglru_scan_plain", "rglru_decode_step_plain", "gates_plain",
            "linear_scan")] + [(fused_ops, "geglu_plain"),
                               (da_mod, "decode_attention_plain"),
                               (fa_mod, "flash_attention_plain")]
        saved_other = [(m, n, getattr(m, n)) for m, n in other]
        saved = {n: getattr(fused_ops, n) for n in names}
        saved_moe = {n: getattr(moe_kernels, n) for n in moe_names}
        saved_ssm = {n: getattr(ssm_kernels, n) for n in ssm_names}
        saved_swiglu = ops.swiglu

        def refuse(*a, **kw):
            fail("a plain RoPE, cache write or bias add ran on the card in "
                 "a served path")

        def refuse_swiglu(*a, **kw):
            fail("the standalone SwiGLU ran in a served path with "
                 "quantized weights")

        def refuse_moe(*a, **kw):
            fail("a plain MoE function ran on the card in a served path")

        def refuse_ssm(*a, **kw):
            fail("a plain SSM function ran on the card in a served path")

        def refuse_other(*a, **kw):
            fail("a plain RG-LRU, GeGLU or attention function ran on the "
                 "card in a served path")
        for m, n in other:
            setattr(m, n, refuse_other)
        for n in names:
            setattr(fused_ops, n, refuse)
        for n in moe_names:
            setattr(moe_kernels, n, refuse_moe)
        for n in ssm_names:
            setattr(ssm_kernels, n, refuse_ssm)
        if quantized:
            ops.swiglu = refuse_swiglu
        try:
            yield
        finally:
            for n, fn in saved.items():
                setattr(fused_ops, n, fn)
            for n, fn in saved_moe.items():
                setattr(moe_kernels, n, fn)
            for n, fn in saved_ssm.items():
                setattr(ssm_kernels, n, fn)
            for m, n, fn in saved_other:
                setattr(m, n, fn)
            ops.swiglu = saved_swiglu

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    # the inputs of the cases added after a path's weights were first
    # drawn come from a generator of their own, so that the paths keep
    # their weights and their readings stay comparable across versions
    gen_added = torch.Generator(device=dev)
    gen_added.manual_seed(1)
    gen_gate_up = torch.Generator(device=dev)    # quant_matmul_swiglu's cases
    gen_gate_up.manual_seed(2)
    gen_paged = torch.Generator(device=dev)      # the paged kernel cases
    gen_paged.manual_seed(3)

    gen_paper = torch.Generator(device=dev)      # the paper models' cases
    gen_paper.manual_seed(6)
    gen_streams = torch.Generator(device=dev)    # launches on two streams
    gen_streams.manual_seed(27)
    gen_rope = torch.Generator(device=dev)       # the decode RoPE's instances
    gen_rope.manual_seed(28)
    draw_from = [gen]          # the generator randn takes by default

    def randn(*shape, scale=1.0, g=None):
        return torch.randn(shape, generator=g or draw_from[0],
                           device=dev) * scale

    @contextlib.contextmanager
    def drawing_from(g):
        """randn's default generator is ``g`` inside, so that cases added
        later leave ``gen``'s draws (and so the paths' weights) as they
        were."""
        draw_from[0] = g
        try:
            yield
        finally:
            draw_from[0] = gen

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cfg_full = get_config("llama3.2-1b")
    B, Hq, Hkv = 4, cfg_full.num_heads, cfg_full.num_kv_heads
    D, S = cfg_full.head_dim, 1024
    rows = {}          # kernel-table rows by name

    # -- 3. kernels against their plain versions ---------------------------
    def attention_case(fmt, b, hq, hkv, s, d, lens, window, timed,
                       instance=None, path=None):
        """``instance`` names a (head_dim, G) instance of a paper model
        in the row's name, ``path`` the served run whose launches the row
        reports (the main path's and the second path's by default)."""
        q = randn(b, hq, d).bfloat16()
        k = randn(b, hkv, s, d).bfloat16()
        v = randn(b, hkv, s, d).bfloat16()
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        if fmt == "bf16":
            args = (q, k, v, lens_t)
            kern = lambda *a: decode_attention(*a, window=window)
            plain = lambda *a: decode_attention_plain(*a, window=window)
            row_bytes = d * 2
            kv_bf16 = (k, v)
        else:
            kq, ks = quantize_rows(k, fmt)
            vq, vs = quantize_rows(v, fmt)
            args = (q, kq, ks, vq, vs, lens_t)
            kern = lambda *a: decode_attention_quant(*a, fmt=fmt,
                                                     window=window)
            plain = lambda *a: decode_attention_quant_plain(
                *a, fmt=fmt, window=window)
            row_bytes = kq.shape[-1] + ks.shape[-1] * 2
            kv_bf16 = (dequantize_rows(kq, ks, fmt),
                       dequantize_rows(vq, vs, fmt))
        out = kern(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        tol = bf16_tol(ref)
        name = "decode_attention" if fmt == "bf16" else \
            f"decode_attention_quant[{fmt}]"
        if instance:
            name = (f"decode_attention[{instance}]" if fmt == "bf16" else
                    f"decode_attention_quant[{fmt} {instance}]")
        shape = f"B{b} Hq{hq} Hkv{hkv} S{s} D{d} kv_len{lens} window{window}"
        print(f"  {name} {shape}: max_abs_err {err:.3e} (tol {tol:.3e})",
              flush=True)
        check(err <= tol, f"{name} {shape}: {err} > {tol}")
        if not timed:
            return
        # least time: each visible K/V row read once (+ scales), q read,
        # out written, kv_len read
        vis = sum(min(max(l, 0), s) - (max(0, min(l, s) - window)
                                       if window else 0) for l in lens)
        nbytes = (2 * vis * hkv * row_bytes + 2 * q.numel() * 2
                  + lens_t.numel() * 4)
        flops = 4.0 * vis * hq * d
        t_bound, by = bound(nbytes, flops)
        n_cp = copies_for(sum(t.numel() * t.element_size() for t in args))
        copies = [args] + [tuple(t.clone() for t in args)
                           for _ in range(n_cp - 1)]
        ms, call_ms = time_calls(kern, copies, 100, per_call=1)
        attempts = time_calls.attempts
        plain_ms, _ = time_calls(plain, copies, 10)
        # library yardstick: SDPA with a kv_len mask (over the bf16 view
        # for a quantized cache; the dequantization is not timed)
        kpos = torch.arange(s, device=dev)[None, :]
        mask = kpos < lens_t[:, None]
        if window:
            mask &= kpos >= lens_t[:, None] - window
        mask = mask[:, None, None, :]
        lib_args = [(q[:, :, None], kv_bf16[0], kv_bf16[1], mask)]
        lib_args += [tuple(t.clone() for t in lib_args[0])
                     for _ in range(copies_for(2 * kv_bf16[0].numel() * 2) - 1)]
        lib = lambda qq, kk, vv, mm: F.scaled_dot_product_attention(
            qq, kk, vv, attn_mask=mm, enable_gqa=True)
        lib_ms, _ = time_calls(lib, lib_args, 50)
        splits = num_splits(s)
        grid = dict(ctas=b * hkv * splits, splits=splits, k_chunks=None)
        rows[name] = dict(
            name=name,
            route="cuda",
            source="src/repro_torch/kernels/csrc/decode_attention.cu",
            replaces=("src/repro/kernels/decode_attention.py:82"
                      if fmt == "bf16" else
                      "src/repro/kernels/decode_attention_quant.py:119"),
            shape=shape, path=path or ("main" if fmt == "bf16"
                                       else f"second {fmt}"),
            launches=0, max_abs_err=err, tol=tol, ms=ms,
            call_ms=call_ms, plain_ms=plain_ms, bound_ms=t_bound, bound_by=by,
            library_ms=lib_ms,
            library="torch.nn.functional.scaled_dot_product_attention"
                    " (attn_mask, enable_gqa)",
            grid=grid, trace_attempts=attempts)
        print(f"    device ms {ms:.4f} (per call back to back {call_ms:.4f};"
              f" {attempts} trace(s))  plain {plain_ms:.4f}  sdpa {lib_ms:.4f}  bound {t_bound:.4f} ({by}, "
              f"{nbytes / 1e6:.2f} MB); grid {grid['ctas']} CTAs, "
              f"{splits} splits", flush=True)

    def attention_alone(fmt, lens, window):
        """Slot b of a B 4, S 1024 call has the same bits as the same slot
        decoded alone (B 1) in a cache of 512 positions: the split
        boundaries are absolute cache positions and empty splits add
        nothing."""
        q = randn(4, Hq, D).bfloat16()
        k = randn(4, Hkv, 1024, D).bfloat16()
        v = randn(4, Hkv, 1024, D).bfloat16()
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        if fmt == "bf16":
            cache = (k, v)
            kern = lambda qq, c, ll: decode_attention(qq, *c, ll, window=window)
        else:
            kq, ks = quantize_rows(k, fmt)
            vq, vs = quantize_rows(v, fmt)
            cache = (kq, ks, vq, vs)
            kern = lambda qq, c, ll: decode_attention_quant(
                qq, *c, ll, fmt=fmt, window=window)
        full = kern(q, cache, lens_t)
        for i in range(4):
            alone = kern(q[i:i + 1].contiguous(),
                         tuple(t[i:i + 1, :, :512].contiguous() for t in cache),
                         lens_t[i:i + 1].clone())
            check(torch.equal(alone[0], full[i]),
                  f"decode attention [{fmt}] kv_len {lens[i]} window {window}:"
                  " slot alone (B 1, S 512) differs from the same slot in a "
                  "B 4, S 1024 call")
        print(f"  decode attention [{fmt}] kv_len {lens} window {window}: "
              "every slot bit-equal alone (B 1, S 512) and in B 4, S 1024",
              flush=True)

    print("kernels vs plain versions on the card:", flush=True)
    full = [S] * B
    for fmt in ("bf16", "q8_0", "q4_0"):
        attention_case(fmt, B, Hq, Hkv, S, D, full, 0, timed=True)
        attention_case(fmt, B, Hq, Hkv, S, D, [0, 1, 37, S], 0, timed=False)
        attention_case(fmt, B, Hq, Hkv, S, D, [0, 5, 700, S], 100,
                       timed=False)
        attention_case(fmt, 3, 16, 16, 333, 128, [0, 1, 333], 0,
                       timed=False)
        attention_case(fmt, 2, 4, 2, 50, 32, [3, 50], 0, timed=False)
        # a window whose visible run crosses split boundaries (D 32, G 2)
        attention_case(fmt, 2, 4, 2, 600, 32, [300, 520], 300, timed=False)
        attention_alone(fmt, [255, 256, 257, 500], 0)
        attention_alone(fmt, [127, 128, 129, 300], 0)
        attention_alone(fmt, [300, 500, 257, 400], 100)

    def attn_call(fmt, q, leaves, lens, table=None, plain=False):
        """Decode attention over a cache's leaves (k, v; or k, k_scale, v,
        v_scale), through ``table`` when it is a paged pool."""
        if fmt == "bf16":
            fn = decode_attention_plain if plain else decode_attention
            return fn(q, *leaves, lens, block_table=table)
        fn = decode_attention_quant_plain if plain else decode_attention_quant
        return fn(q, *leaves, lens, fmt=fmt, block_table=table)

    def attention_streams(fmt, reps=32):
        """Split decode attention launched on two streams at once (two
        engines on one card): each launch bit-equal to the same launch
        alone on the default stream. The last CTA of a (slot, kv head) to
        take its merge ticket merges the splits, so the tickets are a
        stream's own (``kernels/tickets.py``). Then the same launches with
        one set of counts for every stream, the keying by device that the
        tickets had before, whose differing launches are counted, not
        checked."""
        with drawing_from(gen_streams):
            q = randn(B, Hq, D).bfloat16()
            k = randn(B, Hkv, S, D).bfloat16()
            v = randn(B, Hkv, S, D).bfloat16()
        leaves = (k, v) if fmt == "bf16" else (
            *quantize_rows(k, fmt), *quantize_rows(v, fmt))
        lens = torch.tensor([S, 700, 1000, 333], dtype=torch.int32,
                            device=dev)
        ref = attn_call(fmt, q, leaves, lens)

        def differing():
            streams = (torch.cuda.Stream(), torch.cuda.Stream())
            for st in streams:
                st.wait_stream(torch.cuda.current_stream())
            outs = []
            for _ in range(reps):
                for st in streams:
                    with torch.cuda.stream(st):
                        outs.append(attn_call(fmt, q, leaves, lens))
            torch.cuda.synchronize()
            return sum(not torch.equal(o, ref) for o in outs), len(outs)
        bad, n = differing()
        keyed = da_mod.tickets
        shared = torch.zeros((4096,), dtype=torch.int32, device=dev)
        da_mod.tickets = lambda n_, device: shared
        try:
            bad_shared, _ = differing()
        finally:
            da_mod.tickets = keyed
        print(f"  decode attention [{fmt}] on two streams at once: {bad} of "
              f"{n} launches differ from the launch alone (with one set of "
              f"tickets for both streams: {bad_shared})", flush=True)
        check(bad == 0, f"decode attention [{fmt}]: {bad} of {n} launches "
              "on two streams differ from the launch alone")
        attention_stream_readings[fmt] = dict(
            launches=n, differ=bad, differ_with_shared_tickets=bad_shared)

    attention_stream_readings = {}

    def paged_pool(fmt, n_blocks, hkv, P, d, g):
        k = randn(n_blocks, hkv, P, d, g=g).bfloat16()
        v = randn(n_blocks, hkv, P, d, g=g).bfloat16()
        if fmt == "bf16":
            return (k, v)
        kq, ks = quantize_rows(k, fmt)
        vq, vs = quantize_rows(v, fmt)
        return (kq, ks, vq, vs)
    for fmt in ("bf16", "q8_0"):
        attention_streams(fmt)

    def shuffled_table(b, max_pages, n_blocks):
        """Row b maps its pages to distinct blocks >= 1 in a shuffled
        order; the last blocks of the pool stay unmapped."""
        perm = torch.randperm(n_blocks - 1, generator=gen_paged,
                              device=dev) + 1
        return perm[:b * max_pages].view(b, max_pages).int().contiguous()

    def paged_attention_case(fmt, b, P, max_pages, lens, hq=Hq, hkv=Hkv,
                             d=D, timed=False, path=None):
        """The paged kernel, reading a pool through a shuffled block
        table, against the dense kernel over ``paged_gather``'s view of
        it: bit-equal (the same splits, tiles and merge order); and within
        one bf16 ulp of the plain version. Timed at the path's shape beside
        the dense kernel, SDPA on the dense view, and ``paged_gather`` +
        the dense kernel (the cost the design avoids)."""
        n_blocks = b * max_pages + 3
        q = randn(b, hq, d, g=gen_paged).bfloat16()
        pool = paged_pool(fmt, n_blocks, hkv, P, d, gen_paged)
        table = shuffled_table(b, max_pages, n_blocks)
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        out = attn_call(fmt, q, pool, lens_t, table)
        view = tuple(paged_gather(t, table).contiguous() for t in pool)
        dense = attn_call(fmt, q, view, lens_t)
        ref = attn_call(fmt, q, pool, lens_t, table, plain=True)
        torch.cuda.synchronize()
        kind = "decode_attention" if fmt == "bf16" else \
            f"decode_attention_quant[{fmt}]"
        shape = (f"B{b} Hq{hq} Hkv{hkv} D{d} P{P} x {max_pages} pages "
                 f"kv_len{lens}")
        check(torch.equal(out, dense), f"{kind} paged {shape}: not "
              "bit-equal to the dense kernel over paged_gather's view")
        err = float((out.float() - ref.float()).abs().max())
        tol = bf16_tol(ref)
        print(f"  {kind} paged {shape}: bit-equal to the dense kernel over "
              f"the gathered view; max_abs_err vs plain {err:.3e} (tol "
              f"{tol:.3e})", flush=True)
        check(err <= tol, f"{kind} paged {shape}: {err} > {tol}")
        if not timed:
            return
        row_bytes = sum(t[0, 0, 0].numel() * t.element_size() for t in pool)
        vis = sum(min(max(l, 0), P * max_pages) for l in lens)
        pages = sum(-(-min(max(l, 0), P * max_pages) // P) for l in lens)
        nbytes = (vis * hkv * row_bytes + 2 * q.numel() * 2
                  + lens_t.numel() * 4 + pages * 4)
        t_bound, by = bound(nbytes, 4.0 * vis * hq * d)
        n_cp = copies_for(sum(t.numel() * t.element_size() for t in pool))
        args = [(q, table, lens_t) + pool] + [
            (q, table, lens_t) + tuple(t.clone() for t in pool)
            for _ in range(n_cp - 1)]
        kern = lambda qq, tb, ll, *lv: attn_call(fmt, qq, lv, ll, tb)
        ms, call_ms = time_calls(kern, args, 100, per_call=1)
        attempts = time_calls.attempts
        views = [(q, lens_t) + view] + [
            (q, lens_t) + tuple(t.clone() for t in view)
            for _ in range(n_cp - 1)]
        dense_ms, _ = time_calls(
            lambda qq, ll, *lv: attn_call(fmt, qq, lv, ll), views, 100,
            per_call=1)
        gather_ms, _ = time_calls(
            lambda qq, tb, ll, *lv: attn_call(
                fmt, qq, tuple(paged_gather(t, tb) for t in lv), ll),
            args, 50)
        plain_ms, _ = time_calls(
            lambda qq, tb, ll, *lv: attn_call(fmt, qq, lv, ll, tb,
                                              plain=True), args, 10)
        bf16_view = view if fmt == "bf16" else (
            dequantize_rows(view[0], view[1], fmt),
            dequantize_rows(view[2], view[3], fmt))
        kpos = torch.arange(P * max_pages, device=dev)[None, :]
        mask = (kpos < lens_t[:, None])[:, None, None, :]
        lib_args = [(q[:, :, None], bf16_view[0], bf16_view[1], mask)]
        lib_args += [tuple(t.clone() for t in lib_args[0])
                     for _ in range(n_cp - 1)]
        lib_ms, _ = time_calls(
            lambda qq, kk, vv, mm: F.scaled_dot_product_attention(
                qq, kk, vv, attn_mask=mm, enable_gqa=True), lib_args, 50)
        splits = num_splits(P * max_pages)
        name = (f"decode_attention[paged P{P}]" if fmt == "bf16" else
                f"decode_attention_quant[{fmt} paged P{P}]")
        rows[name] = dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/decode_attention.cu",
            replaces=("src/repro/kernels/decode_attention.py:82"
                      if fmt == "bf16" else
                      "src/repro/kernels/decode_attention_quant.py:119"),
            shape=shape, path=path, launches=0, max_abs_err=err, tol=tol,
            ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=t_bound,
            bound_by=by, library_ms=lib_ms,
            library="torch.nn.functional.scaled_dot_product_attention on "
                    "the dense (gathered, bf16) view (attn_mask, "
                    "enable_gqa)",
            dense_kernel_ms=dense_ms, gather_plus_kernel_ms=gather_ms,
            bit_equal_to_dense_kernel=True,
            grid=dict(ctas=b * hkv * splits, splits=splits, k_chunks=None),
            trace_attempts=attempts)
        print(f"    device ms {ms:.4f} (per call back to back {call_ms:.4f};"
              f" {attempts} trace(s))  dense kernel {dense_ms:.4f}  "
              f"paged_gather + dense kernel {gather_ms:.4f}  plain "
              f"{plain_ms:.4f}  sdpa on the dense view {lib_ms:.4f}  bound "
              f"{t_bound:.4f} ({by}, {nbytes / 1e6:.2f} MB)", flush=True)

    print("paged decode attention vs the dense kernel over the gathered "
          "view:", flush=True)
    for fmt, path in (("bf16", "paged"), ("q8_0", "second q8_0 paged"),
                      ("q4_0", "second q4_0 paged")):
        # the paged path's shape: 4 slots of 64 pages of 16
        paged_attention_case(fmt, B, 16, 64, [S] * B, timed=True, path=path)
        for P in (8, 16, 64, 128):
            mp = S // P
            paged_attention_case(fmt, 6, P, mp,
                                 [0, 1, P - 1, P, P + 1, mp * P])
        paged_attention_case(fmt, 4, 16, 64, [0, 300, 17, 1000])
        # reduced widths (D 32, G 2) and D 128 (G 1)
        paged_attention_case(fmt, 3, 8, 8, [0, 9, 64], hq=4, hkv=2, d=32)
        paged_attention_case(fmt, 2, 32, 4, [33, 128], hq=16, hkv=16,
                             d=128)

    linear_shapes = {
        "wqkv": (cfg_full.d_model, cfg_full.q_dim + 2 * cfg_full.kv_dim),
        "wo": (cfg_full.q_dim, cfg_full.d_model),
        "w_gate_up": (cfg_full.d_model, 2 * cfg_full.d_ff),
        "w_down": (cfg_full.d_ff, cfg_full.d_model),
    }

    def qmm_case(fmt, label, M, K, N, out_dtype, timed, path=None):
        x = randn(M, K).bfloat16()
        w = quantize(randn(K, N, scale=K ** -0.5), fmt)
        out = quant_matmul(x, w, out_dtype=out_dtype)
        ref = quant_matmul_plain(x, w, out_dtype)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        # f32 logits: 1e-5 of the scale up to K 4096 (every head before
        # the assigned dense models'), growing with K past it, as the
        # error of a K-term f32 sum in another order does (a K 8192 head
        # read 1.04e-5 of its scale on the H100, PERF.md)
        tol = (bf16_tol(ref) if out_dtype == torch.bfloat16
               else 1e-5 * max(1.0, K / 4096) * float(ref.abs().max()))
        name = f"quant_matmul[{fmt} {label} {K}x{N}" + (
            "]" if M <= 8 else f" M{M}]")
        print(f"  {name} M{M} -> {out_dtype}: max_abs_err {err:.3e} "
              f"(tol {tol:.3e})", flush=True)
        check(err <= tol, f"{name} M{M}: {err} > {tol}")
        if M > 8:
            # an output row must not depend on how many rows share the
            # call: the same rows alone (M = 1) give the same bits
            for r in (0, M // 2, M - 1):
                alone = quant_matmul(x[r:r + 1].contiguous(), w,
                                     out_dtype=out_dtype)
                check(torch.equal(alone[0], out[r]),
                      f"{name}: row {r} of the M {M} call differs from "
                      "the same row alone (M 1)")
            print(f"    rows 0, {M // 2}, {M - 1} bit-equal to M 1 calls",
                  flush=True)
        if not timed:
            return
        nbytes = (x.numel() * 2 + w.data.numel() + w.scales.numel() * 2
                  + M * N * out.element_size())
        t_bound, by = bound(nbytes, 2.0 * M * K * N)
        n_cp = copies_for(w.quant_nbytes)
        copies = [(x, w)] + [(x, dataclasses.replace(
            w, data=w.data.clone(), scales=w.scales.clone()))
            for _ in range(n_cp - 1)]
        # the GEMM, and the second pass where K is split across CTAs
        ctas, splits, chunks = launch_grid(M, K, N, w.group)
        ms, call_ms = time_calls(
            lambda a, b: quant_matmul(a, b, out_dtype=out_dtype), copies,
            100 if M <= 8 else 20, per_call=1 + (splits > 1))
        attempts = time_calls.attempts
        plain_ms, _ = time_calls(
            lambda a, b: quant_matmul_plain(a, b, out_dtype), copies, 10)
        wd = dequantize(w, torch.bfloat16)
        lib_copies = [(x, wd)] + [(x, wd.clone()) for _ in
                                  range(copies_for(wd.numel() * 2) - 1)]
        lib_ms, _ = time_calls(torch.matmul, lib_copies, 50)
        grid = dict(ctas=ctas, splits=splits, k_chunks=chunks)
        rows[name] = dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/quant_matmul.cu",
            replaces="src/repro/kernels/quant_matmul.py:79",
            shape=f"M{M} K{K} N{N}", path=path, launches=0,
            max_abs_err=err, tol=tol,
            ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=t_bound, bound_by=by,
            library_ms=lib_ms,
            library="torch.matmul on pre-dequantized bf16 weights",
            grid=grid, trace_attempts=attempts)
        print(f"    device ms {ms:.4f} (per call back to back {call_ms:.4f};"
              f" {attempts} trace(s))"
              f"  plain {plain_ms:.4f}  matmul(bf16) {lib_ms:.4f}  bound {t_bound:.4f} ({by}, "
              f"{nbytes / 1e6:.2f} MB); grid {ctas} CTAs, {splits} along K, "
              f"{chunks} K chunks", flush=True)

    for fmt in ("q8_0", "q4_0"):
        for label, (K, N) in linear_shapes.items():
            qmm_case(fmt, label, B, K, N, torch.bfloat16, timed=True,
                     path="main" if fmt == "q8_0" else "second q4_0")
        qmm_case(fmt, "wo", 1, *linear_shapes["wo"], torch.bfloat16,
                 timed=False)
        qmm_case(fmt, "wqkv", 3, *linear_shapes["wqkv"], torch.float32,
                 timed=False)
        qmm_case(fmt, "ragged", 9, 96, 50, torch.bfloat16, timed=False)
    # prefill M: a bucket of 4 x 512 rows, and a ragged 333
    for label, (K, N) in linear_shapes.items():
        qmm_case("q8_0", label, 2048, K, N, torch.bfloat16, timed=True,
                 path="prefill")
        qmm_case("q8_0", label, 333, K, N, torch.bfloat16, timed=False)
    qmm_case("q4_0", "w_gate_up", 2048, *linear_shapes["w_gate_up"],
             torch.bfloat16, timed=True, path="second q8_0 stall")
    qmm_case("q4_0", "w_gate_up", 333, *linear_shapes["w_gate_up"],
             torch.bfloat16, timed=False)

    def qmm_swiglu_case(fmt, M, K, Fw, timed=False, path=None, act="silu",
                        g=None):
        """The gate-up GEMM with the SwiGLU (``act`` "gelu": the GeGLU) as
        its last step: bit-equal to the unfused kernels (quant_matmul, then
        swiglu / geglu) on the card, within one bf16 ulp of the plain
        version, every row bit-equal to the same row alone (M 1); timed
        beside the unfused pair, in turns (fused, pair, pair, fused), where
        a path runs it. ``g``: the generator (default ``gen_gate_up``)."""
        g = g or gen_gate_up
        glu = geglu if act == "gelu" else swiglu
        x = randn(M, K, g=g).bfloat16()
        w = quantize(randn(K, 2 * Fw, scale=K ** -0.5, g=g), fmt)
        h = quant_matmul_swiglu(x, w, act=act)
        pair = glu(quant_matmul(x, w))
        ref = quant_matmul_swiglu_plain(x, w, act)
        torch.cuda.synchronize()
        ctas, splits, chunks = launch_grid(M, K, 2 * Fw, w.group)
        route = ("split-K merge" if splits > 1 else "two-CTA clusters")
        err = float((h.float() - ref.float()).abs().max())
        tol = bf16_tol(ref)
        name = f"quant_matmul_swiglu[{fmt} K{K} F{Fw}" + (
            " geglu" if act == "gelu" else "") + (
            "]" if M <= 8 else f" M{M}]")
        print(f"  {name} M{M} ({route}, {chunks} K chunks): bit-equal to "
              f"{glu.__name__}(quant_matmul(x, w)) {torch.equal(h, pair)}; "
              f"max_abs_err vs plain {err:.3e} (tol {tol:.3e})", flush=True)
        check(h.shape == (M, Fw) and torch.equal(h, pair),
              f"{name} M{M}: {int((h != pair).sum())} elements differ from "
              f"{glu.__name__}(quant_matmul(x, w)) on the card")
        check(err <= tol, f"{name} M{M}: {err} > {tol}")
        if M > 1:
            for r in (0, M // 2, M - 1):
                alone = quant_matmul_swiglu(x[r:r + 1].contiguous(), w,
                                            act=act)
                check(torch.equal(alone[0], h[r]),
                      f"{name}: row {r} of the M {M} call differs from the "
                      "same row alone (M 1)")
            print(f"    rows 0, {M // 2}, {M - 1} bit-equal to M 1 calls",
                  flush=True)
        if not timed:
            return
        nbytes = (x.numel() * 2 + w.data.numel() + w.scales.numel() * 2
                  + M * Fw * 2)
        t_bound, by = bound(nbytes, 2.0 * M * K * 2 * Fw)
        n_cp = copies_for(w.quant_nbytes)
        copies = [(x, w)] + [(x, dataclasses.replace(
            w, data=w.data.clone(), scales=w.scales.clone()))
            for _ in range(n_cp - 1)]
        reps, per = (100 if M <= 8 else 20), 1 + (splits > 1)
        fused_runs, pair_runs, call_ms, attempts = [], [], [], []
        for first in (True, False):
            for is_fused in ((True, False) if first else (False, True)):
                if is_fused:
                    ms, c_ms = time_calls(
                        lambda a, b: quant_matmul_swiglu(a, b, act=act),
                        copies, reps, per_call=per)
                    fused_runs.append(ms)
                    call_ms.append(c_ms)
                    attempts.append(time_calls.attempts)
                else:
                    pair_runs.append(time_calls(
                        lambda a, b: glu(quant_matmul(a, b)), copies,
                        reps, per_call=per + 1)[0])
        ms, pair_ms = sum(fused_runs) / 2, sum(pair_runs) / 2
        plain_ms, _ = time_calls(
            lambda a, b: quant_matmul_swiglu_plain(a, b, act), copies, 10)
        rows[name] = dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/quant_matmul.cu",
            replaces="src/repro/kernels/quant_matmul.py:79",
            fuses="src/repro/models/mlp.py:42-48",
            shape=f"M{M} K{K} N{2 * Fw} -> h F{Fw}", path=path, launches=0,
            max_abs_err=err, tol=tol, ms=ms, call_ms=sum(call_ms) / 2,
            plain_ms=plain_ms, bound_ms=t_bound, bound_by=by,
            library_ms=None, library=None, unfused_ms=pair_ms,
            unfused=f"quant_matmul then {glu.__name__}, the kernels at this "
                    "shape",
            ms_runs=fused_runs, unfused_ms_runs=pair_runs,
            grid=dict(ctas=ctas, splits=splits, k_chunks=chunks,
                      route=route),
            trace_attempts=attempts)
        print(f"    device ms {ms:.4f} (runs {fused_runs[0]:.4f}, "
              f"{fused_runs[1]:.4f}; per call back to back "
              f"{sum(call_ms) / 2:.4f}; traces {attempts})  unfused pair "
              f"{pair_ms:.4f} (runs {pair_runs[0]:.4f}, {pair_runs[1]:.4f})"
              f"  plain {plain_ms:.4f}  bound {t_bound:.4f} ({by}, "
              f"{nbytes / 1e6:.2f} MB); grid {ctas} CTAs, {splits} along K,"
              f" {chunks} K chunks", flush=True)

    # the FFN's gate-up product with its SwiGLU at the paths' shapes (the
    # main path's decode M and the prefill's first bucket), then M 1, 9
    # and 333, reduced widths through both routes (K 64: one chunk, two-CTA
    # clusters; K 256: two chunks, the split-K merge; F 100 and F 8: no
    # 16-byte-aligned up block, element copies), and one chunk at full
    # width and decode M (K 128: clusters of 8-row CTAs)
    K_gu, F_gu = cfg_full.d_model, cfg_full.d_ff
    for fmt, paths in (("q8_0", ("main", "prefill")),
                       ("q4_0", ("second q4_0", "second q8_0 stall"))):
        qmm_swiglu_case(fmt, B, K_gu, F_gu, timed=True, path=paths[0])
        qmm_swiglu_case(fmt, 2048, K_gu, F_gu, timed=True, path=paths[1])
        for M in (1, 9, 333):
            qmm_swiglu_case(fmt, M, K_gu, F_gu)
        for M, K, Fw in ((4, 64, 100), (4, 64, 8), (333, 64, 100),
                         (9, 256, 100), (4, 256, 8), (4, 128, F_gu)):
            qmm_swiglu_case(fmt, M, K, Fw)

    def visible_pairs(sq, skv, window, q_offset):
        """(query, key) pairs the causal (and window) mask lets through:
        the work the attention must do for these inputs."""
        n = 0
        for i in range(sq):
            pos = i + q_offset
            lo = max(0, pos - window + 1) if window else 0
            n += max(0, min(skv - 1, pos) - lo + 1)
        return n

    def padded_plain(q, k, v, **kw):
        """The plain version, over the inputs padded with zero positions
        to a multiple of its 512-position block where Sq = Skv is not one
        (its blocks halve until they divide S: at S 4500 they would be 4
        positions, a loop of a million steps); the causal rows of the
        first Sq positions see no padded key."""
        sq = q.shape[2]
        pad = -sq % 512 if sq == k.shape[2] and sq > 512 else 0
        if not pad:
            return flash_attention_plain(q, k, v, **kw)
        grow = lambda t: F.pad(t, (0, 0, 0, pad))
        return flash_attention_plain(grow(q), grow(k), grow(v),
                                     **kw)[:, :, :sq]

    def flash_case(b, hq, hkv, sq, skv, d, window, q_offset, timed,
                   instance=None, path="prefill"):
        """``instance`` names a (head_dim, G) instance of a paper model
        (and the window) in the row's name; ``path`` is the served run
        whose launches the row reports."""
        q = randn(b, hq, sq, d).bfloat16()
        k = randn(b, hkv, skv, d).bfloat16()
        v = randn(b, hkv, skv, d).bfloat16()
        kw = dict(causal=True, window=window, q_offset=q_offset)
        out = flash_attention(q, k, v, **kw)
        ref = padded_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        tol = bf16_tol(ref)
        shape = (f"B{b} Hq{hq} Hkv{hkv} Sq{sq} Skv{skv} D{d} window{window} "
                 f"q_offset{q_offset}")
        print(f"  flash_attention {shape}: max_abs_err {err:.3e} "
              f"(tol {tol:.3e})", flush=True)
        check(err <= tol, f"flash_attention {shape}: {err} > {tol}")
        if not timed:
            return
        # the design anchors tiles at position 0: a row's bits do not
        # depend on how far the sequence runs on after it
        cut = sq * 3 // 5
        part = flash_attention(*(t[:, :, :cut].contiguous()
                                 for t in (q, k, v)), **kw)
        check(torch.equal(part, out[:, :, :cut]),
              f"flash_attention {shape}: rows of the first {cut} positions "
              f"differ from the same rows at Sq {cut}")
        nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * 2
        flops = 4.0 * visible_pairs(sq, skv, window, q_offset) * b * hq * d
        t_bound, by = bound(nbytes, flops)
        n_cp = copies_for(nbytes)
        copies = [(q, k, v)] + [tuple(t.clone() for t in (q, k, v))
                                for _ in range(n_cp - 1)]
        # the kernel and SDPA in turn, three times: the medians go in the
        # row, the spreads beside them. SDPA takes a window as a boolean
        # mask of the visible (query, key) pairs
        if window:
            qpos = torch.arange(sq, device=dev)[:, None] + q_offset
            kpos = torch.arange(skv, device=dev)[None, :]
            band = (kpos <= qpos) & (kpos > qpos - window)
            lib = lambda qq, kk, vv: F.scaled_dot_product_attention(
                qq, kk, vv, attn_mask=band, enable_gqa=True)
            lib_name = ("torch.nn.functional.scaled_dot_product_attention"
                        " (attn_mask: the causal window, enable_gqa)")
        else:
            lib = lambda qq, kk, vv: F.scaled_dot_product_attention(
                qq, kk, vv, is_causal=True, enable_gqa=True)
            lib_name = ("torch.nn.functional.scaled_dot_product_attention"
                        " (is_causal, enable_gqa)")
        kern_ms, lib_ms_all, call_ms_all, attempts = [], [], [], []
        for _ in range(3):
            ms, call_ms = time_calls(lambda *a: flash_attention(*a, **kw),
                                     copies, 100, per_call=1)
            kern_ms.append(ms)
            call_ms_all.append(call_ms)
            attempts.append(time_calls.attempts)
            lib_ms_all.append(time_calls(lib, copies, 50)[0])
        ms, call_ms, lib_ms = (sorted(x)[1] for x in
                               (kern_ms, call_ms_all, lib_ms_all))
        plain_ms, _ = time_calls(lambda *a: padded_plain(*a, **kw),
                                 copies, 5)
        pl = fa_mod.plan(b, hq, hkv, sq, skv, d, **kw, sms=sms)
        name = (f"flash_attention[{instance} B{b} S{sq}"
                + (f" window{window}]" if window else "]")
                if instance else f"flash_attention[B{b} S{sq}]")
        rows[name] = dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:87",
            shape=shape, path=path, launches=0, max_abs_err=err,
            tol=tol, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
            bound_ms=t_bound, bound_by=by, library_ms=lib_ms,
            library=lib_name,
            grid=dict(ctas=pl.ctas, splits=None, k_chunks=None,
                      work_items=pl.items, block_q=pl.block_q,
                      block_k=pl.block_k),
            ms_runs=kern_ms, library_ms_runs=lib_ms_all,
            trace_attempts=attempts)
        print(f"    rows of Sq {cut} bit-equal to the same rows at Sq {sq}; "
              f"device ms {ms:.4f} of {', '.join(f'{t:.4f}' for t in kern_ms)}"
              f" (per call back to back {call_ms:.4f}; traces {attempts})  "
              f"plain {plain_ms:.4f}  sdpa {lib_ms:.4f} of "
              f"{', '.join(f'{t:.4f}' for t in lib_ms_all)}  bound "
              f"{t_bound:.4f} ({by}, {nbytes / 1e6:.2f} MB, "
              f"{flops / 1e9:.2f} GFLOP); {pl.items} work items of block_q "
              f"{pl.block_q}, block_k {pl.block_k} on {pl.ctas} CTAs",
              flush=True)

    # the prefill path's shapes (4 x 512, 3 x 1024 and 1 x 512 buckets),
    # then Sq 1, ragged S, a query block past the keys, two windows, the
    # other instantiated (head_dim, G) pairs, and rows with no visible key
    flash_shapes = ((4, 512), (3, 1024), (1, 512))
    for b, s_len in flash_shapes:
        flash_case(b, Hq, Hkv, s_len, s_len, D, 0, 0, timed=True)
    for case in ((2, Hq, Hkv, 1, 1, D, 0, 0), (2, Hq, Hkv, 333, 333, D, 0, 0),
                 (2, Hq, Hkv, 100, 300, D, 0, 200),
                 (2, Hq, Hkv, 512, 512, D, 16, 0),
                 (2, Hq, Hkv, 333, 333, D, 100, 0),
                 (2, 32, 32, 200, 200, 128, 0, 0),
                 (2, 4, 2, 130, 130, 32, 0, 0),
                 (1, Hq, Hkv, 24, 16, D, 12, 8)):
        flash_case(*case, timed=False)
    tiles = {f"{b} x {s_len}": fa_mod.plan(b, Hq, Hkv, s_len, s_len, D,
                                           sms=sms)
             for b, s_len in flash_shapes}
    t4 = tiles["4 x 512"]
    print(f"flash_attention tiles: block_q {t4.block_q} queries of one head"
          f" a work item, block_k {t4.block_k}; work items on persistent CTAs "
          + ", ".join(f"{pl.items} on {pl.ctas} ({name})"
                      for name, pl in tiles.items()), flush=True)

    # the tied unembedding is a library product (torch.mm to f32 logits):
    # does one row's result depend on how many rows share the call?
    emb = randn(cfg_full.padded_vocab, cfg_full.d_model,
                scale=cfg_full.d_model ** -0.5).bfloat16()
    xs = randn(4, cfg_full.d_model).bfloat16()
    rows4 = ops.matmul(xs, emb.t(), out_dtype=torch.float32)
    unembed_rows_equal = {
        m: bool(torch.equal(ops.matmul(xs[:m], emb.t(),
                                       out_dtype=torch.float32)[0], rows4[0]))
        for m in (1, 2, 3)}
    print("  unembed (torch.mm, f32 logits): row 0 bit-equal to the M 4 "
          f"call at M 1/2/3: {unembed_rows_equal}", flush=True)
    del emb, xs, rows4

    # -- the fused small ops (no Pallas counterpart: XLA fuses them) --------
    fused_src = "src/repro_torch/kernels/csrc/fused_ops.cu"

    def fused_row(name, kern, plain, copies, nbytes, replaces, shape, path,
                  err, tol, lib=None, lib_name=None):
        """Time a fused kernel, its plain version and (where one PyTorch
        call computes the same function) that call, and keep its row.
        ``copies`` of the inputs exceed the L2 together where 100 copies
        can (at M 2048); the decode shapes' inputs are a few kB, which
        the path finds fresh from the kernel before."""
        ms, call_ms = time_calls(kern, copies, 100, per_call=1)
        attempts = time_calls.attempts
        plain_ms, _ = time_calls(plain, copies, 20)
        lib_ms = time_calls(lib, copies, 50)[0] if lib else None
        t_bound, by = bound(nbytes, 0.0)
        rows[name] = dict(
            name=name, route="cuda", source=fused_src, replaces=replaces,
            no_pallas_counterpart=True, shape=shape, path=path, launches=0,
            max_abs_err=err, tol=tol, ms=ms, call_ms=call_ms,
            plain_ms=plain_ms, bound_ms=t_bound, bound_by=by,
            library_ms=lib_ms, library=lib_name,
            grid=None, trace_attempts=attempts)
        print(f"    device ms {ms:.4f} (per call back to back {call_ms:.4f};"
              f" {attempts} trace(s))  plain {plain_ms:.4f}  library "
              + (f"{lib_ms:.4f}" if lib else "-")
              + f"  bound {t_bound:.4f} ({by}, {nbytes / 1e6:.3f} MB)",
              flush=True)

    def n_copies(nbytes):
        return min(copies_for(nbytes), 100)

    def rowwise_case(name, kern, plain, args, shape, timed, path, nbytes,
                     replaces, lib=None, lib_name=None):
        """RMSNorm or SwiGLU against its plain version (within one bf16
        ulp at the output's scale, 1e-5 of it for f32), and timed where
        the path runs it."""
        out, ref = kern(*args), plain(*args)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        tol = (bf16_tol(ref) if out.dtype == torch.bfloat16
               else 1e-5 * float(ref.abs().max()))
        print(f"  {name} {shape}: max_abs_err {err:.3e} (tol {tol:.3e}), "
              f"{int((out != ref).sum())} of {out.numel()} elements differ",
              flush=True)
        check(err <= tol, f"{name} {shape}: {err} > {tol}")
        if not timed:
            return
        x = args[0]
        copies = [args] + [(x.clone(),) + tuple(args[1:]) for _ in
                           range(n_copies(x.numel() * x.element_size()) - 1)]
        fused_row(f"{name}[{shape.rsplit(' ', 1)[0]}]", kern, plain, copies,
                  nbytes, replaces, shape, path, err, tol, lib, lib_name)

    def rmsnorm_case(M, d, dtype, timed=False, path=None):
        x = (randn(M, d) * 3).to(dtype)
        w = (1 + 0.1 * randn(d)).bfloat16()
        eps = cfg_full.norm_eps
        rowwise_case("rmsnorm", lambda a, b: rmsnorm(a, b, eps),
                     lambda a, b: rmsnorm_plain(a, b, eps), (x, w),
                     f"M{M} d{d} {str(dtype)[6:]}", timed, path,
                     2 * x.numel() * x.element_size() + w.numel() * 2,
                     "src/repro/models/layers.py:26",
                     lib=lambda a, b: F.rms_norm(a, (d,), b, eps),
                     lib_name="torch.nn.functional.rms_norm")

    def swiglu_case(M, Fw, dtype, timed=False, path=None):
        gu = (randn(M, 2 * Fw) * 2).to(dtype)
        rowwise_case("swiglu", swiglu, swiglu_plain, (gu,),
                     f"M{M} F{Fw} {str(dtype)[6:]}", timed, path,
                     3 * M * Fw * gu.element_size(),
                     "src/repro/models/mlp.py:37")

    def unpacked(payload, fmt):
        return (unpack_int4_rows(payload) if fmt == "q4_0"
                else payload).to(torch.int32)

    def ties(x, fmt, ng):
        """Where x (..., D) bf16 divided by its group's f32 scale lands on
        an exact .5: the plain version's division there may round either
        way."""
        D = x.shape[-1]
        qmax = 127.0 if fmt == "q8_0" else 7.0
        xg = x.float().reshape(x.shape[:-1] + (ng, D // ng))
        sc = xg.abs().amax(dim=-1) / qmax
        sc = torch.where(sc == 0, torch.ones_like(sc), sc)
        r = (xg / sc[..., None]).abs()
        return ((r - r.floor()) == 0.5).reshape(x.shape)

    def rope_case(fmt, b, hq, hkv, s_len, d, lens, advance, timed=False,
                  path=None, with_bias=False):
        """``with_bias``: the fused-QKV bias (qwen2's), drawn from
        ``gen_added``, added by the kernel."""
        theta = cfg_full.rope_theta
        qkv = randn(b, (hq + 2 * hkv) * d).bfloat16()
        bias = (randn((hq + 2 * hkv) * d, g=gen_added).bfloat16()
                if with_bias else None)
        old = randn(b, hkv, s_len, d).bfloat16()
        if fmt == "bf16":
            cache = {"k": old, "v": (old * 0.5).contiguous()}
        else:
            kq, ks = quantize_rows(old, fmt)
            vq, vs = quantize_rows(old * 0.5, fmt)
            cache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        adv = (None if advance is None
               else torch.tensor(advance, dtype=torch.bool, device=dev))
        ck = {n: t.clone() for n, t in cache.items()}
        cp = {n: t.clone() for n, t in cache.items()}
        q = rope_cache_write(qkv, ck, lens_t, adv, theta, fmt, bias=bias)
        qp = rope_cache_write_plain(qkv, cp, lens_t, adv, theta, fmt,
                                    bias=bias)
        torch.cuda.synchronize()
        err = float((q.float() - qp.float()).abs().max())
        tol = bf16_tol(qp)
        shape = (f"B{b} Hq{hq} Hkv{hkv} S{s_len} D{d} lens{lens} "
                 f"advance{advance}" + (" bias" if with_bias else ""))
        label = f"rope_cache_write[{fmt}] {shape}"
        check(err <= tol, f"{label}: q {err} > {tol}")
        written = torch.zeros((b, s_len), dtype=torch.bool, device=dev)
        for i, pos in enumerate(lens):
            written[i, pos % s_len] = advance is None or advance[i]
        frozen = ~written[:, None, :].expand(b, hkv, s_len)
        for n, leaf in ck.items():
            check(torch.equal(leaf[frozen], cache[n][frozen]),
                  f"{label}: {n} changed outside the written ring slots")
        biased = qkv if bias is None else qkv + bias
        kr = fused_ops.apply_rope(
            biased[:, hq * d:(hq + hkv) * d].reshape(b, hkv, d), lens_t,
            theta)
        vr = biased[:, (hq + hkv) * d:].reshape(b, hkv, d)
        n_ties = 0
        for i, pos in enumerate(lens):
            if not (advance is None or advance[i]):
                continue
            sl = pos % s_len
            if fmt == "bf16":
                check(float((ck["k"][i, :, sl].float()
                             - cp["k"][i, :, sl].float()).abs().max())
                      <= bf16_tol(cp["k"][i, :, sl]),
                      f"{label}: K row {i} beyond one bf16 ulp")
                check(torch.equal(ck["v"][i, :, sl], cp["v"][i, :, sl]),
                      f"{label}: V row {i} differs")
                continue
            ng = ck["k_scale"].shape[-1]
            for n, x in (("k", kr[i]), ("v", vr[i])):
                check(torch.equal(ck[f"{n}_scale"][i, :, sl],
                                  cp[f"{n}_scale"][i, :, sl]),
                      f"{label}: {n}_scale row {i} not bit-equal")
                diff = (unpacked(ck[n][i, :, sl], fmt)
                        - unpacked(cp[n][i, :, sl], fmt)).abs()
                check(int(diff.max()) <= 1 and bool(
                    ((diff == 0) | ties(x, fmt, ng)).all()),
                    f"{label}: {n} payload row {i} off by more than one "
                    "step, or off where the division is no .5 tie")
                n_ties += int((diff > 0).sum())
        print(f"  {label}: q max_abs_err {err:.3e} (tol {tol:.3e}); cache "
              f"rows as the plain version's ({n_ties} payload elements one "
              "step off on .5 ties), frozen rows and other slots "
              "untouched", flush=True)
        if not timed:
            return
        n_adv = b if advance is None else sum(advance)
        row_bytes = sum(t[0, 0, 0].numel() * t.element_size()
                        for t in ck.values())
        nbytes = (qkv.numel() * 2 + b * 4 + (0 if adv is None else b)
                  + q.numel() * 2 + n_adv * hkv * row_bytes)
        copies = [(qkv, ck, lens_t, adv)] + [
            (qkv.clone(), ck, lens_t, adv)
            for _ in range(n_copies(qkv.numel() * 2) - 1)]
        if bias is not None:
            nbytes += bias.numel() * 2
        fused_row(f"rope_cache_write[{fmt}" + (" bias]" if with_bias
                                               else "]"),
                  lambda a, c, ln, av: rope_cache_write(a, c, ln, av, theta,
                                                        fmt, bias=bias),
                  lambda a, c, ln, av: rope_cache_write_plain(
                      a, c, ln, av, theta, fmt, bias=bias), copies, nbytes,
                  "src/repro/models/layers.py:51", shape, path, err, tol)

    def add_rmsnorm_case(M, d, dtype, timed=False, path=None):
        """The residual add and the norm of its sum against the plain
        version: h bit-equal, out within one bf16 ulp at its scale (1e-5
        of it for f32) and bit-equal to the rmsnorm kernel on h."""
        x = (randn(M, d, g=gen_added) * 3).to(dtype)
        z = randn(M, d, g=gen_added).to(dtype)
        w = (1 + 0.1 * randn(d, g=gen_added)).bfloat16()
        eps = cfg_full.norm_eps
        shape = f"M{M} d{d} {str(dtype)[6:]}"
        h, out = add_rmsnorm(x, z, w, eps)
        ph, pout = add_rmsnorm_plain(x, z, w, eps)
        alone = rmsnorm(h, w, eps)
        torch.cuda.synchronize()
        err = float((out.float() - pout.float()).abs().max())
        tol = (bf16_tol(pout) if dtype == torch.bfloat16
               else 1e-5 * float(pout.abs().max()))
        print(f"  add_rmsnorm {shape}: h bit-equal {torch.equal(h, ph)}; out "
              f"max_abs_err {err:.3e} (tol {tol:.3e}), "
              f"{int((out != pout).sum())} of {out.numel()} elements differ; "
              f"out bit-equal to rmsnorm(h) {torch.equal(out, alone)}",
              flush=True)
        check(torch.equal(h, ph), f"add_rmsnorm {shape}: h differs from "
              "the plain x + delta")
        check(err <= tol, f"add_rmsnorm {shape}: {err} > {tol}")
        check(torch.equal(out, alone), f"add_rmsnorm {shape}: out differs "
              "from the rmsnorm kernel on h")
        if not timed:
            return
        copies = [(x, z, w)] + [(x.clone(), z.clone(), w) for _ in range(
            n_copies(2 * x.numel() * x.element_size()) - 1)]
        fused_row(f"add_rmsnorm[M{M} d{d}]",
                  lambda a, b, c: add_rmsnorm(a, b, c, eps),
                  lambda a, b, c: add_rmsnorm_plain(a, b, c, eps), copies,
                  4 * x.numel() * x.element_size() + w.numel() * 2,
                  "src/repro/models/layers.py:26", shape, path, err, tol)

    def rope_prefill_case(fmt, b, s_len, s_cache, hq, hkv, d, timed=False,
                          path=None, with_bias=False):
        """The prefill RoPE + cache write against its plain version: q,
        k, v and the bf16 cache rows bit-equal, quantized scales
        bit-equal and payloads one step off only on .5 ties, cache
        positions from s_len on untouched (s_len > s_cache: the ring
        write, every position written). ``with_bias``: the fused-QKV
        bias, added by the kernel."""
        theta = cfg_full.rope_theta
        qkv = randn(b, s_len, (hq + 2 * hkv) * d, g=gen_added).bfloat16()
        bias = (randn((hq + 2 * hkv) * d, g=gen_added).bfloat16()
                if with_bias else None)
        old = randn(b, hkv, s_cache, d, g=gen_added).bfloat16()
        if fmt == "bf16":
            cache = {"k": old, "v": (old * 0.5).contiguous()}
        else:
            kq, ks = quantize_rows(old, fmt)
            vq, vs = quantize_rows(old * 0.5, fmt)
            cache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        ck = {n: t.clone() for n, t in cache.items()}
        cp = {n: t.clone() for n, t in cache.items()}
        got = rope_cache_write_prefill(qkv, ck, theta, fmt, bias=bias)
        want = rope_cache_write_prefill_plain(qkv, cp, theta, fmt,
                                              bias=bias)
        torch.cuda.synchronize()
        shape = (f"B{b} S{s_len} S_cache{s_cache} Hq{hq} Hkv{hkv} D{d}"
                 + (" bias" if with_bias else ""))
        kept = min(s_len, s_cache)           # cache rows the call writes
        label = f"rope_cache_write_prefill[{fmt}] {shape}"
        err = max(float((g_.float() - w_.float()).abs().max())
                  for g_, w_ in zip(got, want))
        for n, g_, w_ in zip("qkv", got, want):
            check(g_.shape == w_.shape and torch.equal(g_, w_),
                  f"{label}: {n} not bit-equal to the plain version's "
                  f"({int((g_ != w_).sum())} elements differ)")
        for n, leaf in ck.items():
            check(torch.equal(leaf[:, :, s_len:], cache[n][:, :, s_len:]),
                  f"{label}: {n} changed at positions from {s_len} on")
        n_ties = 0
        if fmt == "bf16":
            for n in ("k", "v"):
                check(torch.equal(ck[n], cp[n]), f"{label}: {n} cache rows "
                      "not bit-equal to the plain version's")
        else:
            ng = ck["k_scale"].shape[-1]
            for n, x in (("k", got[1]), ("v", got[2])):
                check(torch.equal(ck[f"{n}_scale"], cp[f"{n}_scale"]),
                      f"{label}: {n}_scale not bit-equal")
                if s_len > s_cache:          # ring slot j: its position
                    x = x[:, :, s_len - s_cache
                          + (torch.arange(s_cache, device=dev) - s_len)
                          % s_cache]
                diff = (unpacked(ck[n][:, :, :kept], fmt)
                        - unpacked(cp[n][:, :, :kept], fmt)).abs()
                check(int(diff.max()) <= 1 and bool(
                    ((diff == 0) | ties(x, fmt, ng)).all()),
                    f"{label}: {n} payload off by more than one step, or "
                    "off where the division is no .5 tie")
                n_ties += int((diff > 0).sum())
        print(f"  {label}: q, k, v bit-equal; cache rows as the plain "
              f"version's ({n_ties} payload elements one step off on .5 "
              f"ties), " + (f"positions from {s_len} on untouched"
                            if s_len < s_cache else
                            f"the last {s_cache} positions at their ring "
                            "slots" if s_len > s_cache else
                            "every position written"), flush=True)
        if not timed:
            return
        row_bytes = sum(t[0, 0, 0].numel() * t.element_size()
                        for t in ck.values())
        nbytes = (2 * qkv.numel() + 2 * sum(t.numel() for t in got)
                  + b * hkv * kept * row_bytes
                  + (0 if bias is None else bias.numel() * 2))
        copies = [(qkv, ck)] + [(qkv.clone(), ck) for _ in range(
            n_copies(qkv.numel() * 2) - 1)]
        form = (" ring" if s_len > s_cache else "") + (
            " bias" if with_bias else "")
        fused_row(f"rope_cache_write_prefill[{fmt}{form} B{b} S{s_len}]",
                  lambda a, c: rope_cache_write_prefill(a, c, theta, fmt,
                                                        bias=bias),
                  lambda a, c: rope_cache_write_prefill_plain(
                      a, c, theta, fmt, bias=bias),
                  copies, nbytes, "src/repro/models/layers.py:51", shape,
                  path, err, 0.0)

    print("fused small ops vs plain versions on the card:", flush=True)
    d_model, d_ff = cfg_full.d_model, cfg_full.d_ff
    # the standalone SwiGLU runs under plain weights (the plain-weight leg
    # of section 8) and under the unfused V0 whatever the weights (its
    # rows report V0's main path and stall leg, llama3.2-1b's widths):
    # with quantized V1 weights the gate-up GEMM computes it
    for M, path in ((B, "main"), (2048, "prefill")):
        rmsnorm_case(M, d_model, torch.bfloat16, timed=True, path=path)
        swiglu_case(M, d_ff, torch.bfloat16, timed=True,
                    path="v0 main" if M == B else "v0 stall")
    for M in (1, 333):
        rmsnorm_case(M, d_model, torch.bfloat16)
        swiglu_case(M, d_ff, torch.bfloat16)
    for M, d in ((3, 128), (5, 100), (7, 1)):       # reduced, ragged widths
        rmsnorm_case(M, d, torch.bfloat16)
        swiglu_case(M, d, torch.bfloat16)
    rmsnorm_case(3, d_model, torch.float32)
    swiglu_case(3, d_ff, torch.float32)
    ring = [S - 1, S, 5, 700]              # ring slots S - 1 and S (-> 0)
    for fmt, path in (("bf16", "main"), ("q8_0", "second q8_0"),
                      ("q4_0", "second q4_0")):
        rope_case(fmt, B, Hq, Hkv, S, D, ring, None, timed=True, path=path)
        rope_case(fmt, B, Hq, Hkv, S, D, ring, [True, False, True, False])
        rope_case(fmt, 1, Hq, Hkv, S, D, [0], [True])
        rope_case(fmt, 3, 4, 2, 16, 32, [16, 7, 15], [True, False, True])
        rope_case(fmt, 2, 32, 32, 64, 128, [100, 63], None)

    def paged_rope_case(fmt, b, P, max_pages, lens, advance, hq=Hq,
                        hkv=Hkv, d=D, timed=False, path=None):
        """The decode RoPE + cache write through a shuffled block table
        against the dense kernel on a cache holding the table's view: q
        bit-equal, and at every written (slot, position) the pool row
        bit-equal to the dense row; frozen rows, the garbage block and
        the unmapped blocks untouched."""
        theta = cfg_full.rope_theta
        S_c = P * max_pages
        n_blocks = b * max_pages + 3
        qkv = randn(b, (hq + 2 * hkv) * d, g=gen_paged).bfloat16()
        old = randn(n_blocks, hkv, P, d, g=gen_paged).bfloat16()
        if fmt == "bf16":
            pool = {"k": old, "v": (old * 0.5).contiguous()}
        else:
            kq, ks = quantize_rows(old, fmt)
            vq, vs = quantize_rows(old * 0.5, fmt)
            pool = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        table = shuffled_table(b, max_pages, n_blocks)
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        adv = (None if advance is None
               else torch.tensor(advance, dtype=torch.bool, device=dev))
        pk = {n: x.clone() for n, x in pool.items()}
        dk = {n: paged_gather(x, table).contiguous() for n, x in pool.items()}
        qp = rope_cache_write(qkv, pk, lens_t, adv, theta, fmt, table)
        qd = rope_cache_write(qkv, dk, lens_t, adv, theta, fmt)
        qpl = rope_cache_write_plain(qkv, {n: x.clone() for n, x in
                                           pool.items()}, lens_t, adv,
                                     theta, fmt, table)
        torch.cuda.synchronize()
        shape = (f"B{b} Hq{hq} Hkv{hkv} D{d} P{P} x {max_pages} pages "
                 f"lens{lens} advance{advance}")
        label = f"rope_cache_write[{fmt}] paged {shape}"
        check(torch.equal(qp, qd), f"{label}: q differs from the dense "
              "kernel's")
        written = torch.zeros((n_blocks, P), dtype=torch.bool, device=dev)
        tb = table.tolist()
        for i, pos in enumerate(lens):
            if advance is not None and not advance[i]:
                continue
            slot = pos % S_c
            blk, row = tb[i][slot // P], slot % P
            written[blk, row] = True
            for n in pk:
                check(torch.equal(pk[n][blk, :, row], dk[n][i, :, slot]),
                      f"{label}: {n} row of slot {i} differs from the "
                      "dense kernel's")
        keep = ~written[:, None, :].expand(n_blocks, hkv, P)
        for n in pk:
            check(torch.equal(pk[n][keep], pool[n][keep]),
                  f"{label}: {n} changed outside the written rows")
        err = float((qp.float() - qpl.float()).abs().max())
        tol = bf16_tol(qpl)
        check(err <= tol, f"{label}: q {err} > {tol} against the plain "
              "version")
        print(f"  {label}: q and written rows bit-equal to the dense "
              f"kernel's; frozen rows, block 0 and unmapped blocks untouched;"
              f" q max_abs_err vs plain {err:.3e} (tol {tol:.3e})",
              flush=True)
        if not timed:
            return
        n_adv = b if advance is None else sum(advance)
        row_bytes = sum(t[0, 0, 0].numel() * t.element_size()
                        for t in pk.values())
        nbytes = (qkv.numel() * 2 + b * 4 + (0 if adv is None else b)
                  + b * 4 + qp.numel() * 2 + n_adv * hkv * row_bytes)
        copies = [(qkv, pk, lens_t, adv, table)] + [
            (qkv.clone(), pk, lens_t, adv, table)
            for _ in range(n_copies(qkv.numel() * 2) - 1)]
        fused_row(f"rope_cache_write[{fmt} paged P{P}]",
                  lambda a, c, ln, av, tb_: rope_cache_write(
                      a, c, ln, av, theta, fmt, tb_),
                  lambda a, c, ln, av, tb_: rope_cache_write_plain(
                      a, c, ln, av, theta, fmt, tb_), copies, nbytes,
                  "src/repro/models/layers.py:51", shape, path, err, tol)

    for fmt, path in (("bf16", "paged"), ("q8_0", "second q8_0 paged"),
                      ("q4_0", "second q4_0 paged")):
        paged_rope_case(fmt, B, 16, 64, ring, None, timed=True, path=path)
        paged_rope_case(fmt, B, 16, 64, ring, [True, False, True, False])
        for P in (8, 64, 128):
            paged_rope_case(fmt, 3, P, S // P, [P - 1, P, 3 * P + 1],
                            [True, True, False])
        paged_rope_case(fmt, 3, 8, 8, [16, 7, 63], [True, False, True],
                        hq=4, hkv=2, d=32)
        paged_rope_case(fmt, 2, 32, 2, [100, 63], None, hq=32, hkv=32,
                        d=128)
    for M, path in ((B, "main"), (2048, "prefill")):
        add_rmsnorm_case(M, d_model, torch.bfloat16, timed=True, path=path)
        add_rmsnorm_case(M, d_model, torch.float32)
    for M, d in ((1, d_model), (333, d_model), (3, 128), (5, 100), (7, 1),
                 (2, 9000), (2, 1030)):   # wider than the registers hold
        add_rmsnorm_case(M, d, torch.bfloat16)
    # the prefill path's buckets (4 x 512, 3 x 1024, 1 x 512) in a cache of
    # max_len 1024; the quantized caches at 4 x 512 (the second path's
    # stall legs); then ragged S, S at the cache length, the reduced
    # widths (D 32, G 2), D 128 (G 1) and D 40 (no 16-byte runs)
    for b, s_len in flash_shapes:
        rope_prefill_case("bf16", b, s_len, S, Hq, Hkv, D, timed=True,
                          path="prefill")
    for fmt in ("q8_0", "q4_0"):
        rope_prefill_case(fmt, B, 512, S, Hq, Hkv, D, timed=True,
                          path=f"second {fmt} stall")
    for fmt in ("bf16", "q8_0", "q4_0"):
        rope_prefill_case(fmt, 3, 333, 512, Hq, Hkv, D)
        rope_prefill_case(fmt, 2, 64, 64, Hq, Hkv, D)
        rope_prefill_case(fmt, 3, 50, 64, 4, 2, 32)
        rope_prefill_case(fmt, 2, 70, 80, 16, 16, 128)
        rope_prefill_case(fmt, 2, 9, 16, 4, 2, 40)

    # -- the paper's other models: their kernel instances and shapes --------
    # the (head_dim, G) instance each adds to both attention kernels, with
    # the model whose served runs launch it (llama3.2-8b's also serves
    # mistral-7b): decode at 4 slots of kv_len 1024, prefill at 4 x 512
    new_pairs = {(64, 7): "qwen2-0.5b", (128, 6): "qwen2-1.5b",
                 (128, 3): "llama3.2-3b", (128, 4): "llama3.2-8b"}
    mis = get_config("mistral-7b-v0.1")
    qwen = get_config("qwen2-0.5b")
    print("the paper's other models: their kernel instances and shapes vs "
          "the plain versions:", flush=True)
    with drawing_from(gen_rope):
        # the decode RoPE + cache write at each (head_dim, G) instance in
        # the three formats (a frozen row, ring slots S - 1 and S), and
        # past one CTA's 1024 runs (two CTAs a slot); the main path's
        # decode attention timed at its served kv_len (the served
        # requests' caches hold under 72 positions)
        for (d, g_), arch in new_pairs.items():
            pc = get_config(arch)
            for fmt in ("bf16", "q8_0", "q4_0"):
                rope_case(fmt, 3, pc.num_heads, pc.num_kv_heads, 200, d,
                          [199, 200, 63], [True, True, False])
        for fmt in ("bf16", "q8_0", "q4_0"):
            rope_case(fmt, 2, 64, 64, 64, 128, [5, 64], [True, False])
        attention_case("bf16", B, Hq, Hkv, S, D, [40, 38, 45, 41], 0,
                       timed=True, instance="kv_len 40", path="main")
    with drawing_from(gen_paper):
        for (d, g_), arch in new_pairs.items():
            pc = get_config(arch)
            inst = f"D{d} G{g_}"
            hq, hkv = pc.num_heads, pc.num_kv_heads
            attention_case("bf16", B, hq, hkv, S, d, [S] * B, 0, timed=True,
                           instance=inst, path=f"paper {arch} bf16")
            for fmt in ("bf16", "q8_0", "q4_0"):
                if fmt != "bf16":
                    attention_case(fmt, B, hq, hkv, S, d, [S] * B, 0,
                                   timed=False, instance=inst)
                attention_case(fmt, B, hq, hkv, S, d, [0, 1, 37, S], 0,
                               timed=False, instance=inst)
                attention_case(fmt, B, hq, hkv, S, d, [0, 5, 700, S], 100,
                               timed=False, instance=inst)
            flash_case(B, hq, hkv, 512, 512, d, 0, 0, timed=True,
                       instance=inst, path=f"paper {arch} stall")
            flash_case(2, hq, hkv, 333, 333, d, 0, 0, timed=False)
            flash_case(2, hq, hkv, 512, 512, d, 100, 0, timed=False)
        # mistral-7b's window at the window leg's longest prompt
        flash_case(1, mis.num_heads, mis.num_kv_heads, 4500, 4500,
                   mis.head_dim, mis.sliding_window, 0, timed=True,
                   instance="D128 G4", path="window")
        # no fallback: a (head_dim, G) no config serves raises in both
        for what, call in (
                ("decode_attention", lambda: decode_attention(
                    randn(1, 6, 64).bfloat16(), randn(1, 2, 64, 64).bfloat16(),
                    randn(1, 2, 64, 64).bfloat16(),
                    torch.tensor([5], dtype=torch.int32, device=dev))),
                ("flash_attention", lambda: flash_attention(
                    randn(1, 6, 64, 64).bfloat16(),
                    randn(1, 2, 64, 64).bfloat16(),
                    randn(1, 2, 64, 64).bfloat16()))):
            try:
                call()
            except ValueError as e:
                check("has no kernel for head_dim 64 with 3" in str(e),
                      f"{what} (64, 3): {e}")
            else:
                fail(f"{what} ran (head_dim 64, G 3), which no config "
                     "serves and no kernel instantiates")
        print("  decode_attention and flash_attention at (head_dim 64, G 3):"
              " raise, no kernel instantiated (no fallback)", flush=True)
        # every new linear at decode M (q8_0 timed, q4_0 checked) and the
        # prefill's M 2048; the gate-up GEMM with its SwiGLU (the cluster
        # route at M 2048: F 4864 and 8960 are no multiple of 128); the
        # untied heads at f32 logits
        for arch in ("qwen2-0.5b", "qwen2-1.5b", "llama3.2-3b",
                     "llama3.2-8b"):
            pc = get_config(arch)
            for label, (K, N) in (
                    ("wqkv", (pc.d_model, pc.q_dim + 2 * pc.kv_dim)),
                    ("wo", (pc.q_dim, pc.d_model)),
                    ("w_down", (pc.d_ff, pc.d_model))):
                qmm_case("q8_0", label, B, K, N, torch.bfloat16, timed=True,
                         path=f"paper {arch} q8_0")
                qmm_case("q4_0", label, B, K, N, torch.bfloat16, timed=False)
                qmm_case("q8_0", label, 2048, K, N, torch.bfloat16,
                         timed=True, path=f"paper {arch} stall")
            qmm_swiglu_case("q8_0", B, pc.d_model, pc.d_ff, timed=True,
                            path=f"paper {arch} q8_0")
            qmm_swiglu_case("q4_0", B, pc.d_model, pc.d_ff)
            qmm_swiglu_case("q8_0", 2048, pc.d_model, pc.d_ff, timed=True,
                            path=f"paper {arch} stall")
        for arch in ("llama3.2-8b", "mistral-7b-v0.1"):
            pc = get_config(arch)
            qmm_case("q8_0", "lm_head", B, pc.d_model, pc.padded_vocab,
                     torch.float32, timed=True, path=f"paper {arch} q8_0")
            qmm_case("q4_0", "lm_head", B, pc.d_model, pc.padded_vocab,
                     torch.float32, timed=False)
        # the RoPE + cache writes with qwen2's bias, and the prefill one
        # past the cache (the ring write): mistral-7b's 4500 positions
        # into its 4096-position ring, ragged rings at D 32 and 128
        for fmt in ("bf16", "q8_0", "q4_0"):
            rope_case(fmt, B, qwen.num_heads, qwen.num_kv_heads, S,
                      qwen.head_dim, ring, None, timed=fmt == "bf16",
                      path="paper qwen2-0.5b bf16", with_bias=True)
            rope_case(fmt, 3, 12, 2, 64, 128, [64, 7, 63],
                      [True, False, True], with_bias=True)
            rope_prefill_case(fmt, B, 512, S, qwen.num_heads,
                              qwen.num_kv_heads, qwen.head_dim,
                              timed=fmt == "bf16",
                              path="paper qwen2-0.5b stall", with_bias=True)
            rope_prefill_case(fmt, 1, 4500, 4096, mis.num_heads,
                              mis.num_kv_heads, mis.head_dim,
                              timed=fmt == "bf16", path="window")
            rope_prefill_case(fmt, 2, 40, 16, 4, 2, 32, with_bias=True)
            rope_prefill_case(fmt, 2, 70, 64, 12, 2, 128, with_bias=True)

    # -- the assigned dense models and V0: instances, shapes, out= ---------
    # deepseek-67b's and qwen1.5-110b's (head_dim 128, G 8) in both
    # attention kernels (kimi-k2's attention is (128, 8) too): the decode
    # RoPE + cache write there, decode attention at 4 slots of kv_len 1024
    # in every loader (timed; bf16 reports the full model's run, the
    # quantized loaders its 4-layer quantized-cache legs), ragged and
    # windowed lengths, the prefill attention at 4 x 512 (timed: the stall
    # leg's instance) and ragged; quant_matmul and the gate-up GEMM at
    # every new linear shape at M 4 and 2048 and the untied heads; the V0
    # projections of the main path; quant_matmul(out=) into a wider row
    gen_dense = torch.Generator(device=dev)      # the assigned models' cases
    gen_dense.manual_seed(29)
    t_dense_cases = time.perf_counter()
    ds67 = get_config("deepseek-67b")
    print("the assigned dense models: the (128, 8) instances, their linear "
          "shapes, the V0 projections and quant_matmul(out=) vs the plain "
          "versions:", flush=True)
    with drawing_from(gen_dense):
        hq, hkv, d = ds67.num_heads, ds67.num_kv_heads, ds67.head_dim
        inst = "D128 G8"
        for fmt in ("bf16", "q8_0", "q4_0"):
            rope_case(fmt, 3, hq, hkv, 200, d, [199, 200, 63],
                      [True, True, False])
            attention_case(fmt, B, hq, hkv, S, d, [S] * B, 0, timed=True,
                           instance=inst,
                           path="dense deepseek-67b q4_0" if fmt == "bf16"
                           else f"dense deepseek-67b 4 layers {fmt} cache")
            attention_case(fmt, B, hq, hkv, S, d, [0, 1, 37, S], 0,
                           timed=False, instance=inst)
            attention_case(fmt, B, hq, hkv, S, d, [0, 5, 700, S], 100,
                           timed=False, instance=inst)
        flash_case(B, hq, hkv, 512, 512, d, 0, 0, timed=True, instance=inst,
                   path="dense deepseek-67b stall")
        flash_case(2, hq, hkv, 333, 333, d, 0, 0, timed=False)
        flash_case(2, hq, hkv, 512, 512, d, 100, 0, timed=False)
        # each new linear once per format (deepseek-67b and qwen1.5-110b
        # share wqkv and wo), M 4 on the model's 4-slot run, M 2048 on its
        # stall leg's format (launches: its 1 x 512 prefill)
        timed_shapes = set()
        for arch, fmts in DENSE_CELLS:
            pc = get_config(arch)
            stall_fmt = DENSE_STALL[arch]
            for label, (K, N) in (
                    ("wqkv", (pc.d_model, pc.q_dim + 2 * pc.kv_dim)),
                    ("wo", (pc.q_dim, pc.d_model)),
                    ("w_down", (pc.d_ff, pc.d_model))):
                for fmt in ("q8_0", "q4_0"):
                    served = fmt in fmts
                    fresh = (fmt, K, N) not in timed_shapes
                    qmm_case(fmt, label, B, K, N, torch.bfloat16,
                             timed=served and fresh,
                             path=f"dense {arch} {fmt}")
                    timed_shapes.add((fmt, K, N))
                qmm_case(stall_fmt, label, 2048, K, N, torch.bfloat16,
                         timed=True, path=f"dense {arch} stall")
            for fmt in ("q8_0", "q4_0"):
                qmm_swiglu_case(fmt, B, pc.d_model, pc.d_ff,
                                timed=fmt in fmts, path=f"dense {arch} {fmt}")
                qmm_case(fmt, "lm_head", B, pc.d_model, pc.padded_vocab,
                         torch.float32, timed=fmt in fmts,
                         path=f"dense {arch} {fmt}")
            qmm_swiglu_case(stall_fmt, 2048, pc.d_model, pc.d_ff, timed=True,
                            path=f"dense {arch} stall")
        # the V0 projections of the main path (llama3.2-1b q8_0): wq, wk (wv
        # alike) and w_gate (w_up alike), at decode M and the stall leg's
        # 4 x 512
        for label, (K, N) in (("wq", (cfg_full.d_model, cfg_full.q_dim)),
                              ("wk", (cfg_full.d_model, cfg_full.kv_dim)),
                              ("w_gate", (cfg_full.d_model, cfg_full.d_ff))):
            qmm_case("q8_0", label, B, K, N, torch.bfloat16, timed=True,
                     path="v0 main")
            qmm_case("q8_0", label, 2048, K, N, torch.bfloat16, timed=True,
                     path="v0 stall")
        # quant_matmul(out=) a column range of a wider row: bit-equal to
        # the call without it, the other columns untouched (both routes,
        # both formats, f32 out, an N whose rows are copied element by
        # element), and an unaligned view refused
        out_cases = []
        for fmt, M, K, N, dt, at, ldc in (
                ("q8_0", B, 2048, 512, torch.bfloat16, 2048, 3072),
                ("q4_0", B, 2048, 2048, torch.bfloat16, 0, 3072),
                ("q8_0", 1, 5120, 1024, torch.bfloat16, 4096, 6144),
                ("q8_0", 9, 2048, 8192, torch.bfloat16, 8192, 16384),
                ("q8_0", 2048, 2048, 512, torch.bfloat16, 2560, 3072),
                ("q4_0", 333, 2048, 8192, torch.bfloat16, 8192, 16384),
                ("q8_0", B, 96, 50, torch.float32, 4, 60),
                ("q4_0", 300, 96, 50, torch.float32, 8, 64)):
            x = randn(M, K).bfloat16()
            w = quantize(randn(K, N, scale=K ** -0.5), fmt)
            want = quant_matmul(x, w, out_dtype=dt)
            buf = torch.full((M, ldc), 7.0, dtype=dt, device=dev)
            view = buf[:, at:at + N]
            got = quant_matmul(x, w, out_dtype=dt, out=view)
            rest = torch.cat([buf[:, :at], buf[:, at + N:]], dim=1)
            torch.cuda.synchronize()
            check(got.data_ptr() == view.data_ptr()
                  and torch.equal(view, want) and bool((rest == 7).all()),
                  f"quant_matmul(out=) {fmt} M{M} K{K} N{N} at column {at} "
                  f"of {ldc}: {int((view != want).sum())} elements differ "
                  f"from the call without out=, {int((rest != 7).sum())} "
                  "neighbouring elements written")
            out_cases.append(f"{fmt} M{M} K{K} N{N} {str(dt)[6:]} at {at} "
                             f"of {ldc}")
        x = randn(B, 2048).bfloat16()
        w = quantize(randn(2048, 512, scale=2048 ** -0.5), "q8_0")
        buf = torch.empty((B, 3072), dtype=torch.bfloat16, device=dev)
        try:
            quant_matmul(x, w, out=buf[:, 3:515])
        except ValueError as e:
            check("16-byte-aligned" in str(e), f"quant_matmul(out=): {e}")
        else:
            fail("quant_matmul wrote into a view whose start is not 16-byte "
                 "aligned")
        print("  quant_matmul(out=) bit-equal to the call without out=, "
              "neighbouring columns untouched: " + "; ".join(out_cases)
              + "; a view at column 3 (not 16-byte aligned) refused",
              flush=True)
        # the bf16-weight V0 projections: torch.mm(out=) hands cuBLAS the
        # view's row pitch, and its trace holds no copy kernel
        wb = randn(2048, 512, scale=2048 ** -0.5).bfloat16()
        for M in (B, 2048):
            xb = randn(M, 2048).bfloat16()
            buf = torch.full((M, 3072), 7.0, dtype=torch.bfloat16, device=dev)
            view = buf[:, 2048:2560]
            want = torch.mm(xb, wb)
            torch.mm(xb, wb, out=view)
            rest = torch.cat([buf[:, :2048], buf[:, 2560:]], dim=1)
            torch.cuda.synchronize()
            err = float((view.float() - want.float()).abs().max())
            check(err <= bf16_tol(want) and bool((rest == 7).all()),
                  f"torch.mm(out=) M{M}: {err} from the contiguous product, "
                  f"{int((rest != 7).sum())} neighbouring elements written")
            names = [e.name for e in cuda_events(
                lambda: torch.mm(xb, wb, out=view), [()], 4)]
            copies = [n for n in names if "copy" in n.lower()]
            check(names and not copies, f"torch.mm(out=) M{M}: trace "
                  f"{sorted(set(n[:60] for n in names))}: copy kernels "
                  f"{copies[:2]}")
            print(f"  torch.mm(out=) M{M} into columns 2048-2559 of 3072: "
                  f"bit-equal to the contiguous product "
                  f"{torch.equal(view, want)} (error {err:.3e}); trace of 4 "
                  f"calls: {len(names)} CUDA events, no copy kernel "
                  f"({sorted(set(n[:50] for n in names))})", flush=True)
    dense_cases_s = time.perf_counter() - t_dense_cases
    print(f"  the assigned dense models' kernel cases: {dense_cases_s:.1f} s",
          flush=True)

    # -- the mixture-of-experts kernels --------------------------------------
    moe_src = "src/repro_torch/kernels/csrc/moe.cu"
    gen_moe = torch.Generator(device=dev)        # the MoE kernel cases
    gen_moe.manual_seed(7)

    def moe_weight(*shape, scale):
        """bf16 random weights drawn in bf16 (kimi-k2's 33.8 GB of experts
        leave no room for f32 temporaries)."""
        w = torch.randn(shape, generator=gen_moe, device=dev,
                        dtype=torch.bfloat16)
        return w.mul_(scale)

    def moe_row(name, kern, plain, args, nbytes, flops, replaces, shape,
                path, err, tol, lib=None, lib_args=None, shape_of=None,
                per_call=1, lib_name="torch.bmm over all experts padded to C"):
        """Time an MoE kernel (``per_call`` launches a call: the route's
        from ``route_launches``), its plain version and,
        for the grouped GEMMs, ``torch.bmm`` over all experts padded to C
        (the JAX einsum's work; ``lib_name`` names another yardstick), and
        keep its row. The weights read by a call exceed the 50 MB L2, so
        one copy of the inputs serves."""
        ms, call_ms = time_calls(kern, [args], 50, per_call=per_call)
        attempts = time_calls.attempts
        plain_ms, _ = time_calls(plain, [args], 5)
        lib_ms = time_calls(lib, [lib_args], 20)[0] if lib else None
        t_bound, by = bound(nbytes, flops)
        rows[name] = dict(
            name=name, route="cuda", source=moe_src, replaces=replaces,
            no_pallas_counterpart=True, shape=shape, path=path, launches=0,
            max_abs_err=err, tol=tol, ms=ms, call_ms=call_ms,
            plain_ms=plain_ms, bound_ms=t_bound, bound_by=by,
            library_ms=lib_ms, library=lib_name if lib else None,
            grid=None, trace_attempts=attempts)
        if shape_of:
            rows[name]["shape_of"] = shape_of
        print(f"    device ms {ms:.4f} (per call back to back {call_ms:.4f};"
              f" {attempts} trace(s))  plain {plain_ms:.4f}  library "
              + (f"{lib_ms:.4f}" if lib else "-")
              + f"  bound {t_bound:.4f} ({by}, {nbytes / 1e6:.3f} MB, "
              f"{flops / 1e9:.3f} GFLOP) -> {t_bound / ms:.1%} of bound",
              flush=True)

    def moe_route_case(label, x, wr, K, C, timed=False, path=None,
                       shape_of=None):
        """The route kernel: its logits within 1e-5 of the largest of
        ``router_logits_plain``'s and each token's bit-equal alone (T 1);
        its routing against the plain routing of its own logits: experts,
        slots, counts and the kept map entries exactly, gates within 1e-6
        relative; the read counters move by the experts with a pair and
        one pass. Returns (route, dropped pairs)."""
        T, E = x.shape[0], wr.shape[1]
        reads = torch.zeros((2,), dtype=torch.int64, device=dev)
        out = moe_route(x, wr, K, C, reads)
        g, e, s_, cnt, src, logits = out
        gp, ep, sp, cp, srcp, _ = route_from_logits_plain(logits, K, C)
        ref_logits = router_logits_plain(x, wr)
        alone = moe_route(x[:1].contiguous(), wr, K, C)[5]
        # the library product's row alone, for the record: where it
        # differs, a plain router would make a stream depend on its batch
        lib_rows[f"{label} T{T}"] = torch.equal(
            router_logits_plain(x[:1], wr)[0], ref_logits[0])
        torch.cuda.synchronize()
        lg_err = float((logits - ref_logits).abs().max())
        lg_tol = 1e-5 * float(ref_logits.abs().max())
        kept = torch.arange(C, device=dev)[None] < cp[:, None]
        exact = (torch.equal(e, ep) and torch.equal(s_, sp)
                 and torch.equal(cnt, cp) and torch.equal(src[kept],
                                                          srcp[kept]))
        rel = float(((g - gp).abs() / gp.abs().clamp(min=1e-30)).max())
        used = int((torch.bincount(ep.view(-1).long(), minlength=E)
                    > 0).sum())
        dropped = int((sp >= C).sum())
        same = {True: "bit-equal", False: "DIFFERS"}
        print(f"  moe_route[{label} T{T} E{E} K{K} C{C}]: logits max_abs_err"
              f" {lg_err:.3e} (tol {lg_tol:.3e}), token 0 alone "
              f"{same[torch.equal(alone[0], logits[0])]} (torch.matmul's "
              f"alone: {same[lib_rows[f'{label} T{T}']].lower()});"
              f" experts, slots, counts and map "
              f"{'exact' if exact else 'DIFFER'}; gates max rel err "
              f"{rel:.2e} (tol 1e-6); {used} experts used, {dropped} of "
              f"{T * K} pairs dropped; reads {reads.tolist()}", flush=True)
        check(lg_err <= lg_tol, f"moe_route {label} T{T}: logits {lg_err} "
              f"> {lg_tol}")
        check(torch.equal(alone[0], logits[0]), f"moe_route {label} T{T}: "
              "token 0's logits alone differ from the same token's in the "
              "call")
        check(exact, f"moe_route {label} T{T}: routing differs from plain")
        check(rel <= 1e-6, f"moe_route {label} T{T}: gates {rel} > 1e-6")
        check(reads.tolist() == [used, 1],
              f"moe_route {label} T{T}: reads {reads.tolist()} != "
              f"[{used}, 1]")
        if timed:
            D = x.shape[1]
            nbytes = (T * D * 2 + D * E * 2 + T * E * 4 + T * K * 12 + E * 4
                      + int(kept.sum()) * 4)
            moe_row(f"moe_route[{label} T{T}]",
                    lambda a, b: moe_route(a, b, K, C),
                    lambda a, b: moe_route_plain(a, b, K, C), (x, wr),
                    nbytes, 2.0 * T * D * E, "src/repro/models/moe.py:73-97",
                    f"T{T} D{D} E{E} K{K} C{C}", path, lg_err, lg_tol,
                    shape_of=shape_of,
                    per_call=moe_kernels.route_launches(T, D, E, K))
        return out, dropped

    def moe_rows_check(what, got, ref, counts, C, canary):
        """Rows c < counts[g] within one bf16 ulp of the plain version's;
        every other row still holds the canary."""
        live = torch.arange(C, device=dev)[None] < counts[:, None]
        err = float((got[live].float() - ref[live].float()).abs().max())
        tol = bf16_tol(ref[live])
        untouched = bool((got[~live] == canary).all())
        print(f"  {what}: max_abs_err {err:.3e} (tol {tol:.3e}), "
              f"{int((got[live] != ref[live]).sum())} of "
              f"{got[live].numel()} elements differ; rows past the counts "
              f"{'untouched' if untouched else 'WRITTEN'}", flush=True)
        check(err <= tol, f"{what}: {err} > {tol}")
        check(untouched, f"{what}: a row past its count was written")
        return err, tol

    def moe_layer_case(label, T, K, x, wr, wgu, wd, timed=False,
                       path=None, shared=None, shape_of=None,
                       plain_route=False):
        """One MoE layer's kernels at T tokens against their plain
        versions: the route; the gate-up GEMM with its SwiGLU and the down
        GEMM over the routed rows, into canary-filled outputs; each
        expert's first row computed alone at capacity 8 (one row, another
        row tile, no neighbours) bit-equal to the same row in the call;
        the combine bit-equal (with the shared experts' output where
        ``shared`` = (w_gate_up, w_down), themselves held as one group of
        T rows). ``plain_route``: the plain routing of the plain logits
        (the route kernel takes E a multiple of 8 only). Timed where
        ``timed``. Returns the dropped pairs."""
        E, D, F2 = wgu.shape
        Fw = F2 // 2
        C = moe_kernels.capacity(E, K, 1.25, T)
        if plain_route:
            gates, experts, slots, counts, src, _ = route_from_logits_plain(
                router_logits_plain(x, wr), K, C)
            dropped = int((slots >= C).sum())
        else:
            (gates, experts, slots, counts, src, _), dropped = \
                moe_route_case(label, x, wr, K, C, timed, path, shape_of)
        canary = 7.0
        h = moe_gate_up_swiglu(x, wgu, C, counts, src, out=torch.full(
            (E, C, Fw), canary, dtype=torch.bfloat16, device=dev))
        hp = moe_gate_up_swiglu_plain(x, wgu, C, counts, src)
        torch.cuda.synchronize()
        err_h, tol_h = moe_rows_check(
            f"moe_gate_up_swiglu[{label} T{T}]", h, hp, counts, C, canary)
        y = moe_down(h, wd, counts, out=torch.full(
            (E, C, D), canary, dtype=torch.bfloat16, device=dev))
        yp = moe_down_plain(h, wd, counts)
        torch.cuda.synchronize()
        err_y, tol_y = moe_rows_check(f"moe_down[{label} T{T}]", y, yp,
                                      counts, C, canary)
        one = torch.clamp(counts, max=1).contiguous()
        h1 = moe_gate_up_swiglu(x, wgu, 8, one, src[:, :8].contiguous())
        y1 = moe_down(h[:, :8].contiguous(), wd, one)
        torch.cuda.synchronize()
        act = counts > 0
        check(torch.equal(h1[act, 0], h[act, 0])
              and torch.equal(y1[act, 0], y[act, 0]),
              f"moe GEMMs {label} T{T}: a row alone (count 1, C 8) differs "
              "from the same row in the call")
        sh = None
        if shared is not None:
            sgu, sd = shared[0][None], shared[1][None]
            canary_s = torch.full((1, T, sgu.shape[2] // 2), canary,
                                  dtype=torch.bfloat16, device=dev)
            hs = moe_gate_up_swiglu(x, sgu, T, out=canary_s)
            hsp = moe_gate_up_swiglu_plain(x, sgu, T)
            sh = moe_down(hs, sd)[0]
            shp = moe_down_plain(hs, sd)[0]
            torch.cuda.synchronize()
            full_rows = torch.full((1,), T, dtype=torch.int32, device=dev)
            moe_rows_check(f"shared gate-up [{label} T{T}]", hs, hsp,
                           full_rows, T, canary)
            moe_rows_check(f"shared down [{label} T{T}]", sh[None], shp[None],
                           full_rows, T, canary)
        out = moe_combine(y, gates, experts, slots, sh)
        outp = moe_combine_plain(y, gates, experts, slots, sh)
        torch.cuda.synchronize()
        check(torch.equal(out, outp), f"moe_combine {label} T{T}: not "
              "bit-equal to the plain version")
        # at a capacity within the 16-row tile the down GEMM and the
        # combine are one pair of launches: bit-equal to the two kernels
        # apart, within one bf16 ulp of the plain pair
        fused = moe_kernels.moe_down_combined(C)
        if fused:
            dc_args = (h, wd, gates, experts, slots, counts, sh)
            outf = moe_down_combine(*dc_args)
            outfp = moe_down_combine_plain(*dc_args)
            torch.cuda.synchronize()
            check(torch.equal(outf, out), f"moe_down_combine {label} T{T}:"
                  " not bit-equal to moe_combine(moe_down(...))")
            err_f = float((outf.float() - outfp.float()).abs().max())
            tol_f = bf16_tol(outfp)
            check(err_f <= tol_f, f"moe_down_combine {label} T{T}: "
                  f"{err_f} > {tol_f} against the plain pair")
        print(f"  moe GEMMs [{label} T{T}]: each expert's first row alone "
              f"bit-equal; moe_combine bit-equal"
              + (" (with the shared experts)" if shared else "")
              + ("; moe_down_combine bit-equal to moe_down + moe_combine, "
                 f"max_abs_err vs the plain pair {err_f:.3e} (tol "
                 f"{tol_f:.3e})" if fused else ""), flush=True)
        if not timed:
            return dropped
        used = int(act.sum())
        kept = int(counts.sum())
        rows_in = kept * D * 2
        shape = f"T{T} E{E} K{K} D{D} F{Fw} C{C}"
        # torch.bmm over all experts padded to C: the JAX einsum's work
        buf = torch.zeros((E, C, D), dtype=torch.bfloat16, device=dev)
        hbuf = torch.zeros((E, C, Fw), dtype=torch.bfloat16, device=dev)
        moe_row(f"moe_gate_up_swiglu[{label} T{T}]",
                lambda *a: moe_gate_up_swiglu(*a),
                lambda *a: moe_gate_up_swiglu_plain(*a),
                (x, wgu, C, counts, src),
                used * D * F2 * 2 + rows_in + kept * Fw * 2 + kept * 4,
                2.0 * kept * D * F2, "src/repro/models/moe.py:107-112",
                shape, path, err_h, tol_h, torch.bmm, (buf, wgu), shape_of,
                per_call=moe_kernels.gemm_launches(wgu, C, mapped=True))
        shared_bytes = T * D * 2 if sh is not None else 0
        if fused:
            # the weights of the experts with rows, their h rows, the
            # pairs, out (and the shared output) once
            name = f"moe_down_combine[{label} T{T}]"
            moe_row(name, lambda *a: moe_down_combine(*a),
                    lambda *a: moe_down_combine_plain(*a), dc_args,
                    used * Fw * D * 2 + kept * Fw * 2 + T * K * 12
                    + T * D * 2 + shared_bytes, 2.0 * kept * Fw * D,
                    "src/repro/models/moe.py:113-125", shape, path, err_f,
                    tol_f, shape_of=shape_of,
                    per_call=moe_kernels.DOWN_COMBINE_LAUNCHES)
            pair = lambda hh, ww, g_, e_, s_, c_, sh_: moe_combine(
                moe_down(hh, ww, c_), g_, e_, s_, sh_)
            rows[name]["pair_ms"] = time_calls(
                pair, [dc_args], 50,
                per_call=moe_kernels.gemm_launches(wd, C) + 1)[0]
            print(f"    moe_down + moe_combine apart {rows[name]['pair_ms']:.4f}",
                  flush=True)
            del buf, hbuf
            return dropped
        moe_row(f"moe_down[{label} T{T}]", lambda *a: moe_down(*a),
                lambda *a: moe_down_plain(*a), (h, wd, counts),
                used * Fw * D * 2 + kept * Fw * 2 + kept * D * 2,
                2.0 * kept * Fw * D, "src/repro/models/moe.py:113-116",
                shape, path, err_y, tol_y, torch.bmm, (hbuf, wd), shape_of,
                per_call=moe_kernels.gemm_launches(wd, C))
        nbytes = kept * D * 2 + T * K * 12 + T * D * 2 + shared_bytes
        keep = (slots < C)[..., None]
        slot_c = torch.clamp(slots, max=C - 1).long()
        gather_einsum = lambda yy, g_, e_, s_, sh_: torch.einsum(
            "tkd,tk->td", torch.where(keep, yy[e_.long(), slot_c], 0).float(),
            g_)
        moe_row(f"moe_combine[{label} T{T}]", lambda *a: moe_combine(*a),
                lambda *a: moe_combine_plain(*a),
                (y, gates, experts, slots, sh), nbytes, 2.0 * T * K * D,
                "src/repro/models/moe.py:119-125", shape, path, 0.0, 0.0,
                gather_einsum, (y, gates, experts, slots, sh), shape_of,
                lib_name="pair: the indexed gather y[experts, slots] (with "
                         "the drop mask) + torch.einsum('tkd,tk->td')")
        del buf, hbuf
        return dropped

    def moe_kernel_cases():
        """The four MoE kernels against their plain versions at
        phi3.5-moe's shapes (E 16, K 2, D 4096, F 6400) at T 4, 1 and 2048
        (the served path's decode at 4 slots and 1, and its stall
        prefill), with a skewed router that forces drops and with tied
        logits, then at kimi-k2's expert layer (E 384, K 8, D 7168, F 2048,
        one shared expert) at T 4 and 512: 33.8 GB of expert weights,
        allocated here and freed at the end."""
        phi = get_config("phi3.5-moe-42b-a6.6b")
        E, K, D, Fw = (phi.num_experts, phi.experts_per_token, phi.d_model,
                       phi.d_ff)
        wr = moe_weight(D, E, scale=D ** -0.5)
        wgu = moe_weight(E, D, 2 * Fw, scale=D ** -0.5)
        wd = moe_weight(E, Fw, D, scale=Fw ** -0.5)
        for T, path, timed in ((4, "moe", True), (1, "moe alone", True),
                               (2048, "moe stall", True), (16, None, False),
                               (333, None, False)):
            with drawing_from(gen_moe):
                x = randn(T, D).bfloat16()
            moe_layer_case("phi", T, K, x, wr, wgu, wd, timed, path)
        # a skewed router: x shares a direction that expert 0's column
        # follows, so nearly every token picks it, past C; tied logits:
        # experts 5, 9 and 11 with one column (a three-way tie across the
        # top-2 edge, which the lower ids win), every other column 0
        with drawing_from(gen_moe):
            x = (randn(2048, D) + 1.0).bfloat16()
        skew = wr.clone()
        skew[:, 0] = 4.0 / D
        dropped = moe_layer_case("phi skewed", 2048, K, x, skew, wgu, wd)
        check(dropped > 0, "the skewed router dropped no pair")
        tied = torch.zeros_like(wr)
        tied[:, [5, 9, 11]] = 1.0 / D
        dropped = moe_layer_case("phi tied", 64, K, x[:64].contiguous(),
                                 tied, wgu, wd)
        check(dropped > 0, "the tied router dropped no pair")
        # the route alone at T 2048: every token the same row, so each k
        # sends all its pairs to one expert (T pairs against C), and the
        # tied router over all 2048 tokens (its slot segments each a run
        # of one expert)
        C = moe_kernels.capacity(E, K, 1.25, 2048)
        same = x[:1].expand(2048, D).contiguous()
        (_, e_same, _, cnt, _, _), dropped = moe_route_case(
            "phi all-to-one", same, wr, K, C)
        check(bool((e_same == e_same[:1]).all()) and dropped == K * (2048 - C)
              and int(cnt.sum()) == K * C, f"moe_route all-to-one: {dropped}"
              f" pairs dropped, counts {cnt.tolist()}")
        _, dropped = moe_route_case("phi tied", x, tied, K, C)
        check(dropped > 0, "the tied router at T 2048 dropped no pair")
        del same
        del wr, wgu, wd, skew, tied
        torch.cuda.empty_cache()
        # ragged widths: E 4, K 2, D 520, F 200, each a multiple of 8 and
        # of no tile, so the masked TMA edges (K and the columns) and the
        # split plan's short last chunk (gate-up: 9 chunks, the last of 8
        # k) run against the plain versions; T 16 on the 16-row tile's
        # split route, T 333 (C 216) on the 128-row tile's walk route
        Er, Kr, Dr, Fr = 4, 2, 520, 200
        wr = moe_weight(Dr, Er, scale=Dr ** -0.5)
        wgu = moe_weight(Er, Dr, 2 * Fr, scale=Dr ** -0.5)
        wd = moe_weight(Er, Fr, Dr, scale=Fr ** -0.5)
        for T in (16, 333):
            with drawing_from(gen_moe):
                x = randn(T, Dr).bfloat16()
            moe_layer_case("ragged", T, Kr, x, wr, wgu, wd, plain_route=True)
        del wr, wgu, wd
        kimi = get_config("kimi-k2-1t-a32b")
        E, K, D, Fw = (kimi.num_experts, kimi.experts_per_token,
                       kimi.d_model, kimi.d_ff)
        wr = moe_weight(D, E, scale=D ** -0.5)
        wgu = moe_weight(E, D, 2 * Fw, scale=D ** -0.5)
        wd = moe_weight(E, Fw, D, scale=Fw ** -0.5)
        shared = (moe_weight(D, 2 * Fw, scale=D ** -0.5),
                  moe_weight(Fw, D, scale=Fw ** -0.5))
        print(f"  kimi-k2 expert layer: {(wgu.numel() + wd.numel()) * 2 / 1e9:.1f}"
              " GB of expert weights", flush=True)
        for T in (4, 512):
            with drawing_from(gen_moe):
                x = randn(T, D).bfloat16()
            moe_layer_case("kimi-k2", T, K, x, wr, wgu, wd, timed=True,
                           path="moe", shared=shared,
                           shape_of="kimi-k2-1t-a32b's expert layer (the "
                           "kernel phase only: kimi-k2 is not served on "
                           "the card); launches are the kernel's on the "
                           "phi3.5-moe path")
        del wgu, wd, shared
        torch.cuda.empty_cache()
        kimi_route_paths(wr, K)
        del wr

    def kimi_route_paths(wr, K):
        """The route at kimi-k2's decode T 4 and T 16 (E 384), each timed
        by its plan (``route_launches``: at T 4 one launch of three
        clusters and their ticket, at T 16 three). At T 4 the three-launch
        route (the prefill's: ``route_launches`` patched to 3) exact
        against the one-launch route and timed beside it on the same
        inputs. Then two streams routing at once, each launch exact
        against the route on the default stream (the ticket is a
        stream's own)."""
        D, E = wr.shape
        plan = moe_kernels.route_launches

        def three_launches(a, b):
            moe_kernels.route_launches = lambda T, D, E, K: 3
            try:
                return moe_route(a, b, K, C)
            finally:
                moe_kernels.route_launches = plan

        def same_route(o, ref, kept):
            return (all(torch.equal(a, b) for i, (a, b) in
                        enumerate(zip(o, ref)) if i != 4)
                    and torch.equal(o[4][kept], ref[4][kept]))

        paths = {}
        for T in (4, 16):
            with drawing_from(gen_moe):
                x = randn(T, D).bfloat16()
            C = moe_kernels.capacity(E, K, 1.25, T)
            n = plan(T, D, E, K)
            ref = moe_route(x, wr, K, C)
            kept = torch.arange(C, device=dev)[None] < ref[3][:, None]
            ms = time_calls(lambda a, b: moe_route(a, b, K, C), [(x, wr)],
                            50, per_call=n)[0]
            paths[f"T{T}"] = dict(launches=n, ms=ms)
            if n == 1:
                check(same_route(three_launches(x, wr), ref, kept),
                      f"moe_route kimi-k2 T{T}: the three-launch route "
                      "differs from the one-launch route")
                ms3 = time_calls(three_launches, [(x, wr)], 50,
                                 per_call=3)[0]
                paths[f"T{T}"]["three_launch_ms"] = ms3
            print(f"  moe_route[kimi-k2 T{T}]: {n} launch(es) {ms:.5f} "
                  "device ms" + (f", three launches {ms3:.5f} (bit-equal)"
                                 if n == 1 else ""), flush=True)
            streams = (torch.cuda.Stream(), torch.cuda.Stream())
            for s in streams:
                s.wait_stream(torch.cuda.current_stream())
            outs = []
            for _ in range(16):
                for s in streams:
                    with torch.cuda.stream(s):
                        outs.append(moe_route(x, wr, K, C))
            torch.cuda.synchronize()
            bad = sum(not same_route(o, ref, kept) for o in outs)
            print(f"  moe_route[kimi-k2 T{T}] on two streams at once: {bad} "
                  f"of {len(outs)} launches differ", flush=True)
            check(bad == 0, f"moe_route kimi-k2 T{T}: {bad} of {len(outs)} "
                  "launches on two streams differ from the route alone")
            del outs
        rows["moe_route[kimi-k2 T4]"]["decode_paths_ms"] = paths

    lib_rows = {}      # torch.matmul's f32 router row 0 alone == in the call
    print("MoE kernels vs plain versions on the card:", flush=True)
    t0 = time.perf_counter()
    moe_kernel_cases()
    moe_kernel_s = time.perf_counter() - t0

    # -- the SSM kernels -----------------------------------------------------
    ssm_src = "src/repro_torch/kernels/csrc/ssm.cu"
    gen_ssm = torch.Generator(device=dev)        # the SSM kernel cases
    gen_ssm.manual_seed(8)
    mamba = get_config("mamba2-2.7b")
    sH, sP, sN = mamba.ssm_heads, mamba.ssm_head_dim, mamba.ssm_state
    s_di, s_C = mamba.d_inner, mamba.d_inner + 2 * mamba.ssm_state
    s_F = 2 * s_di + 2 * sN + sH                  # in_proj's width, 10576

    def ssm_row(name, kern, plain, copies, nbytes, flops, replaces, shape,
                path, err, tol, per_call=1, peak=F32_FLOPS, extra=None):
        """Time an SSM kernel and its plain version, and keep its row. No
        single PyTorch call computes any of them (``F.conv1d`` with groups
        has no silu and no state: the conv's rows carry ``conv1d_pair``,
        two calls, as a yardstick), so ``library_ms`` is null. The bound is
        the bytes, or the counted operations at ``peak``: the f32 CUDA-core
        rate (67 TFLOP/s) for the decode kernels, the tensor cores' 989
        TFLOP/s for the scan."""
        ms, call_ms = time_calls(kern, copies, 100, per_call=per_call)
        attempts = time_calls.attempts
        plain_ms, _ = time_calls(plain, copies, 10)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / peak * 1e3
        t_bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else \
            (t_ops, "operations")
        rows[name] = dict(
            name=name, route="cuda", source=ssm_src, replaces=replaces,
            no_pallas_counterpart=True, shape=shape, path=path, launches=0,
            max_abs_err=err, tol=tol, ms=ms, call_ms=call_ms,
            plain_ms=plain_ms, bound_ms=t_bound, bound_by=by,
            library_ms=None, library=None, grid=None,
            trace_attempts=attempts, **(extra or {}))
        print(f"    device ms {ms:.4f} (per call back to back {call_ms:.4f};"
              f" {attempts} trace(s))  plain {plain_ms:.4f}  bound "
              f"{t_bound:.4f} ({by}, {nbytes / 1e6:.3f} MB, "
              f"{flops / 1e9:.3f} GFLOP) -> {t_bound / ms:.1%} of bound",
              flush=True)

    def ssm_params():
        with drawing_from(gen_ssm):
            return dict(w=randn(mamba.ssm_conv, s_C, scale=0.5).bfloat16(),
                        b=randn(s_C, scale=0.2).bfloat16(),
                        dt_bias=randn(sH, scale=0.5).bfloat16(),
                        A_log=randn(sH, scale=0.5).bfloat16(),
                        D=randn(sH).bfloat16(),
                        norm_w=(1 + randn(s_di, scale=0.1)).bfloat16())

    def ssm_rows_in(B, S):
        """The fused projection's output (B, S, 10576) and its z, xBC and
        dt views, as the model hands them to the kernels."""
        with drawing_from(gen_ssm):
            zx = randn(B, S, s_F).bfloat16()
        return (zx, zx[..., :s_di], zx[..., s_di:s_di + s_C],
                zx[..., s_di + s_C:])

    def conv1d_pair(sp, x):
        """The yardstick of the conv's rows: ``F.conv1d`` (depthwise,
        padding 3, with the bias) then ``F.silu`` on x (B, S, C), the JAX
        conv's function without its state (the kernel's state, the
        rounding of each product and partial sum and its strided rows are
        not in it); two library calls, used nowhere in the port."""
        S = x.shape[1]
        wc = sp["w"].t().contiguous().unsqueeze(1)         # (C, 1, W)
        return F.silu(F.conv1d(x.transpose(1, 2), wc, sp["b"],
                               padding=mamba.ssm_conv - 1,
                               groups=s_C)[..., :S]).transpose(1, 2)

    def ssm_conv_case(sp, B, S, advance=None, carry=True, timed=False,
                      path=None):
        """y and the new conv state bit-equal to the plain version's (the
        kernel rounds each product and partial sum where the plain version
        does; the state is a copy of inputs); a frozen row's state
        untouched. Timed (the prefill row) beside the unfused
        ``conv1d_pair``."""
        zx, z, xbc, dtr = ssm_rows_in(B, S)
        with drawing_from(gen_ssm):
            st0 = randn(B, mamba.ssm_conv - 1, s_C).bfloat16()
        adv = (None if advance is None else
               torch.tensor(advance, dtype=torch.bool, device=dev))
        s1, s2 = st0.clone(), st0.clone()
        y = ssm_conv(xbc, sp["w"], sp["b"], s1, adv, carry)
        ref = ssm_conv_plain(xbc, sp["w"], sp["b"], s2, adv, carry)
        torch.cuda.synchronize()
        err = float((y.float() - ref.float()).abs().max())
        tol = bf16_tol(ref)
        frozen = (~adv) if adv is not None else torch.zeros(
            B, dtype=torch.bool, device=dev)
        shape = f"B{B} S{S} C{s_C}" + ("" if carry else " no carry") + (
            f" advance {advance}" if advance else "")
        print(f"  ssm_conv {shape}: max_abs_err {err:.3e} (tol {tol:.3e}; "
              f"bit-equal {torch.equal(y, ref)}); state bit-equal "
              f"{torch.equal(s1, s2)}, frozen rows untouched "
              f"{torch.equal(s1[frozen], st0[frozen])}", flush=True)
        check(err <= tol, f"ssm_conv {shape}: {err} > {tol}")
        check(torch.equal(y, ref), f"ssm_conv {shape}: y differs from the "
              f"plain version's (max abs err {err})")
        check(torch.equal(s1, s2), f"ssm_conv {shape}: the new conv state "
              "differs from the plain version's")
        check(torch.equal(s1[frozen], st0[frozen]),
              f"ssm_conv {shape}: a frozen row's state was written")
        if not timed:
            return y
        n_adv = B if adv is None else int(adv.sum())
        nbytes = (B * S * s_C * 2 * 2 + (mamba.ssm_conv + 1) * s_C * 2
                  + (B * carry + n_adv) * (mamba.ssm_conv - 1) * s_C * 2)
        copies = [(xbc, st0.clone())] + [
            (xbc.clone(), st0.clone())
            for _ in range(n_copies(B * S * s_C * 4) - 1)]
        pair_err = None if carry else float(
            (conv1d_pair(sp, xbc).float() - ref.float()).abs().max())
        pair_ms, _ = time_calls(lambda x, s: conv1d_pair(sp, x), copies, 100)
        print(f"    the unfused pair F.conv1d + F.silu (no state): "
              f"{pair_ms:.4f} device ms" + (f", {pair_err:.3e} from the "
                                            "plain version" if pair_err
                                            is not None else ""),
              flush=True)
        ssm_row(f"ssm_conv[{'decode' if S == 1 else 'prefill'} B{B} S{S}]",
                lambda x, s: ssm_conv(x, sp["w"], sp["b"], s, adv, carry),
                lambda x, s: ssm_conv_plain(x, sp["w"], sp["b"], s, adv,
                                            carry),
                copies, nbytes, 0.0, "src/repro/models/ssm.py:43 (jnp)",
                shape, path, err, tol,
                extra=dict(conv1d_silu_pair_ms=pair_ms,
                           conv1d_silu_pair_err=pair_err))
        return y

    def ssm_decode_inputs(B, advance):
        """A decode token's inputs as the model hands them over: the conv's
        input (a strided xBC view of the projection's row), its dt view, a
        conv state, an SSD state and the advance mask."""
        zx, z, xbc, dtr = ssm_rows_in(B, 1)
        with drawing_from(gen_ssm):
            conv = randn(B, mamba.ssm_conv - 1, s_C).bfloat16()
            state = randn(B, sH, sP, sN, scale=0.3)
        return (xbc[:, 0], dtr[:, 0], conv, state,
                torch.tensor(advance, dtype=torch.bool, device=dev))

    def ssm_step_case(sp, B, advance, timed=False, path=None):
        """The decode conv and update in one launch (``ssm_decode_step``)
        against its plain version (``ssm_conv_plain`` then
        ``ssm_decode_update_plain``): y within one bf16 ulp, the SSD state
        within 1e-5 of its scale, the conv state bit-equal; a frozen row's
        states untouched; each slot alone bit-equal (y and both states) to
        its row of the batch. Timed beside the unfused ``conv1d_pair`` of
        the token (no state, no update)."""
        xbc, dt, conv, state, adv = ssm_decode_inputs(B, advance)
        vec = (sp["dt_bias"], sp["A_log"], sp["D"])
        s1, s2 = state.clone(), state.clone()
        c1, c2 = conv.clone(), conv.clone()
        y = ssm_decode_step(xbc, dt, sp["w"], sp["b"], c1, *vec, s1, adv)
        ref = ssm_decode_step_plain(xbc, dt, sp["w"], sp["b"], c2, *vec, s2,
                                    adv)
        alone = []
        for r in range(B):
            sr, cr = state[r:r + 1].clone(), conv[r:r + 1].clone()
            yr = ssm_decode_step(xbc[r:r + 1], dt[r:r + 1], sp["w"], sp["b"],
                                 cr, *vec, sr, adv[r:r + 1])
            alone.append((yr, sr, cr))
        torch.cuda.synchronize()
        err = float((y.float() - ref.float()).abs().max())
        tol = bf16_tol(ref)
        s_err = float((s1 - s2).abs().max())
        s_tol = 1e-5 * float(s2.abs().max())
        same = [torch.equal(yr[0], y[r]) and torch.equal(sr[0], s1[r])
                and torch.equal(cr[0], c1[r])
                for r, (yr, sr, cr) in enumerate(alone)]
        frozen = (torch.equal(s1[~adv], state[~adv])
                  and torch.equal(c1[~adv], conv[~adv]))
        shape = f"B{B} H{sH} P{sP} N{sN} C{s_C} advance {advance}"
        print(f"  ssm_decode_step {shape}: y max_abs_err {err:.3e} (tol "
              f"{tol:.3e}); state {s_err:.3e} (tol {s_tol:.3e}); conv state "
              f"bit-equal {torch.equal(c1, c2)}; frozen rows untouched "
              f"{frozen}; each slot alone bit-equal {same}", flush=True)
        check(err <= tol, f"ssm_decode_step {shape}: y {err} > {tol}")
        check(s_err <= s_tol, f"ssm_decode_step {shape}: state {s_err} > "
              f"{s_tol}")
        check(torch.equal(c1, c2), f"ssm_decode_step {shape}: the conv state "
              "differs from the plain version's")
        check(frozen, f"ssm_decode_step {shape}: a frozen row's state moved")
        check(all(same), f"ssm_decode_step {shape}: a slot alone differs "
              f"from its row of the batch: {same}")
        if not timed:
            return
        n_adv = int(adv.sum())
        row = sH * sP * sN * 4
        conv_row = (mamba.ssm_conv - 1) * s_C * 2
        nbytes = (B * row + n_adv * row + B * conv_row + n_adv * conv_row
                  + B * (s_C + sH + s_di) * 2
                  + (mamba.ssm_conv + 1) * s_C * 2 + 3 * sH * 2)
        copies = [(state.clone(), conv.clone())
                  for _ in range(n_copies(B * row))]
        yard_ms, _ = time_calls(lambda s, c: conv1d_pair(sp, xbc[:, None]),
                                copies, 100)
        ssm_row(f"ssm_decode_step[B{B}]",
                lambda s, c: ssm_decode_step(xbc, dt, sp["w"], sp["b"], c,
                                             *vec, s, adv),
                lambda s, c: ssm_decode_step_plain(xbc, dt, sp["w"], sp["b"],
                                                   c, *vec, s, adv),
                copies, nbytes, 4.0 * B * sH * sP * sN,
                "src/repro/models/ssm.py:43 and :150 (jnp)", shape, path,
                err, tol, extra=dict(conv1d_silu_pair_ms=yard_ms))
        print(f"    the unfused pair F.conv1d + F.silu of the token (no "
              f"state, no update): {yard_ms:.4f} device ms", flush=True)

    def ssm_step_run(sp, B=4, advance=(True, False, True, True), steps=64):
        """``steps`` decode steps in a row through ``ssm_decode_step`` and
        through its plain version from the same states, a row frozen: the
        conv state bit-equal after each step (a slot's last ticket
        replaces its B and C conv state before the next launch reads it),
        y within one bf16 ulp and the SSD state within 1e-5 of its scale
        at each step."""
        xbc, dt, conv, state, adv = ssm_decode_inputs(B, list(advance))
        vec = (sp["dt_bias"], sp["A_log"], sp["D"])
        s1, s2, c1, c2 = state.clone(), state.clone(), conv.clone(), \
            conv.clone()
        conv_same, worst_y, worst_s = [], 0.0, 0.0
        for i in range(steps):
            with drawing_from(gen_ssm):
                x = randn(B, s_F).bfloat16()[:, s_di:s_di + s_C]
                d = randn(B, sH).bfloat16()
            y = ssm_decode_step(x, d, sp["w"], sp["b"], c1, *vec, s1, adv)
            ref = ssm_decode_step_plain(x, d, sp["w"], sp["b"], c2, *vec, s2,
                                        adv)
            conv_same.append(torch.equal(c1, c2))
            worst_y = max(worst_y, float((y.float() - ref.float()).abs().max())
                          / bf16_tol(ref))
            worst_s = max(worst_s, float((s1 - s2).abs().max())
                          / (1e-5 * float(s2.abs().max())))
        torch.cuda.synchronize()
        frozen = (torch.equal(s1[~adv], state[~adv])
                  and torch.equal(c1[~adv], conv[~adv]))
        print(f"  ssm_decode_step: {steps} steps in a row at B{B} advance "
              f"{list(advance)}: conv state bit-equal to the plain pair's "
              f"after {sum(conv_same)} of {steps}; y at most {worst_y:.3f} of "
              f"its tolerance, the state at most {worst_s:.3f} of its; the "
              f"frozen row untouched {frozen}", flush=True)
        check(all(conv_same), f"ssm_decode_step: the conv state differs from "
              f"the plain pair's after {steps - sum(conv_same)} steps")
        check(worst_y <= 1 and worst_s <= 1 and frozen,
              f"ssm_decode_step: {steps} steps: y {worst_y}, state {worst_s} "
              f"of their tolerances, frozen row untouched {frozen}")
        return dict(steps=steps, conv_state_equal_steps=sum(conv_same),
                    y_of_tol=worst_y, state_of_tol=worst_s)

    def ssm_step_streams(sp, B=4, advance=(True, False, True, True),
                         reps=16):
        """``ssm_decode_step`` launched on two streams at once (two engines
        on one card), each on its own copy of the states: y and both
        states bit-equal to the same launch alone on the default stream
        (a slot's ticket is a stream's own)."""
        xbc, dt, conv, state, adv = ssm_decode_inputs(B, list(advance))
        vec = (sp["dt_bias"], sp["A_log"], sp["D"])
        s0, c0 = state.clone(), conv.clone()
        ref = ssm_decode_step(xbc, dt, sp["w"], sp["b"], c0, *vec, s0, adv)
        copies = [(state.clone(), conv.clone()) for _ in range(2 * reps)]
        streams = (torch.cuda.Stream(), torch.cuda.Stream())
        for st in streams:
            st.wait_stream(torch.cuda.current_stream())
        outs = []
        for i in range(reps):
            for j, st in enumerate(streams):
                s, c = copies[2 * i + j]
                with torch.cuda.stream(st):
                    outs.append((ssm_decode_step(xbc, dt, sp["w"], sp["b"], c,
                                                 *vec, s, adv), s, c))
        torch.cuda.synchronize()
        bad = sum(not (torch.equal(y, ref) and torch.equal(s, s0)
                       and torch.equal(c, c0)) for y, s, c in outs)
        print(f"  ssm_decode_step B{B} on two streams at once: {bad} of "
              f"{len(outs)} launches differ from the launch alone",
              flush=True)
        check(bad == 0, f"ssm_decode_step: {bad} of {len(outs)} launches on "
              "two streams differ from the launch alone")

    def ssd_prefill_case(sp, B, S, carry, timed=False, path=None):
        """y and the final f32 state against the plain ``ssd_chunked``
        (the JAX chunk rule at mamba2's chunk 256, halved to 1 at odd S,
        against the kernel's masked chunks of 64): y within one bf16 step
        of its scale, the state within ``SSD_STATE_REL_TOL`` of its."""
        zx, z, xbc_raw, dtr = ssm_rows_in(B, S)
        xbc = ssm_conv_plain(xbc_raw, sp["w"], sp["b"], torch.zeros(
            (B, mamba.ssm_conv - 1, s_C), dtype=torch.bfloat16, device=dev))
        with drawing_from(gen_ssm):
            state = randn(B, sH, sP, sN, scale=0.3)
        a1, a2 = state.clone(), state.clone()
        y = ssd_prefill(xbc, dtr, sp["dt_bias"], sp["A_log"], sp["D"], a1,
                        carry)
        ref = ssd_prefill_plain(xbc, dtr, sp["dt_bias"], sp["A_log"],
                                sp["D"], a2, carry, mamba.ssm_chunk)
        torch.cuda.synchronize()
        err = float((y.float() - ref.float()).abs().max())
        tol = bf16_tol(ref)
        s_err = float((a1 - a2).abs().max()) / float(a2.abs().max())
        shape = f"B{B} S{S} H{sH} P{sP} N{sN}" + ("" if carry else
                                                  " from zeros")
        print(f"  ssd_prefill {shape}: y max_abs_err {err:.3e} (tol "
              f"{tol:.3e}, {err / float(ref.float().abs().max()):.3e} of "
              f"its scale); state {s_err:.3e} of its scale (tol "
              f"{SSD_STATE_REL_TOL:.0e})", flush=True)
        check(err <= tol, f"ssd_prefill {shape}: y {err} > {tol}")
        check(s_err <= SSD_STATE_REL_TOL, f"ssd_prefill {shape}: state "
              f"{s_err} > {SSD_STATE_REL_TOL}")
        ssd_readings.append((err / float(ref.float().abs().max()), s_err))
        if not timed:
            return
        # the operations the function needs in the kernel's chunks, counted
        # once (the kernel runs each f32 operand's product three times, one
        # a bf16 part): C B^T and M x over the causal pairs k <= q only, the
        # state's two products over the real positions (not the last
        # chunk's masked tail); bound at the tensor cores' rate
        Q, flops = ssm_kernels.SCAN_CHUNK, 0.0
        for c0 in range(0, S, Q):
            q = min(Q, S - c0)
            pairs = q * (q + 1) // 2
            flops += 2.0 * B * (pairs * sN + sH * (pairs * sP
                                                   + 2 * q * sP * sN))
        nbytes = (B * S * (s_C + sH + s_di) * 2 + 3 * sH * 2
                  + (1 + carry) * B * sH * sP * sN * 4)
        copies = [(state.clone(),)] + [
            (state.clone(),) for _ in range(n_copies(B * S * s_C * 2) - 1)]
        ssm_row(f"ssd_prefill[B{B} S{S}]",
                lambda s: ssd_prefill(xbc, dtr, sp["dt_bias"], sp["A_log"],
                                      sp["D"], s, carry),
                lambda s: ssd_prefill_plain(xbc, dtr, sp["dt_bias"],
                                            sp["A_log"], sp["D"], s, carry,
                                            mamba.ssm_chunk),
                copies, nbytes, flops, "src/repro/models/ssm.py:68 (jnp)",
                shape, path, err, tol,
                per_call=ssm_kernels.scan_launches(S), peak=BF16_FLOPS,
                extra=dict(
                    launches_per_call=ssm_kernels.scan_launches(S),
                    f32_cuda_core_bound_ms=flops / F32_FLOPS * 1e3))

    def ssd_alone_case(sp, B=4, S=300):
        """A sequence alone is bit-equal to its row in a B-row call (y and
        the final state): nothing in the scan's plan depends on B."""
        zx, z, xbc_raw, dtr = ssm_rows_in(B, S)
        xbc = ssm_conv_plain(xbc_raw, sp["w"], sp["b"], torch.zeros(
            (B, mamba.ssm_conv - 1, s_C), dtype=torch.bfloat16, device=dev))
        with drawing_from(gen_ssm):
            state = randn(B, sH, sP, sN, scale=0.3)
        sb = state.clone()
        yb = ssd_prefill(xbc, dtr, sp["dt_bias"], sp["A_log"], sp["D"], sb,
                         True)
        equal = []
        for r in range(B):
            s1 = state[r:r + 1].clone()
            y1 = ssd_prefill(xbc[r:r + 1], dtr[r:r + 1], sp["dt_bias"],
                             sp["A_log"], sp["D"], s1, True)
            equal.append(torch.equal(y1, yb[r:r + 1])
                         and torch.equal(s1, sb[r:r + 1]))
        torch.cuda.synchronize()
        print(f"  ssd_prefill B{B} S{S}: each sequence alone bit-equal to its "
              f"row of the batch (y and state): {equal}", flush=True)
        check(all(equal), f"ssd_prefill: a sequence alone differs from its "
              f"row in a B {B} call: {equal}")

    def ssd_small_state_case(sp, H=4, N=48, B=2, S=130):
        """N below the kernel's 128 (zero columns in its tiles) on a few
        heads, against the plain scan."""
        with drawing_from(gen_ssm):
            xbc = F.silu(randn(B, S, H * sP + 2 * N)).bfloat16()
            dtr = randn(B, S, H).bfloat16()
            state = randn(B, H, sP, N, scale=0.3)
        a1, a2 = state.clone(), state.clone()
        args = (sp["dt_bias"][:H], sp["A_log"][:H], sp["D"][:H])
        y = ssd_prefill(xbc, dtr, *args, a1, True)
        ref = ssd_prefill_plain(xbc, dtr, *args, a2, True, mamba.ssm_chunk)
        torch.cuda.synchronize()
        err = float((y.float() - ref.float()).abs().max())
        tol = bf16_tol(ref)
        s_err = float((a1 - a2).abs().max()) / float(a2.abs().max())
        print(f"  ssd_prefill B{B} S{S} H{H} N{N}: y max_abs_err {err:.3e} "
              f"(tol {tol:.3e}); state {s_err:.3e} of its scale", flush=True)
        check(err <= tol and s_err <= SSD_STATE_REL_TOL,
              f"ssd_prefill N{N}: y {err} (tol {tol}), state {s_err}")
        ssd_readings.append((err / float(ref.float().abs().max()), s_err))

    def ssd_memory_case(sp, B=1, S=None):
        """The card's peak allocation over one call at B x S
        (``SSM_LONG_PROMPT``): at most y and one slice's f32 scratch of
        incoming states (``SCAN_SLICE`` chunks a sequence, whatever S),
        against ``ceil(S / 64)`` chunks' unsliced."""
        S = S or SSM_LONG_PROMPT
        zx, z, xbc, dtr = ssm_rows_in(B, S)
        with drawing_from(gen_ssm):
            state = randn(B, sH, sP, sN, scale=0.3)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        y = ssd_prefill(xbc, dtr, sp["dt_bias"], sp["A_log"], sp["D"], state,
                        True)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        chunk_bytes = B * sH * sP * sN * 4
        nc = -(-S // ssm_kernels.SCAN_CHUNK)
        scratch = min(nc, ssm_kernels.SCAN_SLICE) * chunk_bytes
        y_bytes = y.numel() * y.element_size()
        print(f"  ssd_prefill B{B} S{S}: peak allocation over the inputs "
              f"{peak / 2 ** 20:.1f} MiB (y {y_bytes / 2 ** 20:.1f} MiB, one "
              f"slice's scratch {scratch / 2 ** 20:.1f} MiB; unsliced "
              f"{nc * chunk_bytes / 2 ** 20:.1f} MiB), "
              f"{ssm_kernels.scan_launches(S)} launches", flush=True)
        check(peak <= y_bytes + scratch + 2 * 2 ** 20,
              f"ssd_prefill B{B} S{S}: peak {peak} bytes over y {y_bytes} + "
              f"scratch {scratch}")
        check(bool(torch.isfinite(y.float()).all())
              and bool(torch.isfinite(state).all()),
              f"ssd_prefill B{B} S{S}: nonfinite output")
        ssd_memory.update(B=B, S=S, peak_bytes=peak, y_bytes=y_bytes,
                          scratch_bytes=scratch,
                          unsliced_scratch_bytes=nc * chunk_bytes,
                          launches=ssm_kernels.scan_launches(S))

    def gated_case(sp, B, S, timed=False, path=None):
        """rmsnorm(y * silu(z)) within one bf16 ulp, z read in place from
        the projection's rows; row 0 alone bit-equal to row 0 of the call
        (a B 4 decode and a 1 x 512 prefill among them)."""
        zx, z, _, _ = ssm_rows_in(B, S)
        with drawing_from(gen_ssm):
            y = randn(B, S, s_di).bfloat16()
        eps = mamba.norm_eps
        out = gated_rmsnorm(y, z, sp["norm_w"], eps)
        ref = gated_rmsnorm_plain(y, z, sp["norm_w"], eps)
        alone = gated_rmsnorm(y.reshape(-1, s_di)[:1],
                              z.reshape(-1, s_di)[:1], sp["norm_w"], eps)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        tol = bf16_tol(ref)
        shape = f"B{B} S{S} d{s_di}"
        same = torch.equal(alone[0], out.reshape(-1, s_di)[0])
        print(f"  gated_rmsnorm {shape}: max_abs_err {err:.3e} (tol "
              f"{tol:.3e}), {int((out != ref).sum())} of {out.numel()} "
              f"elements differ; row 0 alone "
              f"{'bit-equal' if same else 'DIFFERS'}", flush=True)
        check(err <= tol, f"gated_rmsnorm {shape}: {err} > {tol}")
        check(same, f"gated_rmsnorm {shape}: row 0 alone differs from row "
              "0 in the call")
        if not timed:
            return
        nbytes = 3 * B * S * s_di * 2 + s_di * 2
        copies = [(y, z)] + [(y.clone(), z.clone()) for _ in
                             range(n_copies(B * S * s_di * 4) - 1)]
        name = f"gated_rmsnorm[B{B} S{S}]"
        ssm_row(name, lambda a, b: gated_rmsnorm(a, b, sp["norm_w"], eps),
                lambda a, b: gated_rmsnorm_plain(a, b, sp["norm_w"], eps),
                copies, nbytes, 0.0, "src/repro/models/ssm.py:143 (jnp)",
                shape, path, err, tol,
                extra=dict(plan=ssm_kernels.norm_plan(s_di)))

    def ssm_kernel_cases():
        """The four SSM kernels against their plain versions at
        mamba2-2.7b's widths: decode at 4 slots (one frozen) and 1; the
        conv and the scan at several S (the scan past one slice too), with
        and without a carried state, a sequence alone against its batch
        row, N 48, the scan's peak allocation at a long prompt; then ``quant_matmul`` at ``in_proj`` (2560 x 10576, a ragged
        80-column edge) and ``out_proj`` (5120 x 2560) under q8_0 and q4_0
        at M 1, 4 and 512."""
        sp = ssm_params()
        ssm_conv_case(sp, 4, 1, [True, False, True, True])
        ssm_conv_case(sp, 1, 1)
        for S in (1, 2, 3, 37, 301):
            for carry in (True, False):
                ssm_conv_case(sp, 2, S, carry=carry)
        ssm_conv_case(sp, 1, 300, carry=False)
        ssm_conv_case(sp, 4, 300, carry=False)
        ssm_conv_case(sp, 1, 512, carry=False, timed=True, path="ssm stall")
        ssm_step_case(sp, 4, [True, False, True, True], timed=True,
                      path="ssm q8_0")
        ssm_step_case(sp, 1, [True], timed=True, path="ssm q8_0 alone")
        ssm_step_case(sp, 2, [False, True])
        ssm_step_readings.update(ssm_step_run(sp))
        ssm_step_streams(sp)
        for S in (1, 3, 37, 63, 64, 65, 301, 512, 1100):
            for carry in (True, False):
                ssd_prefill_case(sp, 1, S, carry,
                                 timed=(S == 512 and not carry),
                                 path="ssm stall")
        ssd_prefill_case(sp, 4, 300, False, timed=True, path="ssm stall")
        ssd_alone_case(sp)
        ssd_alone_case(sp, B=2, S=1100)
        ssd_small_state_case(sp)
        ssd_memory_case(sp)
        gated_case(sp, 4, 1, timed=True, path="ssm q8_0")
        gated_case(sp, 1, 1, timed=True, path="ssm q8_0 alone")
        gated_case(sp, 1, 512, timed=True, path="ssm stall")
        gated_case(sp, 2, 37)
        with drawing_from(gen_ssm):
            for label, (K, N) in (("in_proj", (mamba.d_model, s_F)),
                                  ("out_proj", (s_di, mamba.d_model))):
                qmm_case("q8_0", label, B, K, N, torch.bfloat16, timed=True,
                         path="ssm q8_0")
                qmm_case("q4_0", label, B, K, N, torch.bfloat16, timed=True,
                         path="ssm q4_0")
                for fmt in ("q8_0", "q4_0"):
                    qmm_case(fmt, label, 1, K, N, torch.bfloat16,
                             timed=False)
                qmm_case("q8_0", label, 512, K, N, torch.bfloat16,
                         timed=True, path="ssm stall")
                qmm_case("q4_0", label, 512, K, N, torch.bfloat16,
                         timed=False)
        r_y, r_s = (max(r[i] for r in ssd_readings) for i in (0, 1))
        print(f"  ssd_prefill against the plain scan: y at most {r_y:.3e} "
              f"of its scale (tol one bf16 step, {2.0 ** -7:.3e}), the "
              f"state at most {r_s:.3e} of its scale (tol "
              f"{SSD_STATE_REL_TOL:.0e})", flush=True)

    ssd_readings, ssd_memory, ssm_step_readings = [], {}, {}
    print("SSM kernels vs plain versions on the card:", flush=True)
    t0 = time.perf_counter()
    ssm_kernel_cases()
    ssm_kernel_s = time.perf_counter() - t0

    # -- the hybrid family's kernels (recurrentgemma-2b) ---------------------
    # the RG-LRU scan and decode step, the GeGLU alone and as the gate-up
    # GEMM's epilogue, the (256, 10) instances of both attention kernels and
    # of the RoPE + cache writes, and quant_matmul at the model's linears
    rglru_src = "src/repro_torch/kernels/csrc/rglru.cu"
    gen_hybrid = torch.Generator(device=dev)     # the hybrid's kernel cases
    gen_hybrid.manual_seed(30)
    rgc = get_config(HYBRID_ARCH)
    hW, hHq, hHkv, hD = (rgc.lru_width, rgc.num_heads, rgc.num_kv_heads,
                         rgc.head_dim)
    # the RG-LRU's f32 operations a position and channel, counted from the
    # source: the two gates (an add, a sigmoid and a rounding each), the
    # decay's exp, the step (7) and the gelu-gated output (15)
    RGLRU_OPS = 35

    def rglru_params():
        with drawing_from(gen_hybrid):
            return dict(ba=randn(hW, scale=0.5).bfloat16(),
                        bx=randn(hW, scale=0.5).bfloat16(),
                        a=(4.0 + randn(hW)).bfloat16())

    def rglru_inputs(B, S):
        """The conv's output x (B, S, w), the gate products' row
        [x wa | x wx] (B, S, 2w), and the gate: a column view of in_proj's
        (B, S, 2w) output, as the model hands them over (S None: one decode
        token, (B, ...))."""
        lead = (B,) if S is None else (B, S)
        with drawing_from(gen_hybrid):
            xg = randn(*lead, 2 * hW).bfloat16()
            return (randn(*lead, hW).bfloat16(),
                    randn(*lead, 2 * hW).bfloat16(), xg[..., hW:])

    def rglru_row(name, kern, plain, copies, nbytes, flops, shape, path,
                  err, tol, grid):
        """Time an RG-LRU kernel and its plain version and keep its row.
        No single PyTorch call computes either (library_ms null); the bound
        is the bytes, or the counted f32 operations at 67 TFLOP/s."""
        ms, call_ms = time_calls(kern, copies, 100, per_call=1)
        attempts = time_calls.attempts
        plain_ms, _ = time_calls(plain, copies, 5)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS * 1e3
        t_bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else \
            (t_ops, "operations")
        rows[name] = dict(
            name=name, route="cuda", source=rglru_src,
            replaces="src/repro/models/hybrid.py:43-112 (jnp)",
            no_pallas_counterpart=True, shape=shape, path=path, launches=0,
            max_abs_err=err, tol=tol, ms=ms, call_ms=call_ms,
            plain_ms=plain_ms, bound_ms=t_bound, bound_by=by,
            library_ms=None, library=None, grid=grid,
            trace_attempts=attempts)
        print(f"    device ms {ms:.4f} (per call back to back {call_ms:.4f};"
              f" {attempts} trace(s))  plain {plain_ms:.4f}  bound "
              f"{t_bound:.4f} ({by}, {nbytes / 1e6:.3f} MB) -> "
              f"{t_bound / ms:.1%} of bound; grid {grid}", flush=True)

    def rglru_scan_case(rp, B, S, timed=False, path=None):
        """y within one bf16 ulp of the plain version; the state the last
        position's y, bit-equal to y's last row (whatever it held before:
        the scan starts from zeros); each sequence alone bit-equal to its
        row of the batch."""
        x, gx, gate = rglru_inputs(B, S)
        with drawing_from(gen_hybrid):
            st0 = randn(B, hW)
        vec = (rp["ba"], rp["bx"], rp["a"])
        s1, s2 = st0.clone(), st0.clone()
        y = rglru_scan(x, gx, gate, *vec, s1)
        ref = rglru_scan_plain(x, gx, gate, *vec, s2)
        alone = [rglru_scan(x[r:r + 1], gx[r:r + 1], gate[r:r + 1], *vec,
                            st0[r:r + 1].clone()) for r in range(B)]
        torch.cuda.synchronize()
        err = float((y.float() - ref.float()).abs().max())
        tol = bf16_tol(ref)
        last = torch.equal(s1, y[:, -1].float())
        same = [torch.equal(a[0], y[r]) for r, a in enumerate(alone)]
        shape = f"B{B} S{S} w{hW}"
        print(f"  rglru_scan {shape}: y max_abs_err {err:.3e} (tol "
              f"{tol:.3e}); state == y's last row {last}; each sequence "
              f"alone bit-equal {same}", flush=True)
        check(err <= tol, f"rglru_scan {shape}: y {err} (tol {tol})")
        check(last, f"rglru_scan {shape}: the state is not the last y")
        check(all(same), f"rglru_scan {shape}: a sequence alone differs "
              f"from its row of the batch: {same}")
        if not timed:
            return
        nbytes = B * S * hW * (2 + 4 + 2 + 2) + B * hW * 4 + 3 * hW * 2
        # copies of every input (the gate a view of its own in_proj row)
        copies = [(x, gx, gate, st0.clone())] + [
            (x.clone(), gx.clone(), gate._base.clone()[..., hW:],
             st0.clone())
            for _ in range(n_copies(B * S * hW * 10) - 1)]
        rglru_row(f"rglru_scan[{shape}]",
                  lambda a, g_, gt, st: rglru_scan(a, g_, gt, *vec, st),
                  lambda a, g_, gt, st: rglru_scan_plain(a, g_, gt, *vec,
                                                         st),
                  copies, nbytes, float(RGLRU_OPS * B * S * hW), shape, path,
                  err, tol, dict(ctas=math.prod(
                      rglru_kernels.scan_grid(B, hW)),
                      threads=rglru_kernels.SCAN_THREADS))

    def rglru_step_case(rp, B, advance, timed=False, path=None):
        """y within one bf16 ulp of the plain version, the state within
        1e-5 of its scale, a frozen row's state untouched, each slot alone
        bit-equal to its row of the batch."""
        x, gx, gate = rglru_inputs(B, None)
        with drawing_from(gen_hybrid):
            st0 = randn(B, hW)
        adv = torch.tensor(advance, dtype=torch.bool, device=dev)
        vec = (rp["ba"], rp["bx"], rp["a"])
        s1, s2 = st0.clone(), st0.clone()
        y = rglru_decode_step(x, gx, gate, *vec, s1, adv)
        ref = rglru_decode_step_plain(x, gx, gate, *vec, s2, adv)
        alone = []
        for r in range(B):
            sr = st0[r:r + 1].clone()
            alone.append((rglru_decode_step(x[r:r + 1], gx[r:r + 1],
                                            gate[r:r + 1], *vec, sr,
                                            adv[r:r + 1]), sr))
        torch.cuda.synchronize()
        err = float((y.float() - ref.float()).abs().max())
        tol = bf16_tol(ref)
        s_err = float((s1 - s2).abs().max())
        s_tol = 1e-5 * float(s2.abs().max())
        same = [torch.equal(a[0][0], y[r]) and torch.equal(a[1][0], s1[r])
                for r, a in enumerate(alone)]
        frozen = torch.equal(s1[~adv], st0[~adv])
        shape = f"B{B} w{hW} advance {advance}"
        print(f"  rglru_decode_step {shape}: y max_abs_err {err:.3e} (tol "
              f"{tol:.3e}); state {s_err:.3e} (tol {s_tol:.3e}); frozen rows"
              f" untouched {frozen}; each slot alone bit-equal {same}",
              flush=True)
        check(err <= tol and s_err <= s_tol, f"rglru_decode_step {shape}: "
              f"y {err} (tol {tol}), state {s_err} (tol {s_tol})")
        check(frozen, f"rglru_decode_step {shape}: a frozen row's state "
              "moved")
        check(all(same), f"rglru_decode_step {shape}: a slot alone differs "
              f"from its row of the batch: {same}")
        if not timed:
            return
        n_adv = int(adv.sum())
        nbytes = B * hW * (2 + 4 + 2 + 2 + 4) + n_adv * hW * 4 + B + 6 * hW
        copies = [(st0.clone(),) for _ in range(n_copies(B * hW * 8))]
        rglru_row(f"rglru_decode_step[B{B}]",
                  lambda st: rglru_decode_step(x, gx, gate, *vec, st, adv),
                  lambda st: rglru_decode_step_plain(x, gx, gate, *vec, st,
                                                     adv),
                  copies, nbytes, float(RGLRU_OPS * B * hW), shape, path,
                  err, tol, dict(ctas=math.prod(
                      rglru_kernels.step_grid(B, hW)),
                      threads=rglru_kernels.STEP_THREADS))

    def geglu_case(M, Fw, timed=False, path=None):
        with drawing_from(gen_hybrid):
            gu = (randn(M, 2 * Fw) * 2).bfloat16()
        rowwise_case("geglu", geglu, geglu_plain, (gu,),
                     f"M{M} F{Fw} bfloat16", timed, path,
                     3 * M * Fw * gu.element_size(),
                     "src/repro/models/mlp.py:37 (layers.py:108 gelu)")

    def hybrid_kernel_cases():
        """The RG-LRU kernels at recurrentgemma-2b's width: the scan at
        1 x 512 and 4 x 300 and edge lengths (a block of 48 and one past
        it), the decode
        step at 4 slots (a row frozen) and 1; the GeGLU alone at (4, 15360)
        and (2048, 15360) and in the gate-up GEMM at K 2560, F 7680, M 4
        and 2048 under q8_0 and q4_0; the (256, 10) instances: decode
        attention at 4 slots of kv_len 1024 and of the served kv_len (all
        three loaders), flash attention causal at 4 x 512 and windowed
        (2048) at 1 x 4500 beside SDPA, the decode and prefill RoPE + cache
        writes (the ring write too); quant_matmul at the model's linears at
        M 4 and 2048."""
        rp = rglru_params()
        rglru_scan_case(rp, 1, 512, timed=True, path="hybrid stall")
        rglru_scan_case(rp, 4, 300, timed=True, path="hybrid stall")
        for B_, S_ in ((2, 37), (1, 1), (3, 16), (2, 48), (2, 49), (2, 301)):
            rglru_scan_case(rp, B_, S_)
        rglru_step_case(rp, 4, [True, False, True, True], timed=True,
                        path="hybrid q8_0")
        rglru_step_case(rp, 1, [True], timed=True, path="hybrid q8_0 alone")
        rglru_step_case(rp, 2, [False, True])
        geglu_case(B, rgc.d_ff, timed=True, path="hybrid bf16")
        geglu_case(2048, rgc.d_ff, timed=True, path="hybrid bf16")
        geglu_case(3, 100)
        for fmt in ("q8_0", "q4_0"):
            qmm_swiglu_case(fmt, B, rgc.d_model, rgc.d_ff, timed=True,
                            path=f"hybrid {fmt}", act="gelu", g=gen_hybrid)
            qmm_swiglu_case(fmt, 2048, rgc.d_model, rgc.d_ff,
                            timed=fmt == "q8_0", path="hybrid stall",
                            act="gelu", g=gen_hybrid)
            qmm_swiglu_case(fmt, 1, rgc.d_model, rgc.d_ff, act="gelu",
                            g=gen_hybrid)
            qmm_swiglu_case(fmt, 9, 256, 100, act="gelu", g=gen_hybrid)
        inst = f"D{hD} G{hHq // hHkv}"
        with drawing_from(gen_hybrid):
            for fmt in ("bf16", "q8_0", "q4_0"):
                rope_case(fmt, 3, hHq, hHkv, 200, hD, [199, 200, 63],
                          [True, True, False])
            rope_prefill_case("bf16", 2, 300, 2048, hHq, hHkv, hD)
            rope_prefill_case("bf16", 1, 2100, 2048, hHq, hHkv, hD)
            for fmt in ("bf16", "q8_0", "q4_0"):
                attention_case(fmt, B, hHq, hHkv, S, hD, [S] * B, 0,
                               timed=fmt == "bf16", instance=inst,
                               path="hybrid q8_0")
                attention_case(fmt, B, hHq, hHkv, S, hD, [40, 33, 41, 37],
                               0, timed=fmt == "bf16",
                               instance=f"{inst} kv_len 40",
                               path="hybrid q8_0")
                attention_case(fmt, B, hHq, hHkv, S, hD, [0, 1, 300, S],
                               64, timed=False, instance=inst)
            flash_case(B, hHq, hHkv, 512, 512, hD, 0, 0, timed=True,
                       instance=inst, path="hybrid stall")
            flash_case(1, hHq, hHkv, 4500, 4500, hD, rgc.local_attn_window,
                       0, timed=True, instance=inst, path="hybrid window")
            for case in ((2, hHq, hHkv, 333, 333, hD, 0, 0),
                         (2, hHq, hHkv, 300, 300, hD, 64, 0),
                         (1, hHq, hHkv, 24, 16, hD, 12, 8)):
                flash_case(*case, timed=False)
            for label, (K, N) in (
                    ("rg in_proj", (rgc.d_model, 2 * hW)),
                    ("rg wa", (hW, hW)),
                    ("rg wqkv", (rgc.d_model, rgc.q_dim + 2 * rgc.kv_dim)),
                    ("rg w_down", (rgc.d_ff, rgc.d_model))):
                for fmt in ("q8_0", "q4_0"):
                    qmm_case(fmt, label, B, K, N, torch.bfloat16,
                             timed=True, path=f"hybrid {fmt}")
                qmm_case("q8_0", label, 2048, K, N, torch.bfloat16,
                         timed=True, path="hybrid stall")
                qmm_case("q4_0", label, 2048, K, N, torch.bfloat16,
                         timed=False)

    hybrid_readings = {}
    print("the hybrid family's kernels vs plain versions on the card:",
          flush=True)
    t0 = time.perf_counter()
    hybrid_kernel_cases()
    hybrid_kernel_s = time.perf_counter() - t0
    print(f"  the hybrid family's kernel cases: {hybrid_kernel_s:.1f} s",
          flush=True)

    # -- shared checks of a served path -------------------------------------
    def clone_cache(c):
        out = {"lens": c["lens"].clone(),
               "layers": [{k: t.clone() for k, t in layer.items()}
                          for layer in c["layers"]]}
        if "block_table" in c:
            out["block_table"] = c["block_table"].clone()
        return out

    def judge(logits, tol, label, what):
        """Kernels vs plain versions (and the plain versions with the
        planted fault) for one batch of logits: the kernels must stay
        within ``tol`` of the logit scale, the planted fault must land
        beyond it, so the check would have caught it, and the greedy
        argmax must agree on every row but a near tie: one whose plain
        top-2 margin is within twice the measured error, which bf16
        rounding can flip. Returns (error, fault error) as shares of the
        largest logit."""
        lk, lp, lf = logits["kernels"], logits["plain"], logits["fault"]
        check(bool(torch.isfinite(lk).all()), f"{label}: nonfinite logits")
        scale = float(lp.abs().max())
        err_abs = float((lk - lp).abs().max())
        err = err_abs / scale
        fault = float((lf - lp).abs().max()) / scale
        top2 = lp.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        flips = lk.argmax(-1) != lp.argmax(-1)
        near_tie = margin <= 2 * err_abs
        print(f"  {label}: {what} logits kernels vs plain max_abs_err "
              f"{err:.3e} of the logit scale {scale:.3f} (tol {tol:.1e}); "
              f"planted fault {fault:.3e}; argmax differs on "
              f"{int(flips.sum())} of {lk.shape[0]} rows, "
              f"{int(near_tie.sum())} near ties (least top-2 margin "
              f"{float(margin.min()) / scale:.3e})", flush=True)
        check(err <= tol, f"{label}: kernel-vs-plain {what} logits {err} > "
              f"{tol}")
        check(fault > tol, f"{label}: the planted fault's error {fault} is "
              f"within the tolerance {tol}")
        check(not bool((flips & ~near_tie).any()),
              f"{label}: the kernels' greedy argmax differs from the "
              "plain versions' on a row that is no near tie")
        return err, fault

    def three_routes(run):
        """run() through the kernels, the plain versions, and the plain
        versions with the planted faults. An MoE layer's routing is a
        discrete choice: rounding that differs between the passes can flip
        a near tie among the router's logits and send a token to another
        expert, which moves the logits far past any rounding. So the plain
        passes route each MoE layer call to the experts the kernel pass
        chose there (``route_from_logits_plain(experts=)``, gates from
        their own logits), and the check is that every token whose plain
        logits would choose other experts is a near tie: each pinned
        expert's plain logit within twice that call's largest logit
        difference between the passes of the plain K-th largest."""
        out = {}
        picks, flips = [], []
        kernel_route = ops.moe_route

        def recording(x, w, K, C, reads=None):
            r = kernel_route(x, w, K, C, reads)
            picks.append((r[1], r[5]))
            return r

        def pinned_route(calls, judged):
            def route(x, w, K, C, reads=None):
                experts, lk = next(calls)
                lg = router_logits_plain(x, w)
                if judged:
                    own = torch.sort(lg, dim=-1, descending=True, stable=True)
                    same = (own.indices[:, :K].sort(-1).values
                            == experts.long().sort(-1).values).all(-1)
                    delta = 2 * float((lk - lg).abs().max())
                    near = (lg.gather(1, experts.long()).min(-1).values
                            >= own.values[:, K - 1] - delta)
                    flips.append((int((~same).sum()),
                                  int((~same & ~near).sum()), delta,
                                  lg.shape[0]))
                return route_from_logits_plain(lg, K, C, reads,
                                               experts=experts)
            return route

        for route in ("kernels", "plain", "fault"):
            ctx = (contextlib.nullcontext() if route == "kernels"
                   else plain_versions(fault=route == "fault"))
            with ctx:
                ops.moe_route = (recording if route == "kernels" else
                                 pinned_route(iter(picks), route == "plain"))
                try:
                    out[route] = run()
                finally:
                    ops.moe_route = kernel_route
        torch.cuda.synchronize()
        if flips:
            n = sum(f[0] for f in flips)
            far = sum(f[1] for f in flips)
            print(f"    MoE routing: {len(flips)} layer calls; the plain "
                  f"pass's own logits would choose other experts for {n} of "
                  f"{sum(f[3] for f in flips)} tokens, {far} of them no near"
                  f" tie (largest 2x logit difference between the passes "
                  f"{max(f[2] for f in flips):.3e})", flush=True)
            check(far == 0, f"{far} tokens whose kernel-pass experts are no "
                  "near tie of the plain pass's own choice")
        return out

    def step_vs_plain(engine, label, seeds=STEP_SEEDS, tol=STEP_REL_TOL):
        """One decode step from the engine's current cache, for a few
        seeded token batches, judged against ``tol`` (the planted fault:
        the attention one position short, the SSD state not decayed)."""
        worst, fault_least = 0.0, math.inf
        for seed in range(seeds):
            g = torch.Generator(device=dev)
            g.manual_seed(seed)
            toks = torch.randint(1, engine.cfg.vocab_size,
                                 (engine.slots, 1), generator=g, device=dev)
            logits = three_routes(lambda: engine.model.decode_step(
                engine.params, toks, clone_cache(engine.cache)))
            err, fault = judge(logits, tol, f"{label} seed {seed}",
                               "decode_step")
            worst, fault_least = max(worst, err), min(fault_least, fault)
        return dict(max_rel_err=worst, fault_least_rel_err=fault_least)

    def prefill_vs_plain(engine, lens, label, seeds=PREFILL_SEEDS,
                         tol=PREFILL_REL_TOL):
        """One fused prefill of a bucket with these true lengths, for a
        few seeded token batches, judged against ``tol`` (the planted
        fault: each query also sees the next key, the SSD state not
        decayed)."""
        n, S = len(lens), engine._bucket_len(max(lens))
        seq_lens = torch.tensor(lens, device=dev)
        worst, fault_least = 0.0, math.inf
        for seed in range(seeds):
            g = torch.Generator(device=dev)
            g.manual_seed(seed)
            toks = torch.randint(1, engine.cfg.vocab_size, (n, S),
                                 generator=g, device=dev)
            logits = three_routes(lambda: engine.model.prefill(
                engine.params, toks, engine.model.init_cache(
                    n, engine.max_len), seq_lens=seq_lens))
            err, fault = judge(logits, tol,
                               f"{label} seed {seed}",
                               f"prefill ({n} x {S}, seq_lens {lens})")
            worst, fault_least = max(worst, err), min(fault_least, fault)
        return dict(max_rel_err=worst, fault_least_rel_err=fault_least)

    def recurrent_layers_vs_plain(engine, label, lens=None):
        """Each SSM layer (a hybrid's RG-LRU layer) of one decode step from
        the engine's cache (with ``lens``: of one fused prefill of a bucket
        of these true lengths) through the kernels, the plain versions and
        the plain versions with the planted fault (the state not decayed),
        on the same input and states: the kernel pass's. Each layer's
        output and new state
        must stay within one bf16 ulp of the plain version's scale
        (``bf16_tol``), and the planted fault must land beyond it in every
        layer. Then a whole pass through the plain versions gives, layer by
        layer, how far its input has drifted from the kernel pass's: the
        layers' rounding compounding with depth, which the end-to-end
        checks read at the logits."""
        model, params = engine.model, engine.params
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        hybrid = engine.cfg.arch_type == "hybrid"
        mod = hybrid_mod if hybrid else ssm_mod
        n_layers = (engine.model.kinds.count("rglru") if hybrid
                    else engine.cfg.num_layers)
        if lens is None:
            name = "rglru_decode" if hybrid else "ssm_decode"
            what = "decode_step"
            toks = torch.randint(1, engine.cfg.vocab_size, (engine.slots, 1),
                                 generator=g, device=dev)

            def run():
                return model.decode_step(params, toks,
                                         clone_cache(engine.cache))
        else:
            S = engine._bucket_len(max(lens))
            name = "rglru_forward" if hybrid else "ssm_prefill"
            what = f"prefill ({len(lens)} x {S})"
            toks = torch.randint(1, engine.cfg.vocab_size, (len(lens), S),
                                 generator=g, device=dev)
            seq_lens = torch.tensor(lens, device=dev)

            def run():
                return model.prefill(params, toks, model.init_cache(
                    len(lens), engine.max_len), seq_lens=seq_lens)
        real = getattr(mod, name)
        rel = bf16_tol(torch.ones(()))
        errs, inputs = [], {"kernels": [], "plain": []}

        def share(a, b):
            return float((a.float() - b.float()).abs().max()) / float(
                b.float().abs().max())

        def checked(p, cfg, z, cache, *a):
            inputs["kernels"].append(z.clone())
            before = {k: t.clone() for k, t in cache.items()}
            out = real(p, cfg, z, cache, *a)
            row = []
            for fault in (False, True):
                c = {k: t.clone() for k, t in before.items()}
                with plain_versions(fault=fault):
                    ref = real(p, cfg, z, c, *a)
                row.append((share(out, ref), share(cache["state"],
                                                   c["state"])))
            errs.append(row)
            return out

        def recording(p, cfg, z, cache, *a):
            inputs["plain"].append(z.clone())
            return real(p, cfg, z, cache, *a)

        try:
            setattr(mod, name, checked)
            lk = run()
            setattr(mod, name, recording)
            with plain_versions():
                lp = run()
        finally:
            setattr(mod, name, real)
        torch.cuda.synchronize()
        L = len(errs)
        check(L == n_layers and len(inputs["plain"]) == L,
              f"{label}: {L} recurrent layer calls checked")
        out_err = max(e[0][0] for e in errs)
        state_err = max(e[0][1] for e in errs)
        fault_least = min(e[1][0] for e in errs)
        drift = [share(k, p) for k, p in zip(inputs["kernels"],
                                            inputs["plain"])]
        at = sorted({0, 1, L // 4, L // 2, L - 1})
        print(f"  {label}: {what} {name} layer by layer on the same input: "
              f"output at most {out_err:.3e}, state {state_err:.3e} of "
              f"their scales (tol one bf16 ulp, {rel:.3e}); planted fault at"
              f" least {fault_least:.3e} in every layer; a whole plain pass's"
              f" input drift from the kernel pass's by layer "
              + ", ".join(f"{l}: {drift[l]:.3e}" for l in at)
              + f"; logits {share(lk, lp):.3e}", flush=True)
        check(out_err <= rel and state_err <= rel,
              f"{label}: a recurrent layer's output ({out_err}) or state "
              f"({state_err}) through the kernels is beyond one bf16 ulp of "
              "the plain versions' on the same input")
        check(fault_least > rel, f"{label}: the planted fault's error "
              f"{fault_least} is within one bf16 ulp in some layer")
        return dict(layer_max_rel_err=out_err,
                    layer_state_max_rel_err=state_err,
                    layer_fault_least_rel_err=fault_least,
                    input_drift_by_layer={l: drift[l] for l in at},
                    logits_drift=share(lk, lp))

    def step_check_mid_run(engine, requests, label, prelude=None):
        """``step_vs_plain`` on a paged engine, from its state one
        megastep into serving ``requests`` (after ``prelude(engine)``),
        with every slot active: a drained engine's idle slots keep stale
        table rows that may name one block twice, where a step that
        writes every row would race. Then serves the requests to the
        end."""
        engine.reset()
        if prelude is not None:
            prelude(engine)
        for r in requests:
            engine.submit(r)
        engine.step()
        check(all(r is not None for r in engine.active),
              f"{label}: a slot is idle at the decode-step check")
        out = step_vs_plain(engine, label)
        engine.run()
        return out

    def ffn_launches(engine, n, heads, tokens):
        """The linears' and SwiGLU's launches over n layer passes of
        ``tokens`` tokens and ``heads`` unembeddings (the MoE kernels of
        an MoE config in place of the FFN's): with quantized weights three
        quant_matmul (wqkv, wo, w_down) and the gate-up GEMM with its
        SwiGLU a layer, and one quant_matmul an unembedding by an untied
        (quantized) ``lm_head``; with plain weights the linears and the
        head are library products and the SwiGLU runs alone. The unfused
        V0 has seven linears a layer (wq, wk, wv, wo, w_gate, w_up,
        w_down) and the standalone SwiGLU under any weights. A tied head
        is the embedding table's transpose, always a library product."""
        quantized = engine.quant_policy in ("q8_0", "q4_0")
        head = heads * (not engine.cfg.tie_embeddings)
        if engine.cfg.is_moe:
            # bf16 weights: library linears; a layer pass routes, runs the
            # two grouped GEMMs (again for the shared experts as one group)
            # and combines; at a capacity within the 16-row tile (decode)
            # the routed down GEMM and the combine are moe_down_combine
            shared = n * bool(engine.cfg.num_shared_experts)
            fused = moe_kernels.moe_down_combined(
                moe_mod.capacity(engine.cfg, tokens))
            return {"quant_matmul": 0, "quant_matmul_swiglu": 0,
                    "swiglu": 0, "moe_route": n,
                    "moe_gate_up_swiglu": n + shared,
                    "moe_down": shared + (0 if fused else n),
                    "moe_combine": 0 if fused else n,
                    "moe_down_combine": n if fused else 0}
        # the unfused V0: wq, wk and wv, and w_gate and w_up, each its own
        # GEMM, and the standalone SwiGLU whatever the weights
        qkv = 1 if engine.cfg.fuse_qkv else 3
        fused_gu = engine.cfg.fuse_gate_up
        linears = qkv + 2 + (0 if fused_gu else 2)
        return {"quant_matmul": linears * n + head if quantized else 0,
                "quant_matmul_swiglu": n if quantized and fused_gu else 0,
                "swiglu": 0 if quantized and fused_gu else n,
                "moe_route": 0,
                "moe_gate_up_swiglu": 0, "moe_down": 0, "moe_combine": 0,
                "moe_down_combine": 0}

    def every_kernel(launches):
        """``launches`` with every other kernel of ``ops.KERNELS`` at 0."""
        return {**dict.fromkeys(ops.launch_counts(), 0), **launches}

    def ssm_launches(engine, n, norms, prefill):
        """An SSM config's launches over n layer passes: the conv and the
        scan (prefill) or the conv and state update in one launch
        (decode, ``ssm_decode_step``; the conv alone never runs there),
        the gated norm and the residual add + norm a layer,
        ``in_proj`` and ``out_proj`` through quant_matmul under quantized
        weights (library products under bf16, as is the tied head), and
        ``norms`` RMSNorms alone."""
        quantized = engine.quant_policy in ("q8_0", "q4_0")
        return every_kernel({
            "rmsnorm": norms, "add_rmsnorm": n,
            "ssm_conv": n if prefill else 0,
            "gated_rmsnorm": n, "quant_matmul": 2 * n if quantized else 0,
            "ssm_decode_step": 0 if prefill else n,
            "ssd_prefill": n if prefill else 0})

    def hybrid_launches(engine, n, norms, prefill):
        """A hybrid config's launches over n passes of each layer: an
        RG-LRU layer runs the conv, the gate products (wa, wx) and the
        RG-LRU scan (prefill) or decode step; an attention layer the RoPE
        + cache write and the attention (prefill: the prefill kernels);
        every layer two residual add + norms and the gate-up GEMM with its
        GeGLU; under quantized weights in_proj, wa, wx, out_proj and w_down
        (RG-LRU) or wqkv, wo and w_down (attention) through quant_matmul
        and the gate-up through quant_matmul_swiglu (under bf16 library
        products and the standalone GeGLU); ``norms`` RMSNorms alone."""
        quantized = engine.quant_policy in ("q8_0", "q4_0")
        kinds = engine.model.kinds
        r, a = n * kinds.count("rglru"), n * kinds.count("attn")
        return every_kernel({
            "rmsnorm": norms, "add_rmsnorm": 2 * (r + a),
            "quant_matmul": 5 * r + 3 * a if quantized else 0,
            "quant_matmul_swiglu": r + a if quantized else 0,
            "geglu": 0 if quantized else r + a,
            "ssm_conv": r,
            "rglru_scan": r if prefill else 0,
            "rglru_decode_step": 0 if prefill else r,
            "rope_cache_write": 0 if prefill else a,
            "decode_attention": 0 if prefill else a,
            "rope_cache_write_prefill": a if prefill else 0,
            "flash_attention": a if prefill else 0})

    def per_megastep(engine):
        """Kernel launches of one megastep: K substeps of one attention,
        one RoPE + cache write, the linears and SwiGLU, and two residual
        adds with the RMSNorm after them per layer, and layer 0's
        RMSNorm alone (the final norm is the last layer's second
        add_rmsnorm), from the config's depth and head (an SSM config:
        ``ssm_launches``)."""
        L, K = engine.cfg.num_layers, engine.megastep_k
        if engine.cfg.arch_type == "hybrid":
            return hybrid_launches(engine, K, K, prefill=False)
        if engine.cfg.is_recurrent:
            return ssm_launches(engine, L * K, K, prefill=False)
        quant_cache = engine.kv_quant != "bf16"
        return every_kernel({
            "decode_attention": 0 if quant_cache else L * K,
            "decode_attention_quant": L * K if quant_cache else 0,
            **ffn_launches(engine, L * K, K, engine.slots),
            "flash_attention": 0,
            "rmsnorm": K, "add_rmsnorm": 2 * L * K,
            "rope_cache_write": L * K, "rope_cache_write_prefill": 0})

    def per_prefill(engine):
        """Kernel launches of one prefill call (eager). An MoE stall
        prefill here is a bucket of 512 positions or more, past the
        16-row tile: the down GEMM and the combine apart."""
        L = engine.cfg.num_layers
        if engine.cfg.arch_type == "hybrid":
            return hybrid_launches(engine, 1, 1, prefill=True)
        if engine.cfg.is_recurrent:
            return ssm_launches(engine, L, 1, prefill=True)
        return every_kernel({
            "decode_attention": 0, "decode_attention_quant": 0,
            **ffn_launches(engine, L, 1, 512), "flash_attention": L,
            "rmsnorm": 1, "add_rmsnorm": 2 * L,
            "rope_cache_write": 0, "rope_cache_write_prefill": L})

    def check_served(engine, requests, label, warm, after_warm):
        """Outputs complete and in range, and the launch counts under
        graphs. The counters were zeroed before the path's warmup
        request (stats ``warm``, counters ``after_warm`` at its end).
        Every megastep is one graph replay; each capture enqueued exactly
        one megastep's launches; the counters hold, for each capture, its
        eager warmup run and the capture itself, plus each prefill call's
        eager launches, and across the timed run they moved by the
        prefill calls alone: no decode kernel launched outside a replay.
        Returns the kernels' device launches over the path: warmup runs,
        replays times one megastep's launches, and prefill calls."""
        st = engine.stats
        for r in requests:
            check(r.done and r.error is None,
                  f"{label}: request {r.uid} not done ({r.error})")
            check(len(r.output) == r.max_new_tokens,
                  f"{label}: request {r.uid} got {len(r.output)} tokens")
            check(all(0 <= t < engine.cfg.vocab_size for t in r.output),
                  f"{label}: token id out of range")
        for name, stats in (("warmup", warm), ("timed run", st)):
            check(stats.graph_replays == stats.megasteps > 0,
                  f"{label}: {stats.graph_replays} graph replays for the "
                  f"{name}'s {stats.megasteps} megasteps")
        check(st.graph_captures == 0, f"{label}: the timed run captured "
              f"{st.graph_captures} graphs (all belong in the warmup)")
        captures = warm.graph_captures
        check(1 <= captures <= 2 and captures == len(engine.graph_launches),
              f"{label}: {captures} captures, graphs "
              f"{sorted(engine.graph_launches)}")
        per, pre = per_megastep(engine), per_prefill(engine)
        for greedy, got in engine.graph_launches.items():
            which = "greedy" if greedy else "sampling"
            check(got == per, f"{label}: the {which} graph's capture "
                  f"enqueued {got}, not {per}")
        counted = ops.launch_counts()
        batches = warm.prefill_batches + st.prefill_batches
        want = {k: 2 * captures * per[k] + batches * pre[k] for k in per}
        check(counted == want, f"{label}: launch counters {counted} != "
              f"expected {want}")
        moved = {k: counted[k] - after_warm[k] for k in per}
        want_moved = {k: st.prefill_batches * pre[k] for k in per}
        check(moved == want_moved, f"{label}: across the timed run the "
              f"counters moved by {moved}, not by the prefill calls' "
              f"{want_moved}")
        replays = warm.graph_replays + st.graph_replays
        device = {k: (captures + replays) * per[k] + batches * pre[k]
                  for k in per}
        print(f"  {label}: {st.megasteps} megasteps = {st.graph_replays} "
              f"graph replays ({warm.graph_replays} more in the warmup, "
              f"{captures} captures); one megastep enqueues {per}; device "
              f"launches {device} with {batches} prefill calls", flush=True)
        return device

    # -- 4. main path ---------------------------------------------------------
    print("main path: llama3.2-1b full width, q8_0 weights, bf16 cache",
          flush=True)
    zero_counts()
    torch.cuda.synchronize()
    with kernels_only():
        res = serve.main(["--arch", "llama3.2-1b", "--no-reduced",
                          "--precision", "q8_0", "--kv-quant", "bf16",
                          "--slots", "4", "--max-len", "1024",
                          "--megastep-k", "8", "--requests", "8",
                          "--max-new", "32", "--temperature", "0",
                          "--device", "cuda"])
    torch.cuda.synchronize()
    eng = res.engine
    main_counts = check_served(eng, res.requests, "main path",
                               res.warmup_stats, res.launches_after_warmup)
    st = eng.stats
    tok_s = st.tokens_generated / st.decode_wall_s
    ms_step = 1e3 * st.decode_wall_s / st.steps
    print(f"  main path: {st.tokens_generated} tokens, {tok_s:.1f} tok/s, "
          f"{ms_step:.3f} ms per decode step ({st.steps} steps, "
          f"{st.megasteps} megasteps), peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    for r in res.requests[:2]:
        ref = eng.model.reference_decode(eng.params, r.prompt,
                                         r.max_new_tokens, max_len=1024)
        check(ref == r.output, f"main path: request {r.uid} engine stream "
              f"differs from reference_decode")
    print("  main path: engine streams == Model.reference_decode (2 "
          "requests)", flush=True)
    main_path = dict(tok_s=tok_s, ms_per_step=ms_step,
                     tokens=st.tokens_generated, steps=st.steps)
    main_path.update(step_vs_plain(eng, "main path"))
    prof, replay = profile_served(
        eng, lambda: serve.make_requests(eng.cfg.vocab_size, 8, 32, seed=0))
    main_path.update(prof)
    main_graph_launches = dict(eng.graph_launches)
    main_streams = [r.output for r in res.requests]
    check([r.output for r in replay] == main_streams,
          "main path: the profiled replay served other tokens")
    del eng, res
    torch.cuda.empty_cache()

    # -- 4b. the main path with --prefill-chunk 4, and the unfused V0 ------
    v0_counts = {}     # launches on these legs, into ``counts`` below

    def warmed_engine(model, params, **kw):
        """A 4-slot engine (max_len 1024, K 8, greedy; ``kw`` overrides),
        the counters zeroed before a warmup request like launch.serve's,
        which captures its graph; (engine, warmup stats, counters after
        the warmup)."""
        eng = ServingEngine(model, params, **{
            **dict(slots=4, max_len=1024, sampling=SamplingConfig(),
                   megastep_k=8), **kw})
        zero_counts()
        eng.submit(Request(uid=-1, prompt=np.arange(1, 6, dtype=np.int32),
                           max_new_tokens=32))
        eng.run()
        warm, after = eng.stats, ops.launch_counts()
        eng.reset()
        return eng, warm, after

    def served_ms(eng):
        st = eng.stats
        return dict(ms_per_step=1e3 * st.decode_wall_s / st.steps,
                    tok_s=st.tokens_generated / st.decode_wall_s,
                    steps=st.steps, megasteps=st.megasteps)

    def as_v0(params, cfg):
        """A fused (V1) tree with each fused weight cut by columns into
        V0's projections (exact: a quantized weight's groups run along
        K)."""
        def cut(w, widths):
            out, at = [], 0
            for n in widths:
                if isinstance(w, QuantizedTensor):
                    out.append(QuantizedTensor(
                        w.data[:, at:at + n].contiguous(),
                        w.scales[:, at:at + n].contiguous(), w.fmt, w.group))
                else:
                    out.append(w[:, at:at + n].contiguous())
                at += n
            return out
        layers_v0 = []
        for p_l in params["layers"]:
            a, m = dict(p_l["attn"]), dict(p_l["mlp"])
            ws = cut(a.pop("wqkv")["w"], (cfg.q_dim, cfg.kv_dim, cfg.kv_dim))
            a.update({n: {"w": w} for n, w in zip(("wq", "wk", "wv"), ws)})
            g_, u_ = cut(m.pop("w_gate_up")["w"], (cfg.d_ff, cfg.d_ff))
            m.update(w_gate={"w": g_}, w_up={"w": u_})
            layers_v0.append({**p_l, "attn": a, "mlp": m})
        return {**params, "layers": layers_v0}

    t_leg = time.perf_counter()
    print("main path with --prefill-chunk 4 (under K 8: a prefilling slot "
          "whose chunk runs dry waits, cache frozen, for the refill)",
          flush=True)
    zero_counts()
    with kernels_only():
        res = serve.main(["--arch", "llama3.2-1b", "--no-reduced",
                          "--precision", "q8_0", "--kv-quant", "bf16",
                          "--slots", "4", "--max-len", "1024",
                          "--megastep-k", "8", "--requests", "8",
                          "--max-new", "32", "--temperature", "0",
                          "--prefill-chunk", "4", "--device", "cuda"])
    torch.cuda.synchronize()
    eng = res.engine
    label = "main path, prefill chunk 4"
    v0_counts["chunk 4"] = check_served(eng, res.requests, label,
                                        res.warmup_stats,
                                        res.launches_after_warmup)
    want_refills = sum(-(-len(r.prompt) // 4) - 1 for r in res.requests)
    check(eng.prefill_chunk == 4
          and eng.stats.chunk_refills == want_refills > 0,
          f"{label}: {eng.stats.chunk_refills} chunk refills, the prompts "
          f"predict {want_refills}")
    check(dict(eng.graph_launches) == main_graph_launches,
          f"{label}: a capture enqueued {eng.graph_launches}, the main "
          f"path's {main_graph_launches}")
    for r in res.requests:
        check(r.output == eng.model.reference_decode(
            eng.params, r.prompt, r.max_new_tokens, max_len=1024),
            f"{label}: request {r.uid} differs from reference_decode")
    check([r.output for r in res.requests] == main_streams,
          f"{label}: streams differ from the main path's (chunk 16)")
    chunk_leg = dict(served_ms(eng), chunk_refills=eng.stats.chunk_refills,
                     want_refills=want_refills)
    prof, replay = profile_served(
        eng, lambda: serve.make_requests(eng.cfg.vocab_size, 8, 32, seed=0))
    check(prof["events_per_megastep"] == main_path["events_per_megastep"],
          f"{label}: {prof['events_per_megastep']} CUDA events a megastep, "
          f"the main path's {main_path['events_per_megastep']}")
    check([r.output for r in replay] == main_streams,
          f"{label}: the profiled replay served other tokens")
    chunk_leg.update(prof, leg_s=time.perf_counter() - t_leg)
    print(f"  {label}: {chunk_leg['chunk_refills']} chunk refills as the "
          f"prompts predict; streams == reference_decode and the main "
          f"path's; {chunk_leg['ms_per_step']:.3f} ms a step "
          f"({chunk_leg['steps']} steps, {chunk_leg['megasteps']} "
          f"megasteps; the main path {main_path['steps']} steps); "
          f"{prof['events_per_megastep']} CUDA events a megastep as the "
          f"main path's; {chunk_leg['leg_s']:.1f} s", flush=True)
    del eng, res
    torch.cuda.empty_cache()

    t_leg = time.perf_counter()
    print("V0 main path: llama3.2-1b at full width, scheduler_version v0 "
          "(wq / wk / wv and w_gate / w_up apart, the standalone SwiGLU), "
          "q8_0 weights, bf16 cache", flush=True)
    cfg_v0 = get_config("llama3.2-1b", scheduler_version="v0",
                        quant_policy="q8_0")
    model_v0 = Model(cfg_v0, device=dev)
    g_v = torch.Generator(device=dev)
    g_v.manual_seed(0)
    params_v0 = model_v0.init(g_v)
    p0 = params_v0["layers"][0]
    check(not cfg_v0.fuse_qkv and not cfg_v0.fuse_gate_up
          and set(p0["attn"]) == {"wq", "wk", "wv", "wo"}
          and set(p0["mlp"]) == {"w_gate", "w_up", "w_down"}
          and isinstance(p0["mlp"]["w_up"]["w"], QuantizedTensor),
          "V0: the params are not the unfused projections")
    eng0, warm, after = warmed_engine(model_v0, params_v0,
                                      quant_policy="q8_0")
    reqs = serve.make_requests(cfg_v0.vocab_size, 8, 32, seed=0)
    for r in reqs:
        eng0.submit(r)
    with kernels_only(quantized=False):
        eng0.run()
    torch.cuda.synchronize()
    label = "V0 main path"
    v0_counts["v0 main"] = check_served(eng0, reqs, label, warm, after)
    for r in reqs:
        check(r.output == model_v0.reference_decode(
            params_v0, r.prompt, r.max_new_tokens, max_len=1024),
            f"{label}: request {r.uid} differs from reference_decode")
    v0_main = served_ms(eng0)
    v0_main.update(step_vs_plain(eng0, label))
    prof, replay = profile_served(
        eng0, lambda: serve.make_requests(cfg_v0.vocab_size, 8, 32, seed=0))
    check([r.output for r in replay] == [r.output for r in reqs],
          f"{label}: the profiled replay served other tokens")
    check(prof["copy_kernels_per_megastep"]
          == main_path["copy_kernels_per_megastep"],
          f"{label}: {prof['copy_kernels_per_megastep']} copy kernels a "
          f"megastep, the fused main path's "
          f"{main_path['copy_kernels_per_megastep']}")
    v0_main.update(prof)
    print(f"  {label}: streams == reference_decode (8 requests); "
          f"{v0_main['ms_per_step']:.3f} ms a step; "
          f"{prof['events_per_megastep']} CUDA events a megastep (fused "
          f"{main_path['events_per_megastep']}), "
          f"{prof['copy_kernels_per_megastep']:.0f} copy kernels a "
          "megastep as the fused path's", flush=True)
    # V0 and V1 served in turns on one card (V1: the main path's model and
    # weights, as launch.serve draws them)
    model_v1 = Model(get_config("llama3.2-1b", quant_policy="q8_0"),
                     device=dev)
    g_v.manual_seed(0)
    eng1 = warmed_engine(model_v1, model_v1.init(g_v),
                         quant_policy="q8_0")[0]

    def turn(e):
        e.reset()
        for r in serve.make_requests(cfg_v0.vocab_size, 8, 32, seed=0):
            e.submit(r)
        e.run()
        torch.cuda.synchronize()
        return served_ms(e)["ms_per_step"]
    turns = [(w, turn(eng1 if w == "v1" else eng0))
             for w in ("v1", "v0", "v0", "v1", "v1", "v0", "v0", "v1")]
    v0_runs = [ms for w, ms in turns if w == "v0"]
    v1_runs = [ms for w, ms in turns if w == "v1"]
    v0_main.update(turns=turns, v0_median_ms=float(np.median(v0_runs)),
                   v1_median_ms=float(np.median(v1_runs)))
    print(f"  V0 / V1 ms a step in turns (v1 v0 v0 v1 v1 v0 v0 v1): "
          + ", ".join(f"{w} {ms:.3f}" for w, ms in turns)
          + f"; medians V0 {v0_main['v0_median_ms']:.3f}, V1 "
          f"{v0_main['v1_median_ms']:.3f}, V1 / V0 tok/s "
          f"{v0_main['v0_median_ms'] / v0_main['v1_median_ms']:.3f}",
          flush=True)
    del eng1, model_v1
    # V0 under stall admission: one 4 x 512 prefill (the unfused
    # projections at M 2048)
    eng0s, warm, after = warmed_engine(model_v0, params_v0,
                                       quant_policy="q8_0",
                                       admission="stall")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg_v0.vocab_size, n).astype(np.int32)
               for n in PREFILL_PROMPTS[:4]]
    reqs = [Request(uid=i, prompt=p_, max_new_tokens=8)
            for i, p_ in enumerate(prompts)]
    for r in reqs:
        eng0s.submit(r)
    with kernels_only(quantized=False):
        eng0s.run()
    torch.cuda.synchronize()
    label = "V0 stall leg (4 x 512)"
    v0_counts["v0 stall"] = check_served(eng0s, reqs, label, warm, after)
    check(eng0s.stats.prefill_batches == 1, f"{label}: "
          f"{eng0s.stats.prefill_batches} prefill calls, not one bucket")
    for r in (reqs[0], reqs[3]):
        check(r.output == model_v0.reference_decode(
            params_v0, r.prompt, 8, max_len=1024, stepwise_prefill=False),
            f"{label}: request {r.uid} differs from "
            "reference_decode(stepwise_prefill=False)")
    v0_main["stall"] = prefill_vs_plain(eng0s, list(PREFILL_PROMPTS[:4]),
                                        label, seeds=1)
    v0_main["legs_s"] = time.perf_counter() - t_leg
    print(f"  {label}: one prefill call, streams == reference_decode("
          f"stepwise_prefill=False) (requests 0, 3); the V0 legs took "
          f"{v0_main['legs_s']:.1f} s", flush=True)
    del eng0, eng0s, model_v0, params_v0, p0
    torch.cuda.empty_cache()

    def serving_under_load():
        """Phase 5: the pipelined main path, cancel, preemption with
        resume, seeded fault schedules and the asyncio front-end."""
        from repro_torch.launch.serve import (AsyncServingFrontend,
                                              Backpressure, DeadlineExceeded)
        from repro_torch.serving import (FaultInjector, FaultSchedule,
                                         InfeasibleDeadline, QueueFull)
        print("serving under load: llama3.2-1b full width, q8_0 weights, "
              "bf16 cache, pipeline depth 2", flush=True)
        out = {}
        zero_counts()
        with kernels_only():
            res2 = serve.main(["--arch", "llama3.2-1b", "--no-reduced",
                               "--precision", "q8_0", "--kv-quant", "bf16",
                               "--slots", "4", "--max-len", "1024",
                               "--megastep-k", "8", "--requests", "8",
                               "--max-new", "32", "--temperature", "0",
                               "--device", "cuda", "--pipeline-depth", "2"])
        torch.cuda.synchronize()
        eng = res2.engine
        out["launches"] = check_served(
            eng, res2.requests, "pipelined main path", res2.warmup_stats,
            res2.launches_after_warmup)
        check(eng.graph_launches == main_graph_launches,
              f"pipelined main path: the capture enqueued "
              f"{eng.graph_launches}, the main path's {main_graph_launches}")
        # the depth-1 streams were held to reference_decode above
        check([r.output for r in res2.requests] == main_streams,
              "pipelined main path: depth-2 streams differ from depth 1's")
        print("  pipelined main path: streams == the depth-1 run's (8 "
              "requests) and so reference_decode's (requests 0, 1)",
              flush=True)

        def timed_run(depth):
            eng.reset()
            eng.pipeline_depth = depth
            reqs = serve.make_requests(eng.cfg.vocab_size, 8, 32, seed=0)
            for r in reqs:
                eng.submit(r)
            with kernels_only(), no_stream_sync():
                eng.run()
            torch.cuda.synchronize()
            check([r.output for r in reqs] == main_streams,
                  f"depth {depth}: streams differ from the main path's")
            st = eng.stats
            return dict(depth=depth, ms_per_step=1e3 * st.decode_wall_s
                        / st.steps, tok_s=st.tokens_generated
                        / st.decode_wall_s, decode_wall_s=st.decode_wall_s,
                        drain_wait_s=st.drain_wait_s,
                        stage_wall_s=st.stage_wall_s,
                        megasteps=st.megasteps, steps=st.steps)

        turns = [timed_run(d) for d in (1, 2, 2, 1)]
        for t in turns:
            print(f"  depth {t['depth']}: {t['ms_per_step']:.4f} ms per "
                  f"decode step, {t['tok_s']:.1f} tok/s, {t['megasteps']} "
                  f"megasteps, drain_wait_s {t['drain_wait_s']:.6f}, "
                  f"stage_wall_s {t['stage_wall_s']:.6f} of "
                  f"{t['decode_wall_s']:.6f} s in step()", flush=True)
        print("  no stream-wide or device-wide synchronize in any served "
              "step (depth 1 and 2)", flush=True)
        out["turns"] = turns
        eng.pipeline_depth = 2
        prof, replay = profile_served(
            eng, lambda: serve.make_requests(eng.cfg.vocab_size, 8, 32,
                                             seed=0))
        check([r.output for r in replay] == main_streams,
              "pipelined main path: the profiled run served other tokens")
        out["profile_depth2"] = prof
        print(f"  device idle share: depth 2 {prof['device_idle_share']:.4f}"
              f", depth 1 {main_path['device_idle_share']:.4f} (main path, "
              "this run)", flush=True)
        model, params = eng.model, eng.params

        def reference(prompt, n):
            return model.reference_decode(params, prompt, n, max_len=1024)

        # cancel, on the paged path's prefix-cache engine at depth 2
        cancel_eng = ServingEngine(model, params, slots=4, max_len=1024,
                                   sampling=SamplingConfig(), megastep_k=8,
                                   quant_policy="q8_0", page_size=PAGE,
                                   prefix_cache=True, pipeline_depth=2)
        system = np.random.default_rng(3).integers(
            1, cfg_full.vocab_size, 256).astype(np.int32)
        with kernels_only():
            out["cancel"] = cancel_leg(cancel_eng, Request, system,
                                       reference)
        del cancel_eng
        # the front-end, on the pipelined engine
        eng.reset()
        eng.pipeline_depth = 2
        prompts = [r.prompt for r in serve.make_requests(
            eng.cfg.vocab_size, 8, 32, seed=0)]
        with kernels_only():
            out["frontend"] = asyncio.run(frontend_leg(
                eng, AsyncServingFrontend, DeadlineExceeded, Backpressure,
                prompts, main_streams))
        print(f"  front-end (depth 2, step in the executor thread): 8 "
              f"staggered requests streamed == futures == engine.run's; a "
              f"0.1 s deadline raised DeadlineExceeded after "
              f"{out['frontend']['partial_tokens']} tokens (a prefix of the "
              f"stream) and the next request was served; a burst at "
              f"max_queue 2 shed {out['frontend']['burst_shed']} with "
              f"Backpressure", flush=True)
        # seeded fault schedules, 4 layers: dense and paged bf16 caches and
        # a dense q8_0 cache, at depth 1 and 2
        cfg4 = dataclasses.replace(cfg_full,
                                   num_layers=MAIN_LAYERS_SECOND_PATH)
        model4f = Model(cfg4, device=dev)
        gen_load = torch.Generator(device=dev)     # leaves `gen` alone
        gen_load.manual_seed(5)
        params4q = quantize_tree(model4f.init(gen_load, quantize=False),
                                 "q4_0", cfg4.quant_group)

        def reference4(prompt, n):
            return model4f.reference_decode(params4q, prompt, n,
                                            max_len=1024)
        legs = []
        for kvq, paged, seeds, depths in (
                ("bf16", False, (58, 31, 62), (1, 2)),
                ("bf16", True, (58, 31, 62), (1, 2)),
                ("q8_0", False, (58,), (2,))):
            fe = ServingEngine(model4f, params4q, slots=3, max_len=1024,
                               sampling=SamplingConfig(), megastep_k=8,
                               quant_policy="q4_0", kv_quant=kvq,
                               page_size=PAGE if paged else 0,
                               cache_blocks=7 if paged else 0)
            for seed in seeds:
                for depth in depths:
                    fe.pipeline_depth = depth
                    with kernels_only():
                        legs.append(fault_leg(fe, Request, FaultInjector,
                                              FaultSchedule, seed,
                                              reference4))
            if not paged and kvq == "bf16":
                with kernels_only():
                    out["capture_in_flight"] = capture_in_flight_leg(
                        fe, Request, reference4)
            del fe
        poisoned = sum(leg["poisoned"] for leg in legs)
        preempted = sum(leg["preemptions"] for leg in legs)
        check(poisoned > 0 and preempted > 0,
              f"fault legs: {poisoned} poisoned, {preempted} preemptions")
        for leg in legs:
            print(f"  {leg['label']}: {leg['requests']} requests, "
                  f"{leg['kinds']}: {leg['poisoned']} poisoned (clean "
                  f"prefixes), {leg['preemptions']} preemptions, "
                  f"{leg['retries']} retries; survivors == reference_decode,"
                  " audit() after every step, pool recovered", flush=True)
        out["faults"] = dict(legs=len(legs), poisoned=poisoned,
                             preemptions=preempted)
        del model4f, params4q
        # preemption and resume, chunked and stall
        for admission in ("chunked", "stall"):
            pre = ServingEngine(model, params, slots=2, max_len=1024,
                                sampling=SamplingConfig(), megastep_k=8,
                                quant_policy="q8_0", page_size=PAGE,
                                cache_blocks=5, admission=admission)
            with kernels_only():
                out[f"preemption_{admission}"] = preemption_leg(
                    pre, Request, QueueFull, InfeasibleDeadline,
                    lambda p, n, **kw: model.reference_decode(
                        params, p, n, max_len=1024, **kw))
            del pre
        # a stall resume past max_len (the ring write), dense and paged
        for page in (0, PAGE):
            rp = ServingEngine(model, params, slots=2, max_len=64,
                               sampling=SamplingConfig(), megastep_k=8,
                               quant_policy="q8_0", page_size=page,
                               admission="stall")
            with kernels_only():
                out[f"resume_past_max_len_{'paged' if page else 'dense'}"] = \
                    resume_past_max_len_leg(
                        rp, Request, lambda p, n, **kw: model.reference_decode(
                            params, p, n, max_len=64, **kw))
            del rp
        del eng, res2, model, params
        return out

    # -- 10. the mixture-of-experts family (run right after the main path)
    moe_counts = {}    # launches on the MoE paths, into ``counts`` below
    moe_arch = "phi3.5-moe-42b-a6.6b"
    moe_cut = MOE_LAYERS

    def moe_floor_line(label, floor):
        print(f"  {label}: floor {floor['ms']:.3f} ms a step for the "
              f"{floor['experts_a_layer']:.2f} experts a layer the routing "
              f"read (mean of {floor['moe_layer_passes']} layer passes) plus "
              f"attention, norms, router and head "
              f"({floor['bytes'] / 1e9:.3f} GB); every expert: "
              f"{floor['all_experts_ms']:.3f} ms "
              f"({floor['all_experts_bytes'] / 1e9:.3f} GB)", flush=True)

    def moe_served(slots, extra=()):
        """phi3.5-moe at full width and MOE_LAYERS layers, bf16 weights and
        cache, served by ``launch.serve`` with the main path's traffic on
        ``slots`` slots (8 requests; 1 alone on 1 slot)."""
        zero_counts()
        torch.cuda.synchronize()
        with kernels_only(quantized=False):
            res = serve.main([
                "--arch", moe_arch, "--no-reduced", "--num-layers",
                str(moe_cut), "--precision", "bf16", "--kv-quant", "bf16",
                "--slots", str(slots), "--max-len", "1024", "--megastep-k",
                "8", "--requests", "8" if slots == 4 else "1", "--max-new",
                "32", "--temperature", "0", "--device", "cuda", *extra])
        torch.cuda.synchronize()
        return res

    def moe_leg(eng, label, key, reqs, warm_reqs):
        """Serve ``reqs`` on a (fresh) engine after a warmup that
        captures its graph; launch counts into ``counts[key]``."""
        zero_counts()
        for r in warm_reqs:
            eng.submit(r)
        eng.run()
        warm, after_warm = eng.stats, ops.launch_counts()
        eng.reset()
        for r in reqs:
            eng.submit(r)
        t0 = time.perf_counter()
        with kernels_only(quantized=False):
            eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        moe_counts[key] = check_served(eng, reqs, label, warm, after_warm)
        return wall

    def profile_prefill_calls(eng, reqs, label):
        """The requests served again by the (reset) engine with each of its
        prefill calls under the profiler: [(the call's bucket length,
        device ms by kernel group, the call's wall ms)], in call order. The
        engine is left as it was."""
        calls = []
        impl = eng._prefill_impl

        def profiled(*args):
            groups = dict.fromkeys(GROUPS, 0.0)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                first = impl(*args)
                torch.cuda.synchronize()
                wall = 1e3 * (time.perf_counter() - t0)
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    groups[group_of(e.name)] += e.time_range.elapsed_us() / 1e3
            calls.append((int(args[0].shape[1]), groups, wall))
            return first

        eng.reset()
        eng._prefill_impl = profiled
        try:
            replay = [Request(uid=r.uid, prompt=r.prompt,
                              max_new_tokens=r.max_new_tokens) for r in reqs]
            for r in replay:
                eng.submit(r)
            eng.run()
        finally:
            del eng._prefill_impl           # the class's method again
        check([r.output for r in replay] == [r.output for r in reqs],
              f"{label}: the profiled replay served other tokens")
        return calls

    def profile_prefill_call(eng, reqs, label):
        """``profile_prefill_calls`` of requests served in one prefill call:
        (device ms by kernel group, the call's wall ms)."""
        calls = profile_prefill_calls(eng, reqs, label)
        check(len(calls) == 1, f"{label}: {len(calls)} prefill calls in "
              "the profiled replay, not one")
        return calls[0][1], calls[0][2]

    def moe_phase():
        t_phase = time.perf_counter()
        out = dict(kernel_cases_s=moe_kernel_s,
                   library_router_row_alone_equal=dict(lib_rows))
        print(f"MoE path: {moe_arch} at full width, {moe_cut} of 32 layers, "
              "bf16 weights and cache (served by launch.serve)", flush=True)
        t0 = time.perf_counter()
        res = moe_served(4)
        eng = res.engine
        label = f"MoE path ({moe_arch}, {moe_cut} layers, 4 slots)"
        moe_counts["moe"] = check_served(eng, res.requests, label,
                                     res.warmup_stats,
                                     res.launches_after_warmup)
        for r in res.requests:
            check(r.output == eng.model.reference_decode(
                eng.params, r.prompt, r.max_new_tokens, max_len=1024),
                f"{label}: request {r.uid} differs from reference_decode")
        st = eng.stats
        out["slots4"] = dict(ms_per_step=1e3 * st.decode_wall_s / st.steps,
                             tok_s=st.tokens_generated / st.decode_wall_s,
                             steps=st.steps, tokens=st.tokens_generated,
                             floor=res.floor,
                             peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        print(f"  {label}: {out['slots4']['ms_per_step']:.3f} ms a step, "
              f"{out['slots4']['tok_s']:.1f} tok/s; streams == "
              "reference_decode (8 requests); peak memory "
              f"{out['slots4']['peak_gb']:.2f} GB", flush=True)
        moe_floor_line(label, res.floor)
        out["slots4"].update(step_vs_plain(eng, label))
        main_reqs = lambda: serve.make_requests(eng.cfg.vocab_size, 8, 32,
                                                seed=0)
        # the profile serves the first 4 requests' first 16 tokens, three
        # megasteps of ~2900 events (run last in the script, all five
        # traces of the ten-megastep run lost 9 events on the H100); no
        # pair drops at 4 slots, so the streams are prefixes
        prof, replay = profile_served(eng, lambda: serve.make_requests(
            eng.cfg.vocab_size, 4, 16, seed=0))
        check([r.output for r in replay] ==
              [r.output[:16] for r in res.requests[:4]],
              f"{label}: the profiled replay served other tokens")
        g = prof["device_ms_per_step_by_group"]
        moe_ms = (g["moe_route"] + g["moe_gemm"] + g["moe_combine"]
                  + g["moe_down_combine"])
        print(f"  {label}: device ms a step in the MoE kernels {moe_ms:.3f}"
              f" (route {g['moe_route']:.3f}, grouped GEMMs "
              f"{g['moe_gemm']:.3f}, the down sums + combine "
              f"{g['moe_down_combine']:.3f}, combine alone "
              f"{g['moe_combine']:.3f}) of "
              f"{prof['device_ms_per_step']:.3f}; device idle share "
              f"{prof['device_idle_share']:.3f}", flush=True)
        out["slots4"].update(prof, moe_device_ms_per_step=moe_ms)
        model, params = eng.model, eng.params
        streams = [r.output for r in res.requests]
        dense = eng

        # stall admission: one 4 x 512 bucket
        label = f"MoE stall leg ({moe_cut} layers, one 4 x 512 bucket)"
        seng = ServingEngine(model, params, slots=4, max_len=1024,
                             sampling=SamplingConfig(), megastep_k=8,
                             admission="stall")
        rng = np.random.default_rng(2)
        prompts = [rng.integers(1, model.cfg.vocab_size, n).astype(np.int32)
                   for n in PREFILL_PROMPTS[:4]]
        reqs = [Request(uid=i, prompt=p, max_new_tokens=8)
                for i, p in enumerate(prompts)]
        moe_leg(seng, label, "moe stall", reqs,
                [Request(uid=-1, prompt=prompts[0], max_new_tokens=2)])
        check(seng.stats.prefill_batches == 1, f"{label}: "
              f"{seng.stats.prefill_batches} prefill calls, not one bucket")
        # the bucket reference: Model.prefill of the same padded bucket and
        # seq_lens, its pairs' drops counted by the plain route on the same
        # logits, then greedy decode of the 4 rows together (4 rows <= C 8:
        # no decode step drops, so the rows do not touch)
        lens = [len(p) for p in prompts]
        S_b = seng._bucket_len(max(lens))
        toks = np.zeros((4, S_b), np.int32)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
        drops = []
        route = ops.moe_route

        def counting(x, w, K, C, reads=None):
            out = route(x, w, K, C, reads)
            drops.append(int((route_from_logits_plain(out[5], K, C)[2]
                              >= C).sum()))
            return out
        cache = model.init_cache(4, 1024)
        ops.moe_route = counting
        try:
            logits = model.prefill(params, torch.as_tensor(toks, device=dev)
                                   .long(), cache,
                                   seq_lens=torch.tensor(lens, device=dev))
        finally:
            ops.moe_route = route
        bucket_ref = [[int(t)] for t in logits.argmax(-1).tolist()]
        tok = logits.argmax(-1)[:, None]
        for _ in range(7):
            tok = model.decode_step(params, tok, cache).argmax(-1)[:, None]
            for i, t in enumerate(tok[:, 0].tolist()):
                bucket_ref[i].append(int(t))
        print(f"  {label}: pairs dropped in the bucket's prefill, by layer "
              f"(plain moe_route on the same logits): {drops}", flush=True)
        for r in reqs:
            check(r.output == bucket_ref[r.uid], f"{label}: request "
                  f"{r.uid} differs from the bucket reference")
            if not sum(drops):
                check(r.output == model.reference_decode(
                    params, r.prompt, 8, max_len=1024,
                    stepwise_prefill=False), f"{label}: request {r.uid} "
                    "differs from reference_decode(stepwise_prefill=False)")
        out["stall"] = dict(prefill_drops=drops, **prefill_vs_plain(
            seng, lens, label, seeds=1))
        print(f"  {label}: streams == the bucket reference"
              + ("" if sum(drops) else " and reference_decode("
                 "stepwise_prefill=False)"), flush=True)
        # where the bucket's one prefill call spends its device time: the
        # same requests again, that call under the profiler (card only)
        prefill_groups, prefill_wall = profile_prefill_call(seng, reqs, label)
        busy = sum(prefill_groups.values())
        check(prefill_groups["moe_gemm"] > 0.0, f"{label}: the prefill "
              "call's trace holds no grouped-GEMM kernel")
        print(f"  {label}: the 4 x 512 prefill call: device ms in the MoE "
              f"kernels {prefill_groups['moe_route'] + prefill_groups['moe_gemm'] + prefill_groups['moe_combine']:.3f}"
              f" (route {prefill_groups['moe_route']:.3f}, grouped GEMMs "
              f"{prefill_groups['moe_gemm']:.3f}, combine "
              f"{prefill_groups['moe_combine']:.3f}) of {busy:.3f} "
              f"(wall {prefill_wall:.3f} ms, device idle share "
              f"{1 - busy / prefill_wall:.3f}); by group "
              + ", ".join(f"{g} {ms:.3f}" for g, ms in prefill_groups.items()
                          if ms), flush=True)
        out["stall"].update(prefill_device_ms_by_group=prefill_groups,
                            prefill_device_ms=busy,
                            prefill_wall_ms=prefill_wall)
        del seng, cache

        # a q8_0 cache: streams == reference_decode of the same weights
        # over a q8_0 cache
        label = f"MoE q8_0-cache leg ({moe_cut} layers, 4 slots)"
        qeng = ServingEngine(model, params, slots=4, max_len=1024,
                             sampling=SamplingConfig(), megastep_k=8,
                             kv_quant="q8_0")
        reqs = main_reqs()
        moe_leg(qeng, label, "moe q8_0 cache", reqs,
                serve.make_requests(model.cfg.vocab_size, 1, 8, seed=9))
        for r in reqs:
            check(r.output == qeng.model.reference_decode(
                params, r.prompt, r.max_new_tokens, max_len=1024),
                f"{label}: request {r.uid} differs from reference_decode "
                "over a q8_0 cache")
        print(f"  {label}: streams == reference_decode over a q8_0 cache "
              "(8 requests)", flush=True)
        del qeng

        # paged with the prefix cache: streams == the dense engine's
        label = (f"MoE paged leg ({moe_cut} layers, page size {PAGE}, "
                 "prefix cache)")
        peng = ServingEngine(model, params, slots=4, max_len=1024,
                             sampling=SamplingConfig(), megastep_k=8,
                             page_size=PAGE, prefix_cache=True)
        shared_reqs = lambda: serve.make_requests(
            model.cfg.vocab_size, 8, 32, seed=0, shared_prefix=2 * PAGE + 1)
        reqs = shared_reqs()
        moe_leg(peng, label, "moe paged", reqs,
                serve.make_requests(model.cfg.vocab_size, 1, 8, seed=9))
        check(peng.stats.prefix_hits > 0, f"{label}: no prefix hit")
        dense.reset()
        dreqs = shared_reqs()
        for r in dreqs:
            dense.submit(r)
        dense.run()
        check([r.output for r in reqs] == [r.output for r in dreqs],
              f"{label}: streams differ from the dense engine's")
        print(f"  {label}: {peng.stats.prefix_hits} prefix hits; streams == "
              "the dense engine's (8 requests)", flush=True)
        del peng, dense, eng, res, model, params
        torch.cuda.empty_cache()
        out["served_s"] = time.perf_counter() - t0

        # quantized weights: refused before any weight is drawn
        try:
            serve.main(["--arch", moe_arch, "--no-reduced", "--precision",
                        "q8_0", "--device", "cuda"])
        except SystemExit as e:
            check("no quantized-weight path" in str(e),
                  f"quantized MoE weights: another error: {e}")
            print(f"  --precision q8_0: refused ({str(e)[:100]}...)",
                  flush=True)
        else:
            fail("launch.serve served quantized MoE weights")

        # the paper's single user: the first request alone on 1 slot
        res = moe_served(1)
        eng = res.engine
        label = f"MoE path alone ({moe_cut} layers, 1 slot)"
        moe_counts["moe alone"] = check_served(eng, res.requests, label,
                                           res.warmup_stats,
                                           res.launches_after_warmup)
        r = res.requests[0]
        check(r.output == streams[0] == eng.model.reference_decode(
            eng.params, r.prompt, r.max_new_tokens, max_len=1024),
            f"{label}: the stream differs from reference_decode")
        st = eng.stats
        out["slots1"] = dict(ms_per_step=1e3 * st.decode_wall_s / st.steps,
                             tok_s=st.tokens_generated / st.decode_wall_s,
                             steps=st.steps, tokens=st.tokens_generated,
                             floor=res.floor)
        print(f"  {label}: {out['slots1']['ms_per_step']:.3f} ms a step, "
              f"{out['slots1']['tok_s']:.1f} tok/s; stream == the 4-slot "
              "run's and reference_decode", flush=True)
        moe_floor_line(label, res.floor)
        del eng, res
        torch.cuda.empty_cache()
        out["phase_s"] = time.perf_counter() - t_phase
        print(f"MoE phase: {out['phase_s']:.1f} s ({out['served_s']:.1f} s "
              "serving the 4-slot path and its legs; the MoE kernel cases "
              f"took {out['kernel_cases_s']:.1f} s in phase 3)", flush=True)
        return out

    moe = moe_phase()

    # -- 12. the SSM family (run right after the MoE family) ---------------
    ssm_counts = {}    # launches on the SSM paths, into ``counts`` below
    ssm_arch = "mamba2-2.7b"

    def ssm_served(fmt, slots, extra=()):
        """mamba2-2.7b at full width and depth under ``fmt`` weights,
        served by ``launch.serve`` with the main path's traffic on
        ``slots`` slots (8 requests; 1 alone on 1 slot)."""
        zero_counts()
        torch.cuda.synchronize()
        with kernels_only(quantized=fmt != "bf16"):
            res = serve.main([
                "--arch", ssm_arch, "--no-reduced", "--precision", fmt,
                "--slots", str(slots), "--max-len", "1024", "--megastep-k",
                "8", "--requests", "8" if slots == 4 else "1", "--max-new",
                "32", "--temperature", "0", "--device", "cuda", *extra])
        torch.cuda.synchronize()
        return res

    def ssm_numbers(eng, floor):
        st = eng.stats
        return dict(ms_per_step=1e3 * st.decode_wall_s / st.steps,
                    tok_s=st.tokens_generated / st.decode_wall_s,
                    steps=st.steps, tokens=st.tokens_generated,
                    floor_ms=floor["ms"], weight_bytes=floor["weight_bytes"],
                    state_bytes=floor["state_bytes"])

    def ssm_leg(eng, label, key, reqs, warm_reqs):
        """Serve ``reqs`` on a (fresh) engine with quantized weights after
        a warmup that captures its graph; launch counts into
        ``ssm_counts[key]``."""
        zero_counts()
        for r in warm_reqs:
            eng.submit(r)
        eng.run()
        warm, after_warm = eng.stats, ops.launch_counts()
        eng.reset()
        for r in reqs:
            eng.submit(r)
        with kernels_only():
            eng.run()
        torch.cuda.synchronize()
        ssm_counts[key] = check_served(eng, reqs, label, warm, after_warm)

    def ssm_resume_leg(model, params, admission, label="SSM resume leg"):
        """A request preempted once it has tokens resumes from its prompt
        and tokens: chunked, its stream is ``reference_decode``'s; stall,
        its tokens after the resume are the fused reference of the prompt
        and the tokens before it (an exact-length re-prefill)."""
        eng = ServingEngine(model, params, slots=2, max_len=1024,
                            sampling=SamplingConfig(), megastep_k=8,
                            quant_policy="q8_0", admission=admission)
        reqs = serve.make_requests(model.cfg.vocab_size, 2, 24, seed=4)
        with kernels_only():
            for r in reqs:
                eng.submit(r)
            while not reqs[0].output:
                eng.step()
            check(eng.preempt(reqs[0]), f"{label}: nothing preempted")
            head = list(reqs[0].output)
            eng.run()
        torch.cuda.synchronize()
        r = reqs[0]
        check(r.done and len(r.output) == 24 and r.output[:len(head)] == head
              and r.preemptions == 1, f"{label} ({admission}): "
              f"{len(r.output)} tokens, {r.preemptions} preemptions")
        if admission == "chunked":
            check(r.output == model.reference_decode(
                params, r.prompt, 24, max_len=1024),
                f"{label} (chunked): the stream differs from "
                "reference_decode")
        else:
            resumed = np.concatenate([r.prompt, np.asarray(head, np.int32)])
            check(r.output[len(head):] == model.reference_decode(
                params, resumed, 24 - len(head), max_len=1024,
                stepwise_prefill=False), f"{label} (stall): the tokens"
                " after the resume differ from reference_decode("
                "stepwise_prefill=False) of the prompt and the tokens before")
        check(reqs[1].output == model.reference_decode(
            params, reqs[1].prompt, 24, max_len=1024,
            stepwise_prefill=admission == "chunked"),
            f"{label} ({admission}): the other request's stream "
            "differs from its reference")
        print(f"  {label} ({admission}): preempted after "
              f"{len(head)} tokens, resumed to 24; "
              + ("stream == reference_decode" if admission == "chunked" else
                 "tokens after the resume == reference_decode(prompt + "
                 "tokens, stepwise_prefill=False)"), flush=True)
        return dict(preempted_after=len(head))

    def ssm_phase():
        t_phase = time.perf_counter()
        out = dict(kernel_cases_s=ssm_kernel_s, checks_s=0.0,
                   ssd_prefill_max_rel_err=[max(r[i] for r in ssd_readings)
                                            for i in (0, 1)],
                   ssd_prefill_memory=ssd_memory,
                   ssm_decode_step_run=ssm_step_readings)
        print(f"SSM path: {ssm_arch} at full width and depth "
              f"({get_config(ssm_arch).num_layers} layers), bf16 / q8_0 / "
              "q4_0 weights (served by launch.serve)", flush=True)
        streams = {}
        for fmt in ("bf16", "q8_0", "q4_0"):
            cell = {}
            for slots in (4, 1):
                res = ssm_served(fmt, slots)
                eng = res.engine
                label = f"{ssm_arch} ({fmt} weights, {slots} slot(s))"
                ssm_counts[f"ssm {fmt}" + ("" if slots == 4 else " alone")] \
                    = check_served(eng, res.requests, label,
                                   res.warmup_stats,
                                   res.launches_after_warmup)
                for r in res.requests:
                    check(r.output == eng.model.reference_decode(
                        eng.params, r.prompt, r.max_new_tokens,
                        max_len=1024), f"{label}: request {r.uid} differs "
                        "from reference_decode")
                if slots == 1:
                    check(res.requests[0].output == streams[fmt][0],
                          f"{label}: the stream alone differs from the "
                          "4-slot run's")
                cell[f"slots{slots}"] = ssm_numbers(eng, res.floor)
                print(f"  {label}: {cell[f'slots{slots}']['ms_per_step']:.3f}"
                      f" ms a step, {cell[f'slots{slots}']['tok_s']:.1f} tok/s"
                      f"; floor {res.floor['ms']:.3f} ms "
                      f"({res.floor['weight_bytes'] / 1e9:.3f} GB of weights"
                      f" + {res.floor['state_bytes'] / 1e9:.3f} GB of state "
                      "read and written); streams == reference_decode",
                      flush=True)
                if slots == 4:
                    streams[fmt] = [r.output for r in res.requests]
                    t0 = time.perf_counter()
                    cell.update(step_vs_plain(eng, label,
                                              tol=SSM_STEP_REL_TOL))
                    cell.update(recurrent_layers_vs_plain(eng, label))
                    out["checks_s"] += time.perf_counter() - t0
                    cell["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
                if fmt == "q8_0" and slots == 4:
                    # where the device time goes: the first 4 requests'
                    # first 16 tokens again under the profiler
                    prof, replay = profile_served(
                        eng, lambda: serve.make_requests(
                            eng.cfg.vocab_size, 4, 16, seed=0))
                    check([r.output for r in replay] ==
                          [o[:16] for o in streams[fmt][:4]],
                          f"{label}: the profiled replay served other "
                          "tokens")
                    g = prof["device_ms_per_step_by_group"]
                    ssm_ms = (g["ssm_conv"] + g["ssm_decode"]
                              + g["gated_rmsnorm"])
                    print(f"  {label}: device ms a step in the SSM kernels "
                          f"{ssm_ms:.3f} (the conv and state update in one "
                          f"launch {g['ssm_decode']:.3f}, the conv alone "
                          f"{g['ssm_conv']:.3f}, gated norm "
                          f"{g['gated_rmsnorm']:.3f}) of "
                          f"{prof['device_ms_per_step']:.3f}; device idle "
                          f"share {prof['device_idle_share']:.3f}; CUDA "
                          f"events a megastep {prof['events_per_megastep']}",
                          flush=True)
                    cell.update(prof, ssm_device_ms_per_step=ssm_ms)
                if fmt == "q8_0" and slots == 4:
                    model, params = eng.model, eng.params
                if fmt == "q4_0" and slots == 4:
                    model4, params4 = eng.model, eng.params
                del eng, res
                torch.cuda.empty_cache()
            out[fmt] = cell

        # stall admission: four prompts of distinct lengths, each its own
        # exact-length bucket (one odd)
        label = (f"SSM stall leg ({ssm_arch}, q8_0 weights, buckets "
                 f"{SSM_STALL_PROMPTS})")
        seng = ServingEngine(model, params, slots=4, max_len=1024,
                             sampling=SamplingConfig(), megastep_k=8,
                             quant_policy="q8_0", admission="stall")
        rng = np.random.default_rng(2)
        prompts = [rng.integers(1, model.cfg.vocab_size, n).astype(np.int32)
                   for n in SSM_STALL_PROMPTS]
        reqs = [Request(uid=i, prompt=p, max_new_tokens=8)
                for i, p in enumerate(prompts)]
        t0 = time.perf_counter()
        ssm_leg(seng, label, "ssm stall", reqs,
                [Request(uid=-1, prompt=prompts[0][:37], max_new_tokens=2)])
        check(seng.stats.prefill_batches == 4 and [
            seng._bucket_len(n) for n in SSM_STALL_PROMPTS] ==
            list(SSM_STALL_PROMPTS), f"{label}: "
            f"{seng.stats.prefill_batches} prefill calls, buckets "
            f"{[seng._bucket_len(n) for n in SSM_STALL_PROMPTS]}")
        for r in reqs:
            check(r.output == model.reference_decode(
                params, r.prompt, 8, max_len=1024, stepwise_prefill=False),
                f"{label}: request {r.uid} differs from reference_decode("
                "stepwise_prefill=False)")
        served_s = time.perf_counter() - t0
        # each bucket's prefill call under the profiler (card only); the
        # profiler now and then drops a kernel's events (a run once lost
        # the 301 call's scan kernels), so the calls are traced again, up
        # to three times, until every trace holds both scan kernels
        for attempt in range(1, 4):
            calls = profile_prefill_calls(seng, reqs, label)
            if all(g["ssd_prefill_state"] > 0.0 and g["ssd_prefill_out"] > 0.0
                   for _, g, _ in calls):
                break
            print(f"  {label}: profile attempt {attempt}: a trace lacks a "
                  "scan kernel", flush=True)
        check(sorted(c[0] for c in calls) == sorted(SSM_STALL_PROMPTS),
              f"{label}: profiled prefill calls at {[c[0] for c in calls]}")
        by_bucket = {}
        for S, groups, wall in calls:
            busy = sum(groups.values())
            check(groups["ssd_prefill_state"] > 0.0
                  and groups["ssd_prefill_out"] > 0.0,
                  f"{label}: the {S}-token prefill call's trace lacks a "
                  "scan kernel")
            by_bucket[S] = dict(device_ms=busy, wall_ms=wall,
                                device_ms_by_group={
                                    g: ms for g, ms in groups.items() if ms})
            print(f"  {label}: the 1 x {S} prefill call: {busy:.3f} device "
                  f"ms (wall {wall:.3f}); by group "
                  + ", ".join(f"{g} {ms:.3f}" for g, ms in groups.items()
                              if ms), flush=True)
        out["stall"] = prefill_vs_plain(seng, [300] * 4, label,
                                        tol=SSM_PREFILL_REL_TOL)
        out["stall"]["prefill_calls_by_bucket"] = by_bucket
        out["stall"].update(recurrent_layers_vs_plain(seng, label, [300] * 4))
        out["stall"]["served_s"] = served_s
        out["checks_s"] += time.perf_counter() - t0 - served_s
        print(f"  {label}: four exact-length prefill calls; streams == "
              "reference_decode(stepwise_prefill=False)", flush=True)
        # the longest prompt, served alone: the card's peak allocation over
        # the engine's own (weights, states, graph pools) while it is served
        long_req = Request(uid=100, prompt=rng.integers(
            1, model.cfg.vocab_size, SSM_LONG_PROMPT).astype(np.int32),
            max_new_tokens=4)
        seng.reset()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t_long = time.perf_counter()
        seng.submit(long_req)
        seng.run()
        torch.cuda.synchronize()
        long_s = time.perf_counter() - t_long
        long_peak = torch.cuda.max_memory_allocated() - base
        check(long_req.output == model.reference_decode(
            params, long_req.prompt, 4, max_len=1024, stepwise_prefill=False),
            f"{label}: the {SSM_LONG_PROMPT}-token request differs from "
            "reference_decode(stepwise_prefill=False)")
        print(f"  {label}: one {SSM_LONG_PROMPT}-token prompt served in "
              f"{long_s:.3f} s, == reference_decode(stepwise_prefill=False);"
              f" peak allocation over the engine's {long_peak / 2 ** 20:.1f} "
              f"MiB (engine {base / 2 ** 30:.2f} GiB)", flush=True)
        out["stall"]["long_prompt"] = dict(
            tokens=SSM_LONG_PROMPT, served_s=long_s, peak_bytes=long_peak,
            engine_bytes=base)
        del seng
        # under q4_0 each admission mode meets its own reference: chunked
        # (the 4-slot cell) the stepwise one, stall the fused one
        label = f"SSM q4_0 stall leg ({ssm_arch}, buckets 300 and 301)"
        qeng = ServingEngine(model4, params4, slots=4, max_len=1024,
                             sampling=SamplingConfig(), megastep_k=8,
                             quant_policy="q4_0", admission="stall")
        reqs = [Request(uid=i, prompt=p, max_new_tokens=8)
                for i, p in enumerate(prompts[:2])]
        ssm_leg(qeng, label, "ssm q4_0 stall", reqs,
                [Request(uid=-1, prompt=prompts[0][:37], max_new_tokens=2)])
        for r in reqs:
            check(r.output == model4.reference_decode(
                params4, r.prompt, 8, max_len=1024, stepwise_prefill=False),
                f"{label}: request {r.uid} differs from reference_decode("
                "stepwise_prefill=False)")
        print(f"  {label}: streams == reference_decode(stepwise_prefill="
              "False); the chunked cell's == the stepwise reference",
              flush=True)
        del qeng, model4, params4
        torch.cuda.empty_cache()

        # --kv-quant q8_0 --page-size 16 --prefix-cache: no-ops, with the
        # engine's warning; the streams are the q8_0 cell's
        import warnings
        label = f"SSM no-op leg ({ssm_arch}, q8_0, --kv-quant q8_0 " \
                f"--page-size {PAGE} --prefix-cache)"
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = ssm_served("q8_0", 4, ("--kv-quant", "q8_0", "--page-size",
                                         str(PAGE), "--prefix-cache"))
        eng = res.engine
        check(any("prefix_cache requires" in str(w.message) for w in caught),
              f"{label}: no prefix-cache warning")
        check(not eng.paged and not eng.prefix_cache
              and eng.kv_quant == "bf16", f"{label}: paged {eng.paged}, "
              f"prefix cache {eng.prefix_cache}, kv_quant {eng.kv_quant}")
        ssm_counts["ssm no-op"] = check_served(
            eng, res.requests, label, res.warmup_stats,
            res.launches_after_warmup)
        check([r.output for r in res.requests] == streams["q8_0"],
              f"{label}: streams differ from the q8_0 cell's")
        print(f"  {label}: warned, dense bf16 state; streams == the q8_0 "
              "cell's (8 requests)", flush=True)
        del eng, res
        torch.cuda.empty_cache()

        # preemption with resume, chunked and stall
        for admission in ("chunked", "stall"):
            out[f"resume_{admission}"] = ssm_resume_leg(model, params,
                                                        admission)
        del model, params
        torch.cuda.empty_cache()
        out["phase_s"] = time.perf_counter() - t_phase
        print(f"SSM phase: {out['phase_s']:.1f} s, of which the "
              f"kernel-vs-plain checks {out['checks_s']:.1f} s and the stall "
              f"leg's serving and reference streams "
              f"{out['stall']['served_s']:.1f} s (the SSM kernel cases took "
              f"{out['kernel_cases_s']:.1f} s in phase 3)", flush=True)
        return out

    ssm = ssm_phase()

    # -- 14. the hybrid family (run right after the SSM family) --------------
    hybrid_counts = {}  # launches on the hybrid's paths, into ``counts``

    def hybrid_served(fmt, slots, extra=()):
        """recurrentgemma-2b at full width and depth under ``fmt`` weights,
        served by ``launch.serve`` with the main path's traffic on
        ``slots`` slots (8 requests; 1 alone on 1 slot)."""
        zero_counts()
        torch.cuda.synchronize()
        with kernels_only(quantized=fmt != "bf16"):
            res = serve.main([
                "--arch", HYBRID_ARCH, "--no-reduced", "--precision", fmt,
                "--slots", str(slots), "--max-len", "1024", "--megastep-k",
                "8", "--requests", "8" if slots == 4 else "1", "--max-new",
                "32", "--temperature", "0", "--device", "cuda", *extra])
        torch.cuda.synchronize()
        return res

    def hybrid_leg(eng, label, key, reqs, warm_reqs):
        """Serve ``reqs`` on a (fresh) engine after a warmup that captures
        its graph; launch counts into ``hybrid_counts[key]``."""
        zero_counts()
        for r in warm_reqs:
            eng.submit(r)
        eng.run()
        warm, after_warm = eng.stats, ops.launch_counts()
        eng.reset()
        for r in reqs:
            eng.submit(r)
        t_leg = time.perf_counter()
        with kernels_only():
            eng.run()
        torch.cuda.synchronize()
        hybrid_counts[key] = check_served(eng, reqs, label, warm, after_warm)
        return time.perf_counter() - t_leg

    def hybrid_phase():
        t_phase = time.perf_counter()
        out = dict(kernel_cases_s=hybrid_kernel_s, checks_s=0.0,
                   kernel_readings=hybrid_readings)
        arch_cfg = get_config(HYBRID_ARCH)
        print(f"hybrid path: {HYBRID_ARCH} at full width and depth "
              f"({arch_cfg.num_layers} layers: "
              f"{arch_cfg.layer_pattern().count('rglru')} RG-LRU, "
              f"{arch_cfg.layer_pattern().count('attn')} local attention), "
              "bf16 / q8_0 / q4_0 weights (served by launch.serve)",
              flush=True)
        streams = {}
        for fmt in ("bf16", "q8_0", "q4_0"):
            cell = {}
            for slots in (4, 1):
                res = hybrid_served(fmt, slots)
                eng = res.engine
                label = f"{HYBRID_ARCH} ({fmt} weights, {slots} slot(s))"
                hybrid_counts[f"hybrid {fmt}" + ("" if slots == 4
                                                 else " alone")] = \
                    check_served(eng, res.requests, label, res.warmup_stats,
                                 res.launches_after_warmup)
                for r in res.requests:
                    check(r.output == eng.model.reference_decode(
                        eng.params, r.prompt, r.max_new_tokens,
                        max_len=1024), f"{label}: request {r.uid} differs "
                        "from reference_decode")
                if slots == 1:
                    check(res.requests[0].output == streams[fmt][0],
                          f"{label}: the stream alone differs from the "
                          "4-slot run's")
                st = eng.stats
                f = res.floor
                num = dict(ms_per_step=1e3 * st.decode_wall_s / st.steps,
                           tok_s=st.tokens_generated / st.decode_wall_s,
                           steps=st.steps, tokens=st.tokens_generated,
                           floor_ms=f["ms"], weight_bytes=f["weight_bytes"],
                           state_bytes=f["state_bytes"],
                           ring_bytes=f["ring_bytes"], kv_len=f["kv_len"])
                num["x_floor"] = num["ms_per_step"] / f["ms"]
                cell[f"slots{slots}"] = num
                print(f"  {label}: {num['ms_per_step']:.3f} ms a step, "
                      f"{num['tok_s']:.1f} tok/s; floor {f['ms']:.3f} ms "
                      f"({num['x_floor']:.2f}x; {f['weight_bytes'] / 1e9:.3f}"
                      f" GB of weights + {f['state_bytes'] / 1e6:.3f} MB of "
                      f"state read and written + {f['ring_bytes'] / 1e6:.3f}"
                      f" MB of the rings at kv_len {f['kv_len']:.1f}); "
                      "streams == reference_decode", flush=True)
                if slots == 4:
                    streams[fmt] = [r.output for r in res.requests]
                    t0 = time.perf_counter()
                    cell.update(step_vs_plain(eng, label,
                                              tol=HYBRID_STEP_REL_TOL))
                    cell.update(recurrent_layers_vs_plain(eng, label))
                    out["checks_s"] += time.perf_counter() - t0
                    cell["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
                if fmt == "q8_0" and slots == 4:
                    # where the device time goes: the first 4 requests'
                    # first 16 tokens again under the profiler
                    prof, replay = profile_served(
                        eng, lambda: serve.make_requests(
                            eng.cfg.vocab_size, 4, 16, seed=0))
                    check([r.output for r in replay] ==
                          [o[:16] for o in streams[fmt][:4]],
                          f"{label}: the profiled replay served other "
                          "tokens")
                    g = prof["device_ms_per_step_by_group"]
                    print(f"  {label}: device ms a step by kernel group "
                          + ", ".join(f"{k} {v:.4f}" for k, v in g.items()
                                      if v)
                          + f" of {prof['device_ms_per_step']:.3f}; device "
                          f"idle share {prof['device_idle_share']:.3f}; CUDA"
                          f" events a megastep {prof['events_per_megastep']}",
                          flush=True)
                    cell.update(prof)
                    model, params = eng.model, eng.params
                del eng, res
                torch.cuda.empty_cache()
            out[fmt] = cell

        # stall admission: three prompts of distinct lengths, each its own
        # exact-length bucket (one odd)
        label = (f"hybrid stall leg ({HYBRID_ARCH}, q8_0 weights, buckets "
                 f"{HYBRID_STALL_PROMPTS})")
        seng = ServingEngine(model, params, slots=4, max_len=1024,
                             sampling=SamplingConfig(), megastep_k=8,
                             quant_policy="q8_0", admission="stall")
        rng = np.random.default_rng(2)
        prompts = [rng.integers(1, model.cfg.vocab_size, n).astype(np.int32)
                   for n in HYBRID_STALL_PROMPTS]
        reqs = [Request(uid=i, prompt=p, max_new_tokens=8)
                for i, p in enumerate(prompts)]
        served_s = hybrid_leg(seng, label, "hybrid stall", reqs, [Request(
            uid=-1, prompt=prompts[0][:37], max_new_tokens=2)])
        check(seng.stats.prefill_batches == len(HYBRID_STALL_PROMPTS) and [
            seng._bucket_len(n) for n in HYBRID_STALL_PROMPTS] ==
            list(HYBRID_STALL_PROMPTS), f"{label}: "
            f"{seng.stats.prefill_batches} prefill calls")
        for r in reqs:
            check(r.output == model.reference_decode(
                params, r.prompt, 8, max_len=1024, stepwise_prefill=False),
                f"{label}: request {r.uid} differs from reference_decode("
                "stepwise_prefill=False)")
        t0 = time.perf_counter()
        out["stall"] = recurrent_layers_vs_plain(seng, label, [300] * 2)
        out["checks_s"] += time.perf_counter() - t0
        out["stall"]["served_s"] = served_s
        print(f"  {label}: three exact-length prefill calls; streams == "
              "reference_decode(stepwise_prefill=False)", flush=True)
        del seng

        # the window: max_len 4096, so each attention layer's ring is the
        # 2048-position window; a 4500-token prompt through the ring write
        # and the windowed flash attention, a 2040-token one whose decode
        # crosses the ring's edge
        label = (f"hybrid window leg ({HYBRID_ARCH}, q8_0 weights, stall "
                 f"admission, max_len {HYBRID_WINDOW_MAX_LEN})")
        weng = ServingEngine(model, params, slots=2,
                             max_len=HYBRID_WINDOW_MAX_LEN,
                             sampling=SamplingConfig(), megastep_k=8,
                             quant_policy="q8_0", admission="stall")
        check(Model.cache_len(weng.cache) == model.cfg.local_attn_window,
              f"{label}: the ring is not the window")
        long_p, edge_p = (rng.integers(1, model.cfg.vocab_size, n).astype(
            np.int32) for n in (4500, 2040))
        reqs = [Request(uid=0, prompt=long_p, max_new_tokens=16),
                Request(uid=1, prompt=edge_p, max_new_tokens=24)]
        wall = hybrid_leg(weng, label, "hybrid window", reqs, [Request(
            uid=-1, prompt=edge_p[:9], max_new_tokens=2)])
        for r in reqs:
            check(r.output == model.reference_decode(
                params, r.prompt, r.max_new_tokens,
                max_len=HYBRID_WINDOW_MAX_LEN, stepwise_prefill=False),
                f"{label}: request {r.uid} differs from reference_decode("
                "stepwise_prefill=False)")
        print(f"  {label}: a 4500-token prompt through the ring write and "
              "the windowed prefill attention, a 2040-token one whose "
              "decode crosses ring slot 2048; both streams == "
              f"reference_decode(stepwise_prefill=False); {wall:.3f} s "
              "served", flush=True)
        out["window"] = dict(served_s=wall)
        del weng
        torch.cuda.empty_cache()

        # --kv-quant q8_0 --page-size 16 --prefix-cache: no-ops, with the
        # engine's warning; the streams are the q8_0 cell's
        import warnings
        label = (f"hybrid no-op leg ({HYBRID_ARCH}, q8_0, --kv-quant q8_0 "
                 f"--page-size {PAGE} --prefix-cache)")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = hybrid_served("q8_0", 4, ("--kv-quant", "q8_0",
                                            "--page-size", str(PAGE),
                                            "--prefix-cache"))
        eng = res.engine
        check(any("prefix_cache requires" in str(w.message) for w in caught),
              f"{label}: no prefix-cache warning")
        check(not eng.paged and not eng.prefix_cache
              and eng.kv_quant == "bf16", f"{label}: paged {eng.paged}, "
              f"prefix cache {eng.prefix_cache}, kv_quant {eng.kv_quant}")
        hybrid_counts["hybrid no-op"] = check_served(
            eng, res.requests, label, res.warmup_stats,
            res.launches_after_warmup)
        check([r.output for r in res.requests] == streams["q8_0"],
              f"{label}: streams differ from the q8_0 cell's")
        print(f"  {label}: warned, dense bf16 rings; streams == the q8_0 "
              "cell's (8 requests)", flush=True)
        del eng, res
        torch.cuda.empty_cache()

        for admission in ("chunked", "stall"):
            out[f"resume_{admission}"] = ssm_resume_leg(
                model, params, admission, label="hybrid resume leg")
        del model, params
        torch.cuda.empty_cache()
        out["phase_s"] = time.perf_counter() - t_phase
        print(f"hybrid phase: {out['phase_s']:.1f} s, of which the "
              f"kernel-vs-plain checks {out['checks_s']:.1f} s (the hybrid "
              f"kernel cases took {out['kernel_cases_s']:.1f} s in phase "
              "3)", flush=True)
        print(f"{HYBRID_ARCH} on the H100 (ms a step at 4 slots / alone, "
              "tok/s at 4 slots, x the floor):", flush=True)
        for fmt in ("bf16", "q8_0", "q4_0"):
            c = out[fmt]
            print(f"  {fmt:5s} {c['slots4']['ms_per_step']:7.3f} / "
                  f"{c['slots1']['ms_per_step']:7.3f} ms  "
                  f"{c['slots4']['tok_s']:8.1f} tok/s  floor "
                  f"{c['slots4']['floor_ms']:.3f} ms "
                  f"({c['slots4']['x_floor']:.2f}x)", flush=True)
        return out

    hybrid = hybrid_phase()

    # -- 5. serving under load ------------------------------------------------
    load = serving_under_load()
    torch.cuda.empty_cache()

    # -- 6. prefill path: stall admission through the fused prefill -------
    print("prefill path: llama3.2-1b full width, q8_0 weights, bf16 cache, "
          "stall admission", flush=True)
    model_p = Model(cfg_full, device=dev)
    eng = ServingEngine(model_p, model_p.init(gen, quantize=False), slots=4,
                        max_len=1024, sampling=SamplingConfig(),
                        megastep_k=8, quant_policy="q8_0", admission="stall")
    prng = np.random.default_rng(2)
    prompts = [prng.integers(1, cfg_full.vocab_size, n).astype(np.int32)
               for n in PREFILL_PROMPTS]

    def prefill_requests():
        return [Request(uid=i, prompt=p, max_new_tokens=32)
                for i, p in enumerate(prompts)]

    # warmup: first-use costs of the prefill shapes, and the capture of
    # the megastep graph, stay out of the run
    zero_counts()
    eng.submit(Request(uid=-1, prompt=prompts[0], max_new_tokens=2))
    eng.run()
    warm, after_warm = eng.stats, ops.launch_counts()
    eng.reset()
    impl = eng._prefill_impl
    calls = []

    def timed_prefill(tokens, seq_lens, *rest):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        first = impl(tokens, seq_lens, *rest)
        e1.record()
        e1.synchronize()
        calls.append(dict(rows=tokens.shape[0], S=tokens.shape[1],
                          tokens=int(seq_lens.sum()),
                          ms=e0.elapsed_time(e1),
                          wall_ms=1e3 * (time.perf_counter() - t0)))
        return first

    eng._prefill_impl = timed_prefill
    reqs = prefill_requests()
    torch.cuda.synchronize()
    for r in reqs:
        eng.submit(r)
    with kernels_only():
        eng.run()
    torch.cuda.synchronize()
    st = eng.stats
    prefill_counts = check_served(eng, reqs, "prefill path", warm,
                                  after_warm)
    check(0 < st.prefill_batches < st.prefills,
          f"prefill path: {st.prefill_batches} prefill calls for "
          f"{st.prefills} requests: no bucket was shared")
    by_bucket = {}
    for c in calls:
        b = by_bucket.setdefault(c["S"], dict(calls=0, rows=0, tokens=0,
                                              ms=0.0))
        b["calls"] += 1
        b["rows"] += c["rows"]
        b["tokens"] += c["tokens"]
        b["ms"] += c["ms"]
        print(f"  prefill call: {c['rows']} x {c['S']} (M {c['rows'] * c['S']}"
              f", {c['tokens']} real tokens): {c['ms']:.3f} ms on CUDA "
              f"events, {c['tokens'] / c['ms'] * 1e3:.1f} prefill tok/s "
              f"({c['rows'] * c['S'] / c['ms'] * 1e3:.1f} padded)",
              flush=True)
    for S, b in sorted(by_bucket.items()):
        b.update(ms_per_call=b["ms"] / b["calls"],
                 tok_s=b["tokens"] / b["ms"] * 1e3)
        print(f"  bucket {S}: {b['calls']} calls, {b['ms_per_call']:.3f} ms "
              f"per call, {b['tok_s']:.1f} prefill tok/s", flush=True)
    prefill_s = sum(c["wall_ms"] for c in calls) / 1e3
    decode_tokens = st.tokens_generated - st.prefills
    decode_s = st.decode_wall_s - prefill_s
    print(f"  prefill path: {st.tokens_generated} tokens ({st.prefills} from "
          f"{st.prefill_batches} prefill calls in {prefill_s:.3f} s), "
          f"decode after stall admission {decode_tokens} tokens in "
          f"{decode_s:.3f} s = {decode_tokens / decode_s:.1f} tok/s, "
          f"{1e3 * decode_s / st.steps:.3f} ms per decode step ({st.steps} "
          "steps)", flush=True)
    for uid in (0, 4, 7):                   # buckets 4 x 512, 3 x 1024, 1 x 512
        r = reqs[uid]
        ref = eng.model.reference_decode(eng.params, r.prompt,
                                         r.max_new_tokens, max_len=1024,
                                         stepwise_prefill=False)
        check(ref == r.output, f"prefill path: request {uid} engine stream "
              "differs from reference_decode(stepwise_prefill=False)")
    print("  prefill path: engine streams == Model.reference_decode("
          "stepwise_prefill=False) (requests 0, 4, 7)", flush=True)
    prefill_path = dict(calls=calls, buckets=by_bucket,
                        prefill_batches=st.prefill_batches,
                        prefills=st.prefills,
                        decode_tok_s=decode_tokens / decode_s,
                        decode_ms_per_step=1e3 * decode_s / st.steps)
    prefill_path.update(prefill_vs_plain(
        eng, list(PREFILL_PROMPTS[:4]), "prefill path"))

    # where the prefill's time goes: the same requests again, each prefill
    # call under the profiler (card only); idle share = 1 - kernel time /
    # the calls' wall time
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    groups = dict.fromkeys(GROUPS, 0.0)
    prof_wall = [0.0]

    def profiled_prefill(*args):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            first = impl(*args)
            torch.cuda.synchronize()
            prof_wall[0] += 1e3 * (time.perf_counter() - t0)
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                groups[group_of(e.name)] += e.time_range.elapsed_us() / 1e3
        return first

    eng.reset()
    eng._prefill_impl = profiled_prefill
    replay = prefill_requests()
    for r in replay:
        eng.submit(r)
    eng.run()
    check([r.output for r in replay] == [r.output for r in reqs],
          "prefill path: the profiled replay served other tokens")
    busy = sum(groups.values())
    if busy == 0.0:
        print("  prefill profile: device time not measured (the trace holds "
              "no CUDA kernel events)", flush=True)
        prefill_path.update(device_idle_share=None)
    else:
        print(f"  prefill profile: {len(calls)} calls, wall {prof_wall[0]:.3f}"
              f" ms, device kernel time {busy:.3f} ms -> device idle share "
              f"{1 - busy / prof_wall[0]:.3f}; device ms by group "
              + ", ".join(f"{g} {ms:.3f}" for g, ms in groups.items()),
              flush=True)
        prefill_path.update(profiled_wall_ms=prof_wall[0],
                            device_ms_by_group=groups,
                            device_idle_share=1 - busy / prof_wall[0])
    del eng, model_p
    torch.cuda.empty_cache()

    counts = {"main": main_counts, "prefill": prefill_counts}

    # -- 7. paged path: the paged cache and the prefix cache ------------------
    print("paged path: llama3.2-1b full width, q8_0 weights, bf16 cache, "
          f"page_size {PAGE}, chunked admission with the prefix cache",
          flush=True)
    gen_pg = torch.Generator(device=dev)
    gen_pg.manual_seed(4)
    model_pg = Model(cfg_full, device=dev)
    params_pg = quantize_tree(model_pg.init(gen_pg, quantize=False), "q8_0",
                              cfg_full.quant_group)
    prng = np.random.default_rng(3)
    system = prng.integers(1, cfg_full.vocab_size, 256).astype(np.int32)
    tails = [prng.integers(1, cfg_full.vocab_size, n).astype(np.int32)
             for n in (20, 8, 16, 24, 32, 40)]
    unrelated = [prng.integers(1, cfg_full.vocab_size, n).astype(np.int32)
                 for n in (4, 8)]

    def paged_traffic():
        """The first request (the system prompt and a 20-token tail),
        then 5 that share the system prompt (tails of 8-40 tokens) and 2
        unrelated ones, in the order they are submitted; 32 new tokens
        each."""
        first = Request(uid=0, prompt=np.concatenate([system, tails[0]]),
                        max_new_tokens=32)
        hit = [Request(uid=i, prompt=np.concatenate([system, tails[i]]),
                       max_new_tokens=32) for i in range(1, 6)]
        other = [Request(uid=6 + i, prompt=p, max_new_tokens=32)
                 for i, p in enumerate(unrelated)]
        return first, [hit[0], hit[1], other[0], hit[2], hit[3], other[1],
                       hit[4]]

    def serve_stamped(engine, reqs):
        """Submit reqs together and serve them; returns each one's wall
        time from submission to the megastep that emits its first token
        (megastep granularity)."""
        t0, first_tok = time.perf_counter(), {}
        for r in reqs:
            engine.submit(r)
        while engine.has_work():
            engine.step()
            now = time.perf_counter()
            for r in reqs:
                if r.output and r.uid not in first_tok:
                    first_tok[r.uid] = now - t0
        return first_tok

    def serve_paged_traffic(engine):
        """The first request alone to completion (its pages registered),
        then the others; returns the requests and their times to the
        first token."""
        first, rest = paged_traffic()
        ttft = serve_stamped(engine, [first])
        ttft.update(serve_stamped(engine, rest))
        return [first] + rest, ttft

    gathers = paged_gather.calls
    eng = ServingEngine(model_pg, params_pg, slots=4, max_len=1024,
                        sampling=SamplingConfig(), megastep_k=8,
                        quant_policy="q8_0", page_size=PAGE,
                        prefix_cache=True)
    check(eng.paged and eng.prefix_cache and eng.cache_blocks == 4 * 64 + 1,
          "paged path: the engine is not paged with the prefix cache")
    zero_counts()
    eng.submit(Request(uid=-1, prompt=np.arange(1, 6, dtype=np.int32),
                       max_new_tokens=32))       # warmup: the capture
    eng.run()
    warm, after_warm = eng.stats, ops.launch_counts()
    eng.reset()
    with kernels_only():
        reqs_pg, ttft = serve_paged_traffic(eng)
    torch.cuda.synchronize()
    st = eng.stats
    counts["paged"] = check_served(eng, reqs_pg, "paged path", warm,
                                   after_warm)
    check(eng.graph_launches == main_graph_launches,
          f"paged path: the capture enqueued {eng.graph_launches}, the main "
          f"path's dense capture {main_graph_launches}")
    tok_s_pg = st.tokens_generated / st.decode_wall_s
    ms_step_pg = 1e3 * st.decode_wall_s / st.steps
    check(st.prefix_hits == 5 and st.prefix_hit_tokens == 5 * 256,
          f"paged path: {st.prefix_hits} prefix hits of "
          f"{st.prefix_hit_tokens} tokens, not 5 of {5 * 256}")
    check(eng.blocks_in_use == len(eng._prefix_reg) > 0,
          f"paged path: {eng.blocks_in_use} blocks in use once drained, "
          f"{len(eng._prefix_reg)} registered")
    hit_ttft = [ttft[r.uid] for r in reqs_pg if 1 <= r.uid <= 5]
    print(f"  paged path: {st.tokens_generated} tokens, {tok_s_pg:.1f} "
          f"tok/s, {ms_step_pg:.3f} ms per decode step ({st.steps} steps, "
          f"{st.megasteps} megasteps; main path {tok_s:.1f} tok/s, "
          f"{ms_step:.3f} ms); {st.prefix_hits} prefix hits of "
          f"{st.prefix_hit_tokens} tokens, {st.blocks_recycled} blocks "
          f"recycled, {eng.blocks_in_use} in use = registered; cache "
          f"{eng.cache_nbytes() / 1e6:.1f} MB; wall to the first token: "
          f"the first (missing) request {1e3 * ttft[0]:.1f} ms, the hits "
          + ", ".join(f"{1e3 * t:.1f}" for t in hit_ttft) + " ms",
          flush=True)
    # the same traffic through a dense engine, and through a paged one
    # without the prefix cache, which runs the dense engine's schedule:
    # the two timed in turns (dense, paged, paged, dense) show what
    # paging alone costs a step
    def warmed(**kw):
        e = ServingEngine(model_pg, params_pg, slots=4, max_len=1024,
                          sampling=SamplingConfig(), megastep_k=8,
                          quant_policy="q8_0", **kw)
        e.submit(Request(uid=-1, prompt=np.arange(1, 6, dtype=np.int32),
                         max_new_tokens=32))
        e.run()
        return e

    dense, unshared = warmed(), warmed(page_size=PAGE)
    turns = []
    for e in (dense, unshared, unshared, dense):
        e.reset()
        reqs_e, ttft_e = serve_paged_traffic(e)
        check([r.output for r in reqs_e] == [r.output for r in reqs_pg],
              "paged path: streams differ from the "
              + ("paged engine's without the prefix cache" if e.paged
                 else "dense engine's"))
        turns.append(1e3 * e.stats.decode_wall_s / e.stats.steps)
        if not e.paged:
            ttft_dense, steps_dense = ttft_e, e.stats.steps
    check(unshared.stats.steps == steps_dense and unshared.blocks_in_use == 0,
          "paged path: without the prefix cache the paged engine ran "
          f"{unshared.stats.steps} steps, the dense one {steps_dense}")
    dense_ms_step = (turns[0] + turns[3]) / 2
    unshared_ms_step = (turns[1] + turns[2]) / 2
    print(f"  paged path traffic on the dense schedule ({steps_dense} steps),"
          f" ms per decode step in turns: dense {turns[0]:.3f}, paged "
          f"{turns[1]:.3f}, paged {turns[2]:.3f}, dense {turns[3]:.3f}",
          flush=True)
    del dense, unshared
    for r in (reqs_pg[0], reqs_pg[1], reqs_pg[3]):   # a miss, a hit, other
        ref = eng.model.reference_decode(eng.params, r.prompt,
                                         r.max_new_tokens, max_len=1024)
        check(ref == r.output, f"paged path: request {r.uid} differs from "
              "reference_decode")
    print("  paged path: streams == the dense engine's (8 requests) and "
          "Model.reference_decode (requests 0, 1, 6); wall to the first "
          f"token on the dense engine: {1e3 * ttft_dense[0]:.1f} ms, then "
          + ", ".join(f"{1e3 * ttft_dense[r.uid]:.1f}" for r in reqs_pg
                      if 1 <= r.uid <= 5) + " ms", flush=True)
    # the profile: the first request served unprofiled (its pages
    # registered), the others traced
    prof, replay = profile_served(
        eng, lambda: paged_traffic()[1],
        prelude=lambda e: serve_stamped(e, [paged_traffic()[0]]))
    check([r.output for r in replay] == [r.output for r in reqs_pg[1:]],
          "paged path: the profiled replay served other tokens")
    check(paged_gather.calls == gathers, f"paged path: paged_gather ran "
          f"{paged_gather.calls - gathers} times in a served run")
    # a last run with audit() after every step, and the decode-step check
    # one megastep after the hits were admitted
    eng.audit_every_step = True
    first, rest = paged_traffic()
    step_check = step_check_mid_run(
        eng, rest, "paged path",
        prelude=lambda e: serve_stamped(e, [first]))
    eng.audit_every_step = False
    check([r.output for r in [first] + rest] == [r.output for r in reqs_pg]
          and eng.blocks_in_use == len(eng._prefix_reg),
          "paged path: the audited run served other tokens")
    print("  paged path: audit() held after every step of the last run",
          flush=True)
    paged_path = dict(tok_s=tok_s_pg, ms_per_step=ms_step_pg,
                      tokens=st.tokens_generated, steps=st.steps,
                      prefix_hits=st.prefix_hits,
                      prefix_hit_tokens=st.prefix_hit_tokens,
                      blocks_recycled=st.blocks_recycled,
                      cache_bytes=eng.cache_nbytes(),
                      ttft_first_ms=1e3 * ttft[0],
                      ttft_hits_ms=[1e3 * t for t in hit_ttft],
                      ttft_dense_ms=[1e3 * ttft_dense[r.uid]
                                     for r in reqs_pg],
                      dense_schedule_steps=steps_dense,
                      dense_schedule_ms_per_step_turns=turns,
                      dense_engine_ms_per_step=dense_ms_step,
                      paged_unshared_ms_per_step=unshared_ms_step)
    paged_path.update(prof)
    paged_path.update(step_check)
    print(f"  paged path beside the main path (one run): "
          f"{ms_step_pg:.3f} / {ms_step:.3f} ms per decode step, "
          f"{tok_s_pg:.1f} / {tok_s:.1f} tok/s, "
          f"{prof['events_per_megastep']} / "
          f"{main_path['events_per_megastep']} CUDA events a megastep, "
          f"device idle {prof['device_idle_share']:.3f} / "
          f"{main_path['device_idle_share']:.3f}; on the dense schedule "
          f"paged {unshared_ms_step:.3f} / dense {dense_ms_step:.3f} ms per "
          f"step; wall to the first token: the miss {1e3 * ttft[0]:.1f} ms,"
          f" the first hit {1e3 * hit_ttft[0]:.1f} ms", flush=True)
    del eng, model_pg, params_pg
    torch.cuda.empty_cache()

    # -- 8. second path: q4_0 weights, quantized caches, stall admission ----
    cfg4 = dataclasses.replace(cfg_full, num_layers=MAIN_LAYERS_SECOND_PATH)
    model4 = Model(cfg4, device=dev)
    params4 = model4.init(gen, quantize=False)
    step_checks = {}
    second_streams = {}
    for kvq, admission in (("q8_0", "chunked"), ("q4_0", "chunked"),
                           ("q8_0", "stall"), ("q4_0", "stall")):
        key = f"second {kvq}" + (" stall" if admission == "stall" else "")
        label = (f"second path (4 layers, q4_0 weights, {kvq} cache, "
                 f"{admission} admission)")
        eng = ServingEngine(model4, params4, slots=4, max_len=1024,
                            sampling=SamplingConfig(), megastep_k=8,
                            quant_policy="q4_0", kv_quant=kvq,
                            admission=admission)
        zero_counts()
        for r in serve.make_requests(cfg4.vocab_size, 2, 4, seed=5):
            eng.submit(r)                 # warmup: captures the graph
        eng.run()
        warm, after_warm = eng.stats, ops.launch_counts()
        eng.reset()
        reqs = serve.make_requests(cfg4.vocab_size, 6, 16, seed=1)
        for r in reqs:
            eng.submit(r)
        with kernels_only():
            eng.run()
        torch.cuda.synchronize()
        counts[key] = check_served(eng, reqs, label, warm, after_warm)
        step_checks[key] = step_vs_plain(eng, label)
        second_streams[(kvq, admission)] = [r.output for r in reqs]
        del eng

    # the same legs through a paged cache (P 16), with the prefix cache
    # under chunked admission; then a pool short enough that admissions
    # wait at the head of the queue and the registry evicts
    for kvq, admission in (("q8_0", "chunked"), ("q4_0", "chunked"),
                           ("q8_0", "stall"), ("q4_0", "stall")):
        key = f"second {kvq} paged" + (" stall" if admission == "stall"
                                       else "")
        label = (f"second path paged (4 layers, q4_0 weights, {kvq} cache, "
                 f"page_size {PAGE}, {admission} admission)")
        eng = ServingEngine(model4, params4, slots=4, max_len=1024,
                            sampling=SamplingConfig(), megastep_k=8,
                            quant_policy="q4_0", kv_quant=kvq,
                            admission=admission, page_size=PAGE,
                            prefix_cache=admission == "chunked")
        gathers = paged_gather.calls
        zero_counts()
        for r in serve.make_requests(cfg4.vocab_size, 2, 4, seed=5):
            eng.submit(r)
        eng.run()
        warm, after_warm = eng.stats, ops.launch_counts()
        eng.reset()
        eng.audit_every_step = True
        reqs = serve.make_requests(cfg4.vocab_size, 6, 16, seed=1)
        for r in reqs:
            eng.submit(r)
        with kernels_only():
            eng.run()
        torch.cuda.synchronize()
        counts[key] = check_served(eng, reqs, label, warm, after_warm)
        check([r.output for r in reqs] == second_streams[(kvq, admission)],
              f"{label}: streams differ from the dense leg's")
        check(eng.blocks_in_use == len(eng._prefix_reg),
              f"{label}: {eng.blocks_in_use} blocks in use once drained")
        check(paged_gather.calls == gathers, f"{label}: paged_gather ran "
              f"{paged_gather.calls - gathers} times in a served run")
        print(f"  {label}: streams == the dense leg's; audit() held after "
              f"every step; {eng.blocks_in_use} blocks in use once drained "
              f"= registered", flush=True)
        step_checks[key] = step_check_mid_run(
            eng, serve.make_requests(cfg4.vocab_size, 6, 16, seed=1), label)
        del eng
    label = ("short-pool leg (4 layers, q4_0 weights, q8_0 cache, page_size "
             f"{PAGE}, 13 blocks, prefix cache)")

    def short_pool_traffic():
        """6 requests opened by one 48-token prompt (3 pages, 5 pages a
        request) and an unrelated 100-token one (8 pages)."""
        reqs = serve.make_requests(cfg4.vocab_size, 6, 24, seed=6,
                                   shared_prefix=48)
        reqs.insert(3, Request(uid=6, prompt=np.random.default_rng(
            7).integers(1, cfg4.vocab_size, 100).astype(np.int32),
            max_new_tokens=24))
        return reqs

    eng = ServingEngine(model4, params4, slots=4, max_len=1024,
                        sampling=SamplingConfig(), megastep_k=8,
                        quant_policy="q4_0", kv_quant="q8_0", page_size=PAGE,
                        cache_blocks=13, prefix_cache=True)
    eng.audit_every_step = True
    gathers = paged_gather.calls
    pool_events = dict(blocked=0, evicted=0)
    admit_paged, reserve = eng._admit_paged, eng._reserve_blocks

    def counted_admit(s, r):
        start = admit_paged(s, r)
        pool_events["blocked"] += start is None
        return start

    def counted_reserve(n):
        before = len(eng._prefix_reg)
        ok = reserve(n)
        pool_events["evicted"] += before - len(eng._prefix_reg)
        return ok
    eng._admit_paged, eng._reserve_blocks = counted_admit, counted_reserve
    reqs = short_pool_traffic()
    for r in reqs:
        eng.submit(r)
    with kernels_only():
        eng.run()
    dense = ServingEngine(model4, params4, slots=4, max_len=1024,
                          sampling=SamplingConfig(), megastep_k=8,
                          quant_policy="q4_0", kv_quant="q8_0")
    reqs_dense = short_pool_traffic()
    for r in reqs_dense:
        dense.submit(r)
    dense.run()
    check([r.output for r in reqs] == [r.output for r in reqs_dense],
          f"{label}: streams differ from the dense engine's")
    check(pool_events["blocked"] > 0 and pool_events["evicted"] > 0
          and eng.stats.prefix_hits > 0,
          f"{label}: {pool_events} and {eng.stats.prefix_hits} hits: the "
          "pool never blocked an admission or evicted a registry entry")
    check(eng.blocks_in_use == len(eng._prefix_reg),
          f"{label}: {eng.blocks_in_use} blocks in use once drained")
    check(paged_gather.calls == gathers, f"{label}: paged_gather ran "
          f"{paged_gather.calls - gathers} times in a served run")
    print(f"  {label}: streams == the dense engine's; {pool_events['blocked']}"
          f" admissions blocked at the head of the queue, "
          f"{pool_events['evicted']} registry entries evicted, "
          f"{eng.stats.prefix_hits} prefix hits, audit() held after every "
          "step", flush=True)
    step_checks["short pool"] = dict(pool_events,
                                     prefix_hits=eng.stats.prefix_hits)
    del eng, dense

    # plain (bf16) weights: the linears are cuBLAS products and the SwiGLU
    # runs alone, the only path that still launches it
    label = ("plain-weight leg (4 layers, bf16 weights, bf16 cache, "
             "chunked admission)")
    eng = ServingEngine(model4, params4, slots=4, max_len=1024,
                        sampling=SamplingConfig(), megastep_k=8,
                        kv_quant="bf16")
    check(eng.quant_policy == "bf16" and not any(
        isinstance(leaf, QuantizedTensor) for layer in params4["layers"]
        for leaf in layer["mlp"]["w_gate_up"].values()),
          f"{label}: the weights are quantized")
    zero_counts()
    for r in serve.make_requests(cfg4.vocab_size, 2, 4, seed=5):
        eng.submit(r)
    eng.run()
    warm, after_warm = eng.stats, ops.launch_counts()
    eng.reset()
    reqs = serve.make_requests(cfg4.vocab_size, 6, 16, seed=1)
    for r in reqs:
        eng.submit(r)
    with kernels_only(quantized=False):
        eng.run()
    torch.cuda.synchronize()
    counts["plain"] = check_served(eng, reqs, label, warm, after_warm)
    step_checks["plain"] = step_vs_plain(eng, label)
    plain_prof = profile_served(
        eng, lambda: serve.make_requests(cfg4.vocab_size, 6, 16, seed=1))[0]
    step_checks["plain"].update(plain_prof)
    del eng

    # the same 4 layers under V0, the weights cut by columns from the
    # plain leg's: cuBLAS writes q, k and v (and g and u) into one row
    # through torch.mm(out=); the profile holds no copy kernel more than
    # the fused leg's
    label = ("V0 plain-weight leg (4 layers, bf16 weights, wq / wk / wv "
             "and w_gate / w_up apart)")
    model4_v0 = Model(dataclasses.replace(cfg4, scheduler_version="v0"),
                      device=dev)
    params4_v0 = as_v0(params4, cfg4)
    eng, warm, after_warm = warmed_engine(model4_v0, params4_v0)
    reqs = serve.make_requests(cfg4.vocab_size, 6, 16, seed=1)
    for r in reqs:
        eng.submit(r)
    with kernels_only(quantized=False):
        eng.run()
    torch.cuda.synchronize()
    v0_counts["v0 plain"] = check_served(eng, reqs, label, warm, after_warm)
    for r in reqs:
        check(r.output == model4_v0.reference_decode(
            params4_v0, r.prompt, r.max_new_tokens, max_len=1024),
            f"{label}: request {r.uid} differs from reference_decode")
    step_checks["v0 plain"] = step_vs_plain(eng, label)
    prof = profile_served(
        eng, lambda: serve.make_requests(cfg4.vocab_size, 6, 16, seed=1))[0]
    check(prof["copy_kernels_per_megastep"]
          == plain_prof["copy_kernels_per_megastep"],
          f"{label}: {prof['copy_kernels_per_megastep']} copy kernels a "
          f"megastep, the fused leg's "
          f"{plain_prof['copy_kernels_per_megastep']}")
    step_checks["v0 plain"].update(prof)
    print(f"  {label}: streams == reference_decode; "
          f"{prof['events_per_megastep']} CUDA events a megastep (fused "
          f"{plain_prof['events_per_megastep']}), "
          f"{prof['copy_kernels_per_megastep']:.0f} copy kernels a megastep"
          " as the fused leg's", flush=True)
    del eng, model4_v0, params4_v0

    # the stochastic leg: sampled requests beside greedy ones, through
    # the sampling graph
    smp = SamplingConfig(temperature=0.8, top_k=40, top_p=0.95)
    label = ("stochastic leg (4 layers, q4_0 weights, q8_0 cache, "
             f"temperature {smp.temperature}, top-k {smp.top_k}, top-p "
             f"{smp.top_p})")
    print(label, flush=True)
    eng = ServingEngine(model4, params4, slots=4, max_len=1024,
                        sampling=smp, megastep_k=8, quant_policy="q4_0",
                        kv_quant="q8_0", seed=7)

    def hot_requests():
        reqs = serve.make_requests(cfg4.vocab_size, 6, 16, seed=2)
        reqs[0].temperature = 0.0       # a greedy row among sampled ones
        reqs[1].top_k = 1               # filters that leave the argmax
        reqs[2].top_p = 1e-6
        return reqs

    zero_counts()
    for r in hot_requests():            # warmup: the same mix of rows
        eng.submit(r)
    eng.run()
    warm, after_warm = eng.stats, ops.launch_counts()
    runs = []
    for _ in range(2):
        eng.reset()
        runs.append(hot_requests())
        for r in runs[-1]:
            eng.submit(r)
        eng.run()
        torch.cuda.synchronize()
        check_served(eng, runs[-1], label, warm, after_warm)
    check(False in eng.graph_launches, f"{label}: no sampling graph")
    first = [r.output for r in runs[0]]
    check(first == [r.output for r in runs[1]],
          f"{label}: two runs with one seed served other tokens")
    for r in runs[0][:3]:
        ref = eng.model.reference_decode(eng.params, r.prompt,
                                         r.max_new_tokens, max_len=1024)
        check(ref == r.output, f"{label}: request {r.uid} (greedy, top-k "
              "1 or top-p 1e-6) differs from reference_decode")
    neg_inf = torch.tensor(float("-inf"), device=dev)
    for r in runs[0][3:]:
        # each sampled token lies inside the top-k / top-p filter of its
        # logits: the request replayed through decode_step (B 1)
        cache = eng.model.init_cache(1, 1024)
        tok = torch.empty((1, 1), dtype=torch.long, device=dev)
        for t in r.prompt:
            tok.fill_(int(t))
            logits = eng.model.decode_step(eng.params, tok, cache)
        for t in r.output:
            lf = logits[0].float() / smp.temperature
            V = lf.shape[-1]
            lf = torch.where(lf < torch.sort(lf).values[V - smp.top_k],
                             neg_inf, lf)
            desc = torch.sort(lf, descending=True).values
            cum = torch.cumsum(torch.softmax(desc, dim=-1), dim=-1)
            cutoff = desc[min(int((cum < smp.top_p).sum()), V - 1)]
            check(bool(lf[t] >= cutoff), f"{label}: request {r.uid} drew "
                  f"token {t} outside its top-k / top-p filter")
            tok.fill_(t)
            logits = eng.model.decode_step(eng.params, tok, cache)
    print(f"  {label}: greedy, top-k 1 and top-p 1e-6 rows == "
          "reference_decode; sampled tokens inside their filters; two runs "
          f"with seed {eng.seed} gave the same tokens; graphs "
          + str(sorted("greedy" if k else "sampling"
                       for k in eng.graph_launches)),
          flush=True)
    # the sampler's filters alone, on the card: 300 draws of 4 rows
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    lg = randn(4, 64)
    draws = torch.stack([sample_batched(
        lg, g, torch.tensor([0.0, 1.0, 1.0, 0.7], device=dev),
        torch.tensor([0, 1, 5, 0], dtype=torch.int32, device=dev),
        torch.tensor([1.0, 1.0, 1.0, 0.5], device=dev)) for _ in range(300)])
    am = lg.argmax(-1).int()
    p3 = torch.softmax(lg[3] / 0.7, -1)
    order = p3.argsort(descending=True)
    keep = int((p3[order].cumsum(0) < 0.5).sum()) + 1
    check(bool((draws[:, 0] == am[0]).all() and (draws[:, 1] == am[1]).all())
          and set(draws[:, 2].tolist()) <= set(lg[2].topk(5).indices.tolist())
          and len(set(draws[:, 2].tolist())) > 1
          and set(draws[:, 3].tolist()) <= set(order[:keep].tolist()),
          "sample_batched: a draw outside its row's filter")
    print("  sample_batched on the card: greedy and top-k 1 rows exact, "
          "top-k 5 and top-p 0.5 draws inside their filters (300 draws)",
          flush=True)
    del eng, params4
    torch.cuda.empty_cache()

    # -- 9. paper models: the paper's Fig. 4 grid on the card ----------------
    def weight_floor(engine):
        """(ms, bytes) of the weight-streaming floor of one decode step:
        every layer weight as stored (a quantized one's payload and
        scales) and the unembedding (a tied table whole at bf16, an
        untied head as stored) read once at the card's memory rate."""
        def nbytes(node):
            if isinstance(node, QuantizedTensor):
                return sum(t.numel() * t.element_size()
                           for t in (node.data, node.scales))
            if isinstance(node, dict):
                return sum(nbytes(v) for v in node.values())
            if isinstance(node, list):
                return sum(nbytes(v) for v in node)
            return node.numel() * node.element_size()
        p = engine.params
        head = p["embedding"] if engine.cfg.tie_embeddings else p["lm_head"]
        total = nbytes(p["layers"]) + nbytes(head) + nbytes(p["final_norm"])
        return total / HBM_BYTES_PER_S * 1e3, total

    def paper_cell(name, fmt):
        """One cell of the grid: the model at full width and depth under
        ``fmt`` weights and a bf16 cache, served by ``launch.serve``
        through the main path's traffic on 4 slots, then its first
        request alone on a 1-slot engine (the paper's single user). Each
        run: launch counts, every stream against ``reference_decode``;
        the 4-slot run also one decode step against the plain versions
        beside the planted fault, and the weight-streaming floor."""
        cell = {}
        for slots in (4, 1):
            zero_counts()
            with kernels_only(quantized=fmt != "bf16"):
                res = serve.main([
                    "--arch", name, "--no-reduced", "--precision", fmt,
                    "--kv-quant", "bf16", "--slots", str(slots),
                    "--max-len", "1024", "--megastep-k", "8",
                    "--requests", "8" if slots == 4 else "1",
                    "--max-new", "32", "--temperature", "0",
                    "--device", "cuda"])
            torch.cuda.synchronize()
            eng = res.engine
            label = f"{name} ({fmt} weights, {slots} slot(s))"
            counts[f"paper {name} {fmt}" + ("" if slots == 4 else
                                            " alone")] = check_served(
                eng, res.requests, label, res.warmup_stats,
                res.launches_after_warmup)
            for r in res.requests:
                check(r.output == eng.model.reference_decode(
                    eng.params, r.prompt, r.max_new_tokens, max_len=1024),
                    f"{label}: request {r.uid} stream differs from "
                    "reference_decode")
            st = eng.stats
            cell[f"slots{slots}"] = dict(
                ms_per_step=1e3 * st.decode_wall_s / st.steps,
                tok_s=st.tokens_generated / st.decode_wall_s,
                steps=st.steps, tokens=st.tokens_generated)
            if slots == 4:
                cell.update(step_vs_plain(eng, label, seeds=1))
                floor_ms, floor_bytes = weight_floor(eng)
                cell.update(floor_ms=floor_ms, weight_bytes=floor_bytes,
                            peak_gb=torch.cuda.max_memory_allocated() / 1e9)
            del eng, res
            torch.cuda.empty_cache()
        s4, s1 = cell["slots4"], cell["slots1"]
        print(f"  {name} {fmt}: {s4['ms_per_step']:.3f} ms a step, "
              f"{s4['tok_s']:.1f} tok/s at 4 slots; {s1['ms_per_step']:.3f}"
              f" ms a step, {s1['tok_s']:.1f} tok/s alone; weight-streaming "
              f"floor {cell['floor_ms']:.3f} ms "
              f"({cell['weight_bytes'] / 1e9:.3f} GB); streams == "
              "reference_decode (8 requests and the "
              "one alone)", flush=True)
        return cell

    def paper_stall_leg(name):
        """The model at full width and depth, q8_0 weights, under stall
        admission: prompts of 300, 310, 480 and 500 tokens share one
        4 x 512 prefill (flash_attention at the model's (head_dim, G),
        the prefill RoPE + cache write with its bias); launch counts,
        streams against ``reference_decode(stepwise_prefill=False)``, one
        fused prefill against the plain versions beside the planted
        lookahead fault."""
        model = Model(get_config(name), device=dev)
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        eng = ServingEngine(model, model.init(g, quantize=False), slots=4,
                            max_len=1024, sampling=SamplingConfig(),
                            megastep_k=8, quant_policy="q8_0",
                            admission="stall")
        rng = np.random.default_rng(2)
        prompts = [rng.integers(1, model.cfg.vocab_size, n).astype(np.int32)
                   for n in PREFILL_PROMPTS[:4]]
        zero_counts()
        eng.submit(Request(uid=-1, prompt=prompts[0], max_new_tokens=2))
        eng.run()
        warm, after_warm = eng.stats, ops.launch_counts()
        eng.reset()
        reqs = [Request(uid=i, prompt=p, max_new_tokens=8)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        with kernels_only():
            eng.run()
        torch.cuda.synchronize()
        label = f"{name} (q8_0 weights, stall admission)"
        counts[f"paper {name} stall"] = check_served(eng, reqs, label, warm,
                                                     after_warm)
        check(eng.stats.prefill_batches == 1, f"{label}: "
              f"{eng.stats.prefill_batches} prefill calls, not one bucket")
        for r in (reqs[0], reqs[3]):
            check(r.output == eng.model.reference_decode(
                eng.params, r.prompt, 8, max_len=1024,
                stepwise_prefill=False), f"{label}: request {r.uid} "
                "differs from reference_decode(stepwise_prefill=False)")
        out = prefill_vs_plain(eng, list(PREFILL_PROMPTS[:4]), label,
                               seeds=1)
        print(f"  {label}: one 4 x 512 prefill; streams == reference_decode"
              "(stepwise_prefill=False) (requests 0, 3)", flush=True)
        del eng, model
        torch.cuda.empty_cache()
        return out

    def window_leg():
        """mistral-7b at full width and depth, q8_0 weights, stall
        admission, max_len 8192: every slot's cache is a ring of 4096
        positions. A 4500-token prompt (an exact-length bucket: the ring
        write, and flash_attention with window 4096 over its 4500
        positions) and a 4080-token one (a 4096 bucket) whose 32 new
        tokens cross the ring's edge; launch counts, both streams against
        ``reference_decode(stepwise_prefill=False, max_len=8192)``."""
        model = Model(mis, device=dev)
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        eng = ServingEngine(model, model.init(g, quantize=False), slots=2,
                            max_len=8192, sampling=SamplingConfig(),
                            megastep_k=8, quant_policy="q8_0",
                            admission="stall", page_size=PAGE)
        label = ("window leg (mistral-7b, q8_0 weights, stall admission, "
                 "max_len 8192)")
        check(not eng.paged and eng._cache_seq == mis.sliding_window
              and Model.cache_len(eng.cache) == mis.sliding_window,
              f"{label}: the cache is not a dense ring of the window")
        rng = np.random.default_rng(12)
        long_p, edge_p = (rng.integers(1, mis.vocab_size, n).astype(np.int32)
                          for n in (4500, 4080))
        zero_counts()
        eng.submit(Request(uid=-1, prompt=edge_p[:9], max_new_tokens=2))
        eng.run()
        warm, after_warm = eng.stats, ops.launch_counts()
        eng.reset()
        reqs = [Request(uid=0, prompt=long_p, max_new_tokens=16),
                Request(uid=1, prompt=edge_p, max_new_tokens=32)]
        for r in reqs:
            eng.submit(r)
        t0 = time.perf_counter()
        with kernels_only():
            eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts["window"] = check_served(eng, reqs, label, warm, after_warm)
        check(eng._bucket_len(4500) == 4500 and eng._bucket_len(4080) == 4096
              and eng.stats.prefill_batches == 2,
              f"{label}: buckets {eng._bucket_len(4500)}, "
              f"{eng._bucket_len(4080)}; {eng.stats.prefill_batches} calls")
        for r in reqs:
            check(r.output == eng.model.reference_decode(
                eng.params, r.prompt, r.max_new_tokens, max_len=8192,
                stepwise_prefill=False), f"{label}: request {r.uid} differs "
                "from reference_decode(stepwise_prefill=False)")
        print(f"  {label}: a 4500-token prompt through the ring write and "
              "the windowed prefill attention, a 4080-token one whose decode"
              " crosses ring slot 4096; both streams == reference_decode("
              f"stepwise_prefill=False); {wall:.3f} s served", flush=True)
        del eng, model
        torch.cuda.empty_cache()
        return dict(served_s=wall, prefill_batches=2)

    print("paper models: the paper's six models at full width and depth, "
          "bf16 / q8_0 / q4_0 weights, bf16 cache", flush=True)
    paper = {}
    for name in PAPER_ORDER:
        for fmt in ("bf16", "q8_0", "q4_0"):
            paper[f"{name} {fmt}"] = paper_cell(name, fmt)
        if name != "llama3.2-1b":
            paper[f"{name} stall"] = paper_stall_leg(name)
    paper["window"] = window_leg()
    print("Fig. 4 on the H100 (ms a step at 4 slots / alone, tok/s at 4 "
          "slots / alone, weight-streaming floor ms):", flush=True)
    for name in PAPER_ORDER:
        for fmt in ("bf16", "q8_0", "q4_0"):
            c = paper[f"{name} {fmt}"]
            print(f"  {name:16s} {fmt:5s} {c['slots4']['ms_per_step']:7.3f} "
                  f"/ {c['slots1']['ms_per_step']:7.3f} ms  "
                  f"{c['slots4']['tok_s']:8.1f} / {c['slots1']['tok_s']:7.1f}"
                  f" tok/s  floor {c['floor_ms']:.3f} ms", flush=True)

    # -- 13. the assigned dense models at full width and depth --------------
    dense_counts = {}  # launches on these paths, into ``counts`` below

    def float_tree_bytes(model):
        """(bf16 bytes of the whole float tree, elements of its largest
        matrix) from the model's parameter specs."""
        total, largest = 0, 0

        def walk(node):
            nonlocal total, largest
            if isinstance(node, dict):
                for v in node.values():
                    walk(v)
            elif isinstance(node, list):
                for v in node:
                    walk(v)
            else:
                n = math.prod(node.shape)
                total += 2 * n
                if len(node.shape) >= 2:
                    largest = max(largest, n)
        walk(model.param_specs())
        return total, largest

    @contextlib.contextmanager
    def init_peak(record):
        """``Model.init`` records the card's peak allocation over the
        memory allocated before it: the quantized tree, one matrix's f32
        draw and bf16 copy, and one 4096-column block's quantization
        temporaries at most, never the float tree."""
        real = Model.init

        def init(self, *a, **kw):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            params = real(self, *a, **kw)
            torch.cuda.synchronize()
            tree, largest = float_tree_bytes(self)
            record.update(peak_bytes=torch.cuda.max_memory_allocated() - base,
                          params_bytes=serve._nbytes(params),
                          float_tree_bytes=tree, largest_matrix=largest)
            return params
        Model.init = init
        try:
            yield
        finally:
            Model.init = real

    def dense_cell(name, fmt, base_alloc):
        """The model at full width and depth under ``fmt`` weights and a
        bf16 cache: served by ``launch.serve`` through the main path's
        traffic on 4 slots (launch counts, every stream against
        ``reference_decode``, ms a step beside the CLI's floor, the init's
        peak), then its first request alone on a 1-slot engine (one decode
        step from its cache against the plain versions beside the planted
        fault) and,
        in the model's stall format, one 512-token prompt under stall
        admission (a 1 x 512 prefill against the plain versions beside the
        planted lookahead fault); all its memory freed before the next."""
        t0 = time.perf_counter()
        rec = {}
        zero_counts()
        with init_peak(rec), kernels_only(quantized=fmt != "bf16"):
            res = serve.main([
                "--arch", name, "--no-reduced", "--precision", fmt,
                "--kv-quant", "bf16", "--slots", "4", "--max-len", "1024",
                "--megastep-k", "8", "--requests", "8", "--max-new", "32",
                "--temperature", "0", "--device", "cuda"])
        torch.cuda.synchronize()
        eng = res.engine
        label = f"{name} ({fmt} weights, 4 slots)"
        dense_counts[f"dense {name} {fmt}"] = check_served(
            eng, res.requests, label, res.warmup_stats,
            res.launches_after_warmup)
        for r in res.requests:
            check(r.output == eng.model.reference_decode(
                eng.params, r.prompt, r.max_new_tokens, max_len=1024),
                f"{label}: request {r.uid} stream differs from "
                "reference_decode")
        # the init: the quantized tree plus one matrix's draw (f32 and
        # bf16, 6 bytes an element) and one column block's temporaries
        # (2^25 elements), never the float tree
        slack = 6 * rec["largest_matrix"] + 2 ** 30
        check(rec["peak_bytes"] <= rec["params_bytes"] + slack,
              f"{label}: Model.init peaked at {rec['peak_bytes']} bytes, "
              f"over the tree's {rec['params_bytes']} + one matrix's draw")
        check(fmt == "bf16" or rec["peak_bytes"] < rec["float_tree_bytes"],
              f"{label}: Model.init peaked at {rec['peak_bytes']} bytes, "
              f"the float tree's {rec['float_tree_bytes']}")
        cell = dict(slots4=served_ms(eng), floor_ms=res.floor["ms"],
                    weight_bytes=res.floor["bytes"], init=rec,
                    peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        cell["x_floor"] = cell["slots4"]["ms_per_step"] / cell["floor_ms"]
        model, params, first = eng.model, eng.params, res.requests[0]
        del eng, res
        gc.collect()
        torch.cuda.empty_cache()
        # the paper's single user: the first request alone on one slot
        eng, warm, after = warmed_engine(model, params, slots=1,
                                         quant_policy=fmt)
        req = Request(uid=0, prompt=first.prompt, max_new_tokens=32)
        eng.submit(req)
        with kernels_only(quantized=fmt != "bf16"):
            eng.run()
        torch.cuda.synchronize()
        label1 = f"{name} ({fmt} weights, 1 slot)"
        dense_counts[f"dense {name} {fmt} alone"] = check_served(
            eng, [req], label1, warm, after)
        check(req.output == first.output, f"{label1}: the stream differs "
              "from the same request's among 4 slots (== reference_decode)")
        cell["slots1"] = served_ms(eng)
        # the decode step against the plain versions from this engine's
        # one-slot cache: at deepseek-67b's 72.4 GB of q8_0 weights the
        # plain versions' f32 copy of a matrix (3.4 GB for its head) and
        # a 4-slot cache with its clone (3.2 GB) do not fit beside them
        gc.collect()
        torch.cuda.empty_cache()
        cell["step_check_allocated_gb"] = torch.cuda.memory_allocated() / 1e9
        cell.update(step_vs_plain(eng, label1, seeds=1))
        del eng
        if fmt == DENSE_STALL[name]:
            eng, warm, after = warmed_engine(model, params, slots=1,
                                             quant_policy=fmt,
                                             admission="stall")
            rng = np.random.default_rng(13)
            req = Request(uid=0, prompt=rng.integers(
                1, model.cfg.vocab_size, 512).astype(np.int32),
                max_new_tokens=8)
            eng.submit(req)
            with kernels_only(quantized=fmt != "bf16"):
                eng.run()
            torch.cuda.synchronize()
            label_s = f"{name} ({fmt} weights, stall admission, 1 x 512)"
            dense_counts[f"dense {name} stall"] = check_served(
                eng, [req], label_s, warm, after)
            check(eng.stats.prefill_batches == 1, f"{label_s}: "
                  f"{eng.stats.prefill_batches} prefill calls")
            check(req.output == model.reference_decode(
                params, req.prompt, 8, max_len=1024, stepwise_prefill=False),
                f"{label_s}: the stream differs from reference_decode("
                "stepwise_prefill=False)")
            cell["stall"] = prefill_vs_plain(eng, [512], label_s, seeds=1)
            del eng
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
        left = torch.cuda.memory_allocated() - base_alloc
        check(left < 2 ** 28, f"{name} {fmt}: {left} bytes still allocated "
              "after the cell")
        cell["cell_s"] = time.perf_counter() - t0
        s4, s1, ini = cell["slots4"], cell["slots1"], cell["init"]
        print(f"  {name} {fmt}: {s4['ms_per_step']:.3f} ms a step, "
              f"{s4['tok_s']:.1f} tok/s at 4 slots ({cell['x_floor']:.2f}x "
              f"the floor {cell['floor_ms']:.3f} ms, "
              f"{cell['weight_bytes'] / 1e9:.3f} GB); "
              f"{s1['ms_per_step']:.3f} ms a step, {s1['tok_s']:.1f} tok/s "
              f"alone; init peak {ini['peak_bytes'] / 1e9:.3f} GB for a "
              f"{ini['params_bytes'] / 1e9:.3f} GB tree (the float tree "
              f"{ini['float_tree_bytes'] / 1e9:.3f} GB); streams == "
              f"reference_decode; {cell['cell_s']:.1f} s", flush=True)
        return cell

    def dense_quant_cache_leg(kvq):
        """deepseek-67b's (128, 8) decode attention over a quantized
        cache: its first 4 layers at full width, q4_0 weights, through
        ``launch.serve --num-layers 4 --kv-quant``."""
        zero_counts()
        with kernels_only():
            res = serve.main([
                "--arch", "deepseek-67b", "--no-reduced", "--num-layers", "4",
                "--precision", "q4_0", "--kv-quant", kvq, "--slots", "4",
                "--max-len", "1024", "--megastep-k", "8", "--requests", "8",
                "--max-new", "16", "--temperature", "0", "--device", "cuda"])
        torch.cuda.synchronize()
        eng = res.engine
        label = f"deepseek-67b (4 layers, q4_0 weights, {kvq} cache)"
        dense_counts[f"dense deepseek-67b 4 layers {kvq} cache"] = \
            check_served(eng, res.requests, label, res.warmup_stats,
                         res.launches_after_warmup)
        for r in res.requests:
            check(r.output == eng.model.reference_decode(
                eng.params, r.prompt, r.max_new_tokens, max_len=1024),
                f"{label}: request {r.uid} differs from reference_decode")
        out = step_vs_plain(eng, label, seeds=1)
        print(f"  {label}: streams == reference_decode", flush=True)
        del eng, res
        torch.cuda.empty_cache()
        return out

    t_phase = time.perf_counter()
    print("assigned dense models: mistral-nemo-12b, deepseek-67b and "
          "qwen1.5-110b at full width and depth, each weight quantized as "
          "it is drawn", flush=True)
    gc_base = torch.cuda.memory_allocated()
    dense = {}
    for name, fmts in DENSE_CELLS:
        for fmt in fmts:
            dense[f"{name} {fmt}"] = dense_cell(name, fmt, gc_base)
    for kvq in ("q8_0", "q4_0"):
        dense[f"deepseek-67b 4 layers {kvq} cache"] = \
            dense_quant_cache_leg(kvq)
    dense["phase_s"] = time.perf_counter() - t_phase
    print("the assigned dense models on the H100 (ms a step at 4 slots / "
          "alone, tok/s at 4 slots, x the weight-streaming floor, init peak "
          "GB / tree GB):", flush=True)
    for name, fmts in DENSE_CELLS:
        for fmt in fmts:
            c = dense[f"{name} {fmt}"]
            print(f"  {name:16s} {fmt:5s} {c['slots4']['ms_per_step']:7.3f} "
                  f"/ {c['slots1']['ms_per_step']:7.3f} ms  "
                  f"{c['slots4']['tok_s']:8.1f} tok/s  floor "
                  f"{c['floor_ms']:.3f} ms ({c['x_floor']:.2f}x)  init "
                  f"{c['init']['peak_bytes'] / 1e9:.2f} / "
                  f"{c['init']['params_bytes'] / 1e9:.2f} GB", flush=True)
    print(f"assigned dense phase: {dense['phase_s']:.1f} s (its kernel cases "
          f"took {dense_cases_s:.1f} s in phase 3)", flush=True)

    # -- 11. the kernel line --------------------------------------------------
    counts.update(moe_counts)
    counts.update(ssm_counts)
    counts.update(hybrid_counts)
    counts.update(v0_counts)
    counts.update(dense_counts)
    for row in rows.values():
        kernel = row["name"].split("[")[0]
        path = row.pop("path")
        row["launches"] = counts[path][kernel]
        check(row["launches"] > 0, f"{row['name']}: no launch on the "
              f"{path} path")
    print(json.dumps({"main_path": main_path, "prefill_path": prefill_path,
                      "paged_path": paged_path, "under_load": load,
                      "second_path_step_checks": step_checks,
                      "paper_models": paper, "moe": moe, "ssm": ssm,
                      "hybrid": hybrid,
                      "prefill_chunk_4": chunk_leg, "v0": v0_main,
                      "dense_models": dense,
                      "unembed_rows_equal_across_m": unembed_rows_equal,
                      "decode_attention_two_streams":
                          attention_stream_readings}))
    print(json.dumps({"kernels": list(rows.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"chip_smoke: done in {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)
