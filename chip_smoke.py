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
   pair, with no ptxas spill; the fused RMSNorm, residual
   add + RMSNorm (h bit-equal) and SwiGLU kernels at M 4 and 2048, the
   decode RoPE + cache write in the three cache formats, with ring slots
   S - 1 and S and frozen rows, and the prefill RoPE + cache write at the
   prefill buckets in the three formats (bit-equal but on .5 ties of the
   quantized payloads);
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
   expected events;
5. prefill path: the same model at full width and depth with stall
   admission, 8 requests with prompts of 270-900 tokens (buckets of 512
   and 1024 positions); checks launch counts, the streams against
   ``reference_decode(stepwise_prefill=False)``, and one fused prefill
   of the first bucket through the kernels against the plain versions
   (beside a planted lookahead fault); times each prefill and profiles
   them for the device's idle share;
6. second path: full width, 4 layers, q4_0 weights with a q8_0 and then
   a q4_0 cache (the q4 GEMV and both quantized attention loaders), then
   both caches again under stall admission, with the same
   launch-count and decode-step checks; then the same 4 layers with
   bf16 weights (cuBLAS linears and the standalone SwiGLU kernel); then
   a stochastic leg
   (temperature 0.8) through the sampling graph: greedy rows exact,
   sampled tokens inside their top-k / top-p filters, the same tokens
   from two runs with one seed;
7. one ``{"kernels": [...]}`` line, the card line, and the last line
   ``{"ok": true, "device": {...}}``.

Exits nonzero without printing a result when CUDA is unavailable, or
when run outside a checkout of the repository.
"""
from __future__ import annotations

import contextlib
import dataclasses
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


def cuda_events(fn, args_list, calls: int) -> list:
    """The CUDA events (kernels, copies, fills) of a torch.profiler trace
    of ``calls`` calls of fn, cycling through ``args_list``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(*args_list[i % len(args_list)])
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


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


# a kernel's group is the first whose name its name holds: add_rmsnorm
# before rmsnorm, the prefill RoPE before the decode one, the fused
# gate-up GEMM before quant_matmul
GROUPS = ("decode_attention", "quant_matmul_swiglu", "quant_matmul",
          "add_rmsnorm", "rmsnorm", "swiglu", "rope_cache_write_prefill",
          "rope_cache_write", "flash_attention", "memcpy", "other")


def group_of(name: str) -> str:
    """The kernel group a CUDA event of a profiler trace belongs to."""
    if "sum_splits_swiglu" in name:
        return "quant_matmul_swiglu"
    if "sum_splits" in name:
        return "quant_matmul"
    if "Memcpy" in name or "memcpy" in name:
        return "memcpy"
    return next((g for g in GROUPS[:-2] if g in name), "other")


def profile_served(engine, make_requests):
    """Where the served run's time goes: the requests of
    ``make_requests()`` served again by the same (reset) engine, the
    whole run under torch.profiler tracing the card only. Every
    megastep is the same program (one copy in, one graph replay, one
    copy out), so the trace must hold exactly that many CUDA events a
    megastep: ``events_per_call`` of one megastep. A trace
    that holds another count (the profiler now and then drops events,
    which would read too low) is taken again, up to five times, and
    then fails the run. The device's idle share is 1 - the events'
    time / this run's own wall time in ``step()``; its ms per step beside
    the unprofiled run's is what the tracing costs. Returns the numbers
    and the requests of the accepted trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine.reset()
    for r in make_requests():
        engine.submit(r)
    per_megastep = events_per_call(engine.step, [()], "a megastep")
    for attempt in range(1, 6):
        engine.reset()
        requests = make_requests()
        for r in requests:
            engine.submit(r)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            engine.run()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        want = per_megastep * engine.stats.megasteps
        print(f"  profile attempt {attempt}: {len(events)} CUDA events, "
              f"expected {want} ({per_megastep} a megastep x "
              f"{engine.stats.megasteps})", flush=True)
        if len(events) == want:
            break
    check(len(events) == want, f"the served run's trace holds {len(events)} "
          f"CUDA events, not {want}, after {attempt} attempts")
    st = engine.stats
    wall_ms = st.decode_wall_s * 1e3
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
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
                profile_attempts=attempt), requests


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
                                                      num_splits)
    from repro_torch.kernels.decode_attention_quant import (
        decode_attention_quant, decode_attention_quant_plain)
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels import fused_ops
    from repro_torch.kernels.fused_ops import (
        add_rmsnorm, add_rmsnorm_plain, rmsnorm, rmsnorm_plain,
        rope_cache_write, rope_cache_write_plain, rope_cache_write_prefill,
        rope_cache_write_prefill_plain, swiglu, swiglu_plain)
    from repro_torch.kernels.quant_matmul import (
        launch_grid, quant_matmul, quant_matmul_plain, quant_matmul_swiglu,
        quant_matmul_swiglu_plain)
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.quant import (QuantizedTensor, dequantize,
                                   dequantize_rows, quantize, quantize_rows,
                                   unpack_int4_rows)
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
    # flash_attention overlaps its wgmma groups with the softmax; ptxas
    # may serialize them instead, which it reports
    for stem in sorted(libs):
        notes = build.perf_notes(stem)
        print(f"  ptxas on {stem}.cu: {len(notes)} performance warnings"
              + "".join(f"\n    {n[:200]}" for n in notes), flush=True)
        check(stem != "flash_attention" or not notes,
              "ptxas serialized flash_attention.cu's wgmma groups")
    # the fused gate-up kernels keep quant_matmul's budget (two CTAs an
    # SM, at most 128 registers a thread) without spilling
    for fn, regs, st_b, ld_b in build.ptxas_usage("quant_matmul"):
        short = re.search(r"[a-z_]*swiglu(_split)?_kernel(I\w*?EE)?", fn)
        if not short:
            continue
        print(f"  ptxas on quant_matmul.cu: {short.group(0)}: {regs} "
              f"registers, {st_b} / {ld_b} bytes spill stores / loads",
              flush=True)
        check(st_b == 0 and ld_b == 0, f"ptxas spilled registers in {fn}")
    # the profiler's first window starts its tracing; keep that out of
    # the timed ones
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1024, device=dev).sum()
        torch.cuda.synchronize()

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

    @contextlib.contextmanager
    def plain_versions(fault: bool = False):
        """Route the model's kernel calls to the plain versions (the
        reference pass of the kernel-vs-plain checks), with the planted
        faults in the attention where ``fault``."""
        names = ("quant_matmul", "quant_matmul_swiglu", "decode_attention",
                 "decode_attention_quant", "flash_attention", "rmsnorm",
                 "add_rmsnorm", "swiglu", "rope_cache_write",
                 "rope_cache_write_prefill")
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
        try:
            yield
        finally:
            for n, fn in saved.items():
                setattr(ops, n, fn)

    @contextlib.contextmanager
    def kernels_only(quantized: bool = True):
        """While a path is served, the parts of the RoPE + cache-write
        plain versions refuse to run: every RoPE and cache write on the
        card goes through the fused kernels. With quantized weights the
        standalone SwiGLU refuses too: the gate-up GEMM computes it."""
        names = ("apply_rope", "kv_cache_write", "kv_cache_write_prefill")
        saved = {n: getattr(fused_ops, n) for n in names}
        saved_swiglu = ops.swiglu

        def refuse(*a, **kw):
            fail("a plain RoPE or cache write ran on the card in a served "
                 "path")

        def refuse_swiglu(*a, **kw):
            fail("the standalone SwiGLU ran in a served path with "
                 "quantized weights")
        for n in names:
            setattr(fused_ops, n, refuse)
        if quantized:
            ops.swiglu = refuse_swiglu
        try:
            yield
        finally:
            for n, fn in saved.items():
                setattr(fused_ops, n, fn)
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

    def randn(*shape, scale=1.0, g=None):
        return torch.randn(shape, generator=g or gen, device=dev) * scale

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cfg_full = get_config("llama3.2-1b")
    B, Hq, Hkv = 4, cfg_full.num_heads, cfg_full.num_kv_heads
    D, S = cfg_full.head_dim, 1024
    rows = {}          # kernel-table rows by name

    # -- 3. kernels against their plain versions ---------------------------
    def attention_case(fmt, b, hq, hkv, s, d, lens, window, timed):
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
            shape=shape, path="main" if fmt == "bf16" else f"second {fmt}",
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
        tol = (bf16_tol(ref) if out_dtype == torch.bfloat16
               else 1e-5 * float(ref.abs().max()))
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

    def qmm_swiglu_case(fmt, M, K, Fw, timed=False, path=None):
        """The gate-up GEMM with the SwiGLU as its last step: bit-equal to
        the unfused kernels (quant_matmul, then swiglu) on the card,
        within one bf16 ulp of the plain version, every row bit-equal to
        the same row alone (M 1); timed beside the unfused pair, in turns
        (fused, pair, pair, fused), where a path runs it."""
        x = randn(M, K, g=gen_gate_up).bfloat16()
        w = quantize(randn(K, 2 * Fw, scale=K ** -0.5, g=gen_gate_up), fmt)
        h = quant_matmul_swiglu(x, w)
        pair = swiglu(quant_matmul(x, w))
        ref = quant_matmul_swiglu_plain(x, w)
        torch.cuda.synchronize()
        ctas, splits, chunks = launch_grid(M, K, 2 * Fw, w.group)
        route = ("split-K merge" if splits > 1 else "two-CTA clusters")
        err = float((h.float() - ref.float()).abs().max())
        tol = bf16_tol(ref)
        name = f"quant_matmul_swiglu[{fmt} K{K} F{Fw}" + (
            "]" if M <= 8 else f" M{M}]")
        print(f"  {name} M{M} ({route}, {chunks} K chunks): bit-equal to "
              f"swiglu(quant_matmul(x, w)) {torch.equal(h, pair)}; "
              f"max_abs_err vs plain {err:.3e} (tol {tol:.3e})", flush=True)
        check(h.shape == (M, Fw) and torch.equal(h, pair),
              f"{name} M{M}: {int((h != pair).sum())} elements differ from "
              "swiglu(quant_matmul(x, w)) on the card")
        check(err <= tol, f"{name} M{M}: {err} > {tol}")
        if M > 1:
            for r in (0, M // 2, M - 1):
                alone = quant_matmul_swiglu(x[r:r + 1].contiguous(), w)
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
                    ms, c_ms = time_calls(quant_matmul_swiglu, copies, reps,
                                          per_call=per)
                    fused_runs.append(ms)
                    call_ms.append(c_ms)
                    attempts.append(time_calls.attempts)
                else:
                    pair_runs.append(time_calls(
                        lambda a, b: swiglu(quant_matmul(a, b)), copies,
                        reps, per_call=per + 1)[0])
        ms, pair_ms = sum(fused_runs) / 2, sum(pair_runs) / 2
        plain_ms, _ = time_calls(quant_matmul_swiglu_plain, copies, 10)
        rows[name] = dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/quant_matmul.cu",
            replaces="src/repro/kernels/quant_matmul.py:79",
            fuses="src/repro/models/mlp.py:42-48",
            shape=f"M{M} K{K} N{2 * Fw} -> h F{Fw}", path=path, launches=0,
            max_abs_err=err, tol=tol, ms=ms, call_ms=sum(call_ms) / 2,
            plain_ms=plain_ms, bound_ms=t_bound, bound_by=by,
            library_ms=None, library=None, unfused_ms=pair_ms,
            unfused="quant_matmul then swiglu, the kernels at this shape",
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

    def flash_case(b, hq, hkv, sq, skv, d, window, q_offset, timed):
        q = randn(b, hq, sq, d).bfloat16()
        k = randn(b, hkv, skv, d).bfloat16()
        v = randn(b, hkv, skv, d).bfloat16()
        kw = dict(causal=True, window=window, q_offset=q_offset)
        out = flash_attention(q, k, v, **kw)
        ref = flash_attention_plain(q, k, v, **kw)
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
        # row, the spreads beside them
        kern_ms, lib_ms_all, call_ms_all, attempts = [], [], [], []
        for _ in range(3):
            ms, call_ms = time_calls(lambda *a: flash_attention(*a, **kw),
                                     copies, 100, per_call=1)
            kern_ms.append(ms)
            call_ms_all.append(call_ms)
            attempts.append(time_calls.attempts)
            lib_ms_all.append(time_calls(
                lambda qq, kk, vv: F.scaled_dot_product_attention(
                    qq, kk, vv, is_causal=True, enable_gqa=True),
                copies, 50)[0])
        ms, call_ms, lib_ms = (sorted(x)[1] for x in
                               (kern_ms, call_ms_all, lib_ms_all))
        plain_ms, _ = time_calls(lambda *a: flash_attention_plain(*a, **kw),
                                 copies, 5)
        pl = fa_mod.plan(b, hq, hkv, sq, skv, d, **kw, sms=sms)
        rows[f"flash_attention[B{b} S{sq}]"] = dict(
            name=f"flash_attention[B{b} S{sq}]", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:87",
            shape=shape, path="prefill", launches=0, max_abs_err=err,
            tol=tol, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
            bound_ms=t_bound, bound_by=by, library_ms=lib_ms,
            library="torch.nn.functional.scaled_dot_product_attention"
                    " (is_causal, enable_gqa)",
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
                  path=None):
        theta = cfg_full.rope_theta
        qkv = randn(b, (hq + 2 * hkv) * d).bfloat16()
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
        q = rope_cache_write(qkv, ck, lens_t, adv, theta, fmt)
        qp = rope_cache_write_plain(qkv, cp, lens_t, adv, theta, fmt)
        torch.cuda.synchronize()
        err = float((q.float() - qp.float()).abs().max())
        tol = bf16_tol(qp)
        shape = (f"B{b} Hq{hq} Hkv{hkv} S{s_len} D{d} lens{lens} "
                 f"advance{advance}")
        label = f"rope_cache_write[{fmt}] {shape}"
        check(err <= tol, f"{label}: q {err} > {tol}")
        written = torch.zeros((b, s_len), dtype=torch.bool, device=dev)
        for i, pos in enumerate(lens):
            written[i, pos % s_len] = advance is None or advance[i]
        frozen = ~written[:, None, :].expand(b, hkv, s_len)
        for n, leaf in ck.items():
            check(torch.equal(leaf[frozen], cache[n][frozen]),
                  f"{label}: {n} changed outside the written ring slots")
        kr = fused_ops.apply_rope(
            qkv[:, hq * d:(hq + hkv) * d].reshape(b, hkv, d), lens_t, theta)
        vr = qkv[:, (hq + hkv) * d:].reshape(b, hkv, d)
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
        fused_row(f"rope_cache_write[{fmt}]",
                  lambda a, c, ln, av: rope_cache_write(a, c, ln, av, theta,
                                                        fmt),
                  lambda a, c, ln, av: rope_cache_write_plain(
                      a, c, ln, av, theta, fmt), copies, nbytes,
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
                          path=None):
        """The prefill RoPE + cache write against its plain version: q,
        k, v and the bf16 cache rows bit-equal, quantized scales
        bit-equal and payloads one step off only on .5 ties, cache
        positions from s_len on untouched."""
        theta = cfg_full.rope_theta
        qkv = randn(b, s_len, (hq + 2 * hkv) * d, g=gen_added).bfloat16()
        old = randn(b, hkv, s_cache, d, g=gen_added).bfloat16()
        if fmt == "bf16":
            cache = {"k": old, "v": (old * 0.5).contiguous()}
        else:
            kq, ks = quantize_rows(old, fmt)
            vq, vs = quantize_rows(old * 0.5, fmt)
            cache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        ck = {n: t.clone() for n, t in cache.items()}
        cp = {n: t.clone() for n, t in cache.items()}
        got = rope_cache_write_prefill(qkv, ck, theta, fmt)
        want = rope_cache_write_prefill_plain(qkv, cp, theta, fmt)
        torch.cuda.synchronize()
        shape = f"B{b} S{s_len} S_cache{s_cache} Hq{hq} Hkv{hkv} D{d}"
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
                diff = (unpacked(ck[n][:, :, :s_len], fmt)
                        - unpacked(cp[n][:, :, :s_len], fmt)).abs()
                check(int(diff.max()) <= 1 and bool(
                    ((diff == 0) | ties(x, fmt, ng)).all()),
                    f"{label}: {n} payload off by more than one step, or "
                    "off where the division is no .5 tie")
                n_ties += int((diff > 0).sum())
        print(f"  {label}: q, k, v bit-equal; cache rows as the plain "
              f"version's ({n_ties} payload elements one step off on .5 "
              f"ties), positions from {s_len} on untouched", flush=True)
        if not timed:
            return
        row_bytes = sum(t[0, 0, 0].numel() * t.element_size()
                        for t in ck.values())
        nbytes = (2 * qkv.numel() + 2 * sum(t.numel() for t in got)
                  + b * hkv * s_len * row_bytes)
        copies = [(qkv, ck)] + [(qkv.clone(), ck) for _ in range(
            n_copies(qkv.numel() * 2) - 1)]
        fused_row(f"rope_cache_write_prefill[{fmt} B{b} S{s_len}]",
                  lambda a, c: rope_cache_write_prefill(a, c, theta, fmt),
                  lambda a, c: rope_cache_write_prefill_plain(a, c, theta,
                                                              fmt),
                  copies, nbytes, "src/repro/models/layers.py:51", shape,
                  path, err, 0.0)

    print("fused small ops vs plain versions on the card:", flush=True)
    d_model, d_ff = cfg_full.d_model, cfg_full.d_ff
    # the standalone SwiGLU runs only under plain weights (the plain-weight
    # leg of section 6): with quantized ones the gate-up GEMM computes it
    for M, path in ((B, "main"), (2048, "prefill")):
        rmsnorm_case(M, d_model, torch.bfloat16, timed=True, path=path)
        swiglu_case(M, d_ff, torch.bfloat16, timed=True, path="plain")
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

    # -- shared checks of a served path -------------------------------------
    def clone_cache(c):
        return {"lens": c["lens"].clone(),
                "layers": [{k: t.clone() for k, t in layer.items()}
                           for layer in c["layers"]]}

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
        versions with the planted faults."""
        out = {}
        for route in ("kernels", "plain", "fault"):
            ctx = (contextlib.nullcontext() if route == "kernels"
                   else plain_versions(fault=route == "fault"))
            with ctx:
                out[route] = run()
        torch.cuda.synchronize()
        return out

    def step_vs_plain(engine, label):
        """One decode step from the engine's current cache, for a few
        seeded token batches, judged against STEP_REL_TOL (the planted
        fault: the attention one position short)."""
        worst, fault_least = 0.0, math.inf
        for seed in range(STEP_SEEDS):
            g = torch.Generator(device=dev)
            g.manual_seed(seed)
            toks = torch.randint(1, engine.cfg.vocab_size,
                                 (engine.slots, 1), generator=g, device=dev)
            logits = three_routes(lambda: engine.model.decode_step(
                engine.params, toks, clone_cache(engine.cache)))
            err, fault = judge(logits, STEP_REL_TOL, f"{label} seed {seed}",
                               "decode_step")
            worst, fault_least = max(worst, err), min(fault_least, fault)
        return dict(max_rel_err=worst, fault_least_rel_err=fault_least)

    def prefill_vs_plain(engine, lens, label):
        """One fused prefill of a bucket with these true lengths, for a
        few seeded token batches, judged against PREFILL_REL_TOL (the
        planted fault: each query also sees the next key)."""
        n, S = len(lens), engine._bucket_len(max(lens))
        seq_lens = torch.tensor(lens, device=dev)
        worst, fault_least = 0.0, math.inf
        for seed in range(PREFILL_SEEDS):
            g = torch.Generator(device=dev)
            g.manual_seed(seed)
            toks = torch.randint(1, engine.cfg.vocab_size, (n, S),
                                 generator=g, device=dev)
            logits = three_routes(lambda: engine.model.prefill(
                engine.params, toks, engine.model.init_cache(
                    n, engine.max_len), seq_lens=seq_lens))
            err, fault = judge(logits, PREFILL_REL_TOL,
                               f"{label} seed {seed}",
                               f"prefill ({n} x {S}, seq_lens {lens})")
            worst, fault_least = max(worst, err), min(fault_least, fault)
        return dict(max_rel_err=worst, fault_least_rel_err=fault_least)

    def ffn_launches(engine, n):
        """The linears' and SwiGLU's launches over n layer passes: with
        quantized weights three quant_matmul (wqkv, wo, w_down) and the
        gate-up GEMM with its SwiGLU a layer; with plain weights the
        linears are library products and the SwiGLU runs alone."""
        quantized = engine.quant_policy in ("q8_0", "q4_0")
        return {"quant_matmul": 3 * n if quantized else 0,
                "quant_matmul_swiglu": n if quantized else 0,
                "swiglu": 0 if quantized else n}

    def per_megastep(engine):
        """Kernel launches of one megastep: K substeps of one attention,
        one RoPE + cache write, the linears and SwiGLU, and two residual
        adds with the RMSNorm after them per layer, and layer 0's
        RMSNorm alone (the final norm is the last layer's second
        add_rmsnorm)."""
        L, K = engine.cfg.num_layers, engine.megastep_k
        quant_cache = engine.kv_quant != "bf16"
        return {"decode_attention": 0 if quant_cache else L * K,
                "decode_attention_quant": L * K if quant_cache else 0,
                **ffn_launches(engine, L * K), "flash_attention": 0,
                "rmsnorm": K, "add_rmsnorm": 2 * L * K,
                "rope_cache_write": L * K, "rope_cache_write_prefill": 0}

    def per_prefill(engine):
        """Kernel launches of one prefill call (eager)."""
        L = engine.cfg.num_layers
        return {"decode_attention": 0, "decode_attention_quant": 0,
                **ffn_launches(engine, L), "flash_attention": L,
                "rmsnorm": 1, "add_rmsnorm": 2 * L,
                "rope_cache_write": 0, "rope_cache_write_prefill": L}

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
    check([r.output for r in replay] == [r.output for r in res.requests],
          "main path: the profiled replay served other tokens")
    del eng, res
    torch.cuda.empty_cache()

    # -- 5. prefill path: stall admission through the fused prefill -------
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

    # -- 6. second path: q4_0 weights, quantized caches, stall admission ----
    cfg4 = dataclasses.replace(cfg_full, num_layers=MAIN_LAYERS_SECOND_PATH)
    model4 = Model(cfg4, device=dev)
    params4 = model4.init(gen, quantize=False)
    counts = {"main": main_counts, "prefill": prefill_counts}
    step_checks = {}
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
        del eng

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
    del eng

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

    # -- 7. the kernel line ---------------------------------------------------
    for row in rows.values():
        kernel = row["name"].split("[")[0]
        path = row.pop("path")
        row["launches"] = counts[path][kernel]
        check(row["launches"] > 0, f"{row['name']}: no launch on the "
              f"{path} path")
    print(json.dumps({"main_path": main_path, "prefill_path": prefill_path,
                      "second_path_step_checks": step_checks,
                      "unembed_rows_equal_across_m": unembed_rows_equal}))
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
