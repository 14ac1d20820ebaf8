"""Time the RG-LRU prefill scan's kernel (``rglru_scan`` in
``src/repro_torch/kernels/csrc/rglru.cu``) at other splits of its work
on the card.

A scan CTA owns 32 channels of one sequence: ``kScanWarps`` producer
warps compute each position's a, b and gelu(gate) and store its y,
``kScanSteps`` positions a warp in a block of ``kScanWarps *
kScanSteps``, and one chain warp runs h = a h + b over the block. The
shipped split is timed beside others, each built by ``nvcc`` from a copy
of ``csrc/rglru.cu`` with those two constants replaced, at recurrentgemma-2b's width (2560 channels) at
1 x 512 and 4 x 300. Every variant computes the same operations in the
same order, so its y and state must be bit-equal to the shipped
wrapper's; the script fails otherwise. Device ms are the kernel's own
time in a torch.profiler trace, as ``chip_smoke.py`` takes its rows
(the inputs one copy, warm in L2; the states cycled), and the variants
are timed in turn twice (A B C ... A B C ...). It prints the
card's name and power limit, then one JSON object: each variant's
registers a thread (ptxas ``-v``), threads a CTA and device ms at each
shape.

    python3 tools/rglru_scan_tiles.py
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

# (producer warps, positions a producer a block); the first is the
# shipped split
SPLITS = ((16, 3), (8, 6), (24, 2), (16, 4), (4, 12))


def build_variants(out_dir: pathlib.Path):
    """{split: (library, registers a thread)}, all nvcc at once."""
    from repro_torch.kernels import build
    src = (build.CSRC / "rglru.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for split in SPLITS:
        text = src
        for name, v in zip(("kScanWarps", "kScanSteps"), split):
            text, n = re.subn(rf"constexpr int {name} = \d+;",
                              f"constexpr int {name} = {v};", text)
            assert n == 1, name
        cu = out_dir / f"rglru_{'x'.join(map(str, split))}.cu"
        cu.write_text(text)
        lib = cu.with_suffix(".so")
        procs[split] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(lib), str(cu)],           # -I: its #include "gelu.cuh"
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for split, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed for {split}:\n{log}")
        regs, fn = None, None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and fn and "rglru_scan_kernel" in fn:
                regs = int(m.group(1))
        out[split] = (ctypes.CDLL(str(lib)), regs)
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("rglru_scan_tiles: no CUDA device")
    import chip_smoke as cs
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import rglru as krg

    dev = torch.device("cuda")
    for _ in range(8):              # the trace windows' spin kernel names
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            cs.pad_window()
        names = {e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA}
        if names:
            break
    cs.check(bool(names), "eight traces of the spin kernel show no event")
    cs.window_events.pad_names = frozenset(names)
    W = get_config("recurrentgemma-2b").lru_width
    variants = build_variants(ROOT / "build" / "rglru_scan_tiles")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    ba, bx = randn(W, scale=0.5).bfloat16(), randn(W, scale=0.5).bfloat16()
    a_param = (4.0 + randn(W)).bfloat16()
    result = {"card": cs.card_line(), "cases": []}
    for B, S in ((1, 512), (4, 300)):
        x = randn(B, S, W).bfloat16()
        gx = randn(B, S, 2 * W).bfloat16()
        gate = randn(B, S, 2 * W).bfloat16()[..., W:]
        ref_s = randn(B, W)
        ref_y = krg.rglru_scan(x, gx, gate, ba, bx, a_param, ref_s)

        def launch(lib, s):
            y = torch.empty((B, S, W), dtype=torch.bfloat16, device=dev)
            fn = lib.rglru_scan
            fn.argtypes, fn.restype = list(krg._SCAN_ARGS), ctypes.c_int
            err = fn(x.data_ptr(), x.stride(0), x.stride(1), gx.data_ptr(),
                     gx.stride(0), gx.stride(1), gate.data_ptr(),
                     gate.stride(0), gate.stride(1), ba.data_ptr(),
                     bx.data_ptr(), a_param.data_ptr(), s.data_ptr(),
                     y.data_ptr(), B, S, W,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"rglru_scan_tiles: launch failed ({err})")
            return y

        copies = [(torch.zeros(B, W, device=dev),)
                  for _ in range(min(cs.copies_for(B * S * W * 10), 100))]
        times = {k: [] for k in variants}
        for _ in range(2):
            for split, (lib, _) in variants.items():
                s = torch.zeros(B, W, device=dev)
                y = launch(lib, s)
                torch.cuda.synchronize()
                if not (torch.equal(y, ref_y) and torch.equal(s, ref_s)):
                    raise SystemExit(f"rglru_scan_tiles: {split} at {B} x "
                                     f"{S} is not bit-equal to the shipped "
                                     "kernel")
                ms, _ = cs.time_calls(lambda s: launch(lib, s), copies, 100,
                                      per_call=1)
                times[split].append(ms)
        for split, (lib, regs) in variants.items():
            warps, steps = split
            result["cases"].append(dict(
                B=B, S=S, producer_warps=warps, positions_a_producer=steps,
                block=warps * steps, threads=32 * (1 + warps), registers=regs,
                ms=times[split]))
    print(result["card"], flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
