"""Time the SSM decode step's kernel (``ssm_decode_step`` in
``src/repro_torch/kernels/csrc/ssm.cu``) at other tilings on the card.

The shipped tiling, 8 p rows a warp and 8 warps a CTA (a head a CTA),
is timed beside 4 x 4 and 8 x 4, each built by ``nvcc`` from a copy of
``csrc/ssm.cu`` with ``kStepRows`` and ``kStepWarps`` replaced, at
mamba2-2.7b's widths (80 heads of P 64, N 128, 5376 conv channels), at
4 slots with one frozen and at 1 slot. A row's sum over n does not depend
on the tiling, so every variant's y and both states must be bit-equal to
the shipped wrapper's; the script fails otherwise. Device ms are the
kernels' own time in a torch.profiler trace, as ``chip_smoke.py`` takes
its rows, and the variants are timed in turn twice (A B C A B C). It
prints the card's name and power limit, then one JSON object: each
variant's registers a thread (ptxas ``-v``), CTAs a slot, CTAs an SM by
its registers, and device ms at each B.

    python3 tools/ssm_step_tiles.py
"""
from __future__ import annotations

import ctypes
import json
import math
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

TILINGS = ((8, 8), (4, 4), (8, 4))     # (p rows a warp, warps a CTA)
REGS_AN_SM = 65536


def build_variants(out_dir: pathlib.Path):
    """{(rows, warps): (library, registers a thread)}, all nvcc at once."""
    from repro_torch.kernels import build
    src = (build.CSRC / "ssm.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for rows, warps in TILINGS:
        text = src
        for name, v in (("kStepRows", rows), ("kStepWarps", warps)):
            text, n = re.subn(rf"constexpr int {name} = \d+;",
                              f"constexpr int {name} = {v};", text)
            assert n == 1, name
        cu = out_dir / f"ssm_{rows}x{warps}.cu"
        cu.write_text(text)
        lib = cu.with_suffix(".so")
        procs[(rows, warps)] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    out = {}
    for key, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed for {key}:\n{log}")
        regs, fn = None, None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and fn and "ssm_decode_step_kernel" in fn:
                regs = int(m.group(1))
        out[key] = (ctypes.CDLL(str(lib)), regs)
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ssm_step_tiles: no CUDA device")
    import chip_smoke as cs
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import ssm as kssm
    from repro_torch.kernels.tickets import tickets

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
    cfg = get_config("mamba2-2.7b")
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    di = cfg.d_inner
    C, width = di + 2 * N, di + 2 * N + di + H
    variants = build_variants(ROOT / "build" / "ssm_step_tiles")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    w = randn(4, C, scale=0.5).bfloat16()
    b = randn(C, scale=0.2).bfloat16()
    vec = [randn(H, scale=s).bfloat16() for s in (0.5, 0.5, 1.0)]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    result = {"card": cs.card_line(), "sms": sms, "cases": []}
    for B, advance in ((4, [True, False, True, True]), (1, [True])):
        zx = randn(B, width).bfloat16()
        xbc, dt = zx[:, di:di + C], zx[:, di + C:]
        adv = torch.tensor(advance, dtype=torch.bool, device=dev)
        conv = randn(B, 3, C).bfloat16()
        state = randn(B, H, P, N, scale=0.3)
        ref_s, ref_c = state.clone(), conv.clone()
        ref_y = kssm.ssm_decode_step(xbc, dt, w, b, ref_c, *vec, ref_s, adv)

        def launch(lib, s, c):
            y = torch.empty((B, H * P), dtype=torch.bfloat16, device=dev)
            fn = lib.ssm_decode_step
            fn.argtypes, fn.restype = list(kssm._STEP_ARGS), ctypes.c_int
            err = fn(xbc.data_ptr(), xbc.stride(0), dt.data_ptr(),
                     dt.stride(0), w.data_ptr(), b.data_ptr(), c.data_ptr(),
                     *(v.data_ptr() for v in vec), s.data_ptr(),
                     adv.data_ptr(), y.data_ptr(),
                     tickets(B, dev).data_ptr(), B, H, P, N,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"ssm_step_tiles: launch failed ({err})")
            return y

        n = min(cs.copies_for(B * H * P * N * 4), 100)
        copies = [(state.clone(), conv.clone()) for _ in range(n)]
        times = {k: [] for k in variants}
        for _ in range(2):
            for key, (lib, _) in variants.items():
                s, c = state.clone(), conv.clone()
                y = launch(lib, s, c)
                torch.cuda.synchronize()
                if not (torch.equal(y, ref_y) and torch.equal(s, ref_s)
                        and torch.equal(c, ref_c)):
                    raise SystemExit(f"ssm_step_tiles: {key} at B {B} is "
                                     "not bit-equal to the shipped kernel")
                ms, _ = cs.time_calls(lambda s, c: launch(lib, s, c),
                                      copies, 100, per_call=1)
                times[key].append(ms)
        for (rows, warps), (lib, regs) in variants.items():
            threads = 32 * warps
            per_sm = REGS_AN_SM // (threads * math.ceil(regs / 8) * 8)
            result["cases"].append(dict(
                B=B, advance=advance, rows_a_warp=rows, warps_a_cta=warps,
                registers=regs, ctas_a_slot=(P // (rows * warps)) * H,
                ctas_an_sm_by_registers=per_sm,
                ms=times[(rows, warps)]))
    print(result["card"], flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
