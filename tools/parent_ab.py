"""Hold the decode step's small kernels of this tree against a parent
checkout's on the card, bit for bit, and time both; then serve and
profile the main paths from both in turns.

    python3 tools/parent_ab.py --parent DIR [--served-pairs N]
                               [--served-only] [--profile-served]

DIR is an unpacked checkout of another commit of this repository (for a
pull request, its parent). The script calls each checkout only through
entry points that both have: ``ops.rope_cache_write`` (the decode RoPE +
cache write), ``models.moe.moe_forward`` (a decode's MoE layer, whatever
launches the checkout runs for it) and ``repro_torch.launch.serve``. It
runs its cases in four processes in turn, each importing ``repro_torch``
from one checkout: DIR, this tree, this tree, DIR. Each builds that
checkout's kernels, makes every case's inputs on the card from one seed
(the same draws in both checkouts), runs the case once, keeps the
outputs (under ``build/parent_ab``) and times the case:

- device ms: the case's kernels' own time, summed from a torch.profiler
  trace of 20 calls (as ``chip_smoke.py`` takes a kernel's row), and
  by kernel;
- graph ms: 20 calls captured in one CUDA graph, replayed 50 times
  between CUDA events, over the calls: what a megastep's graph pays for
  the case, the gaps between its nodes included.

A RoPE case cycles through copies of its inputs that together exceed
the 50 MB L2, the first copy's outputs kept. The outputs (q and every
cache leaf; the MoE layer's output) must be bit-equal across the two
checkouts and across the two runs of each, or the script fails.

Then it serves llama3.2-1b's main path (q8_0 weights, 16 requests of 64
new tokens) and phi3.5-moe at 24 layers (8 requests of 32) through
``repro_torch.launch.serve`` from each checkout, as ``chip_smoke.py``
serves them (4 slots, max_len 1024, K 8, greedy), in ``--served-pairs``
pairs of turns (parent then tree, tree then parent, ...), and reads each
run's ms a decode step (``--served-models`` picks the paths).
``--profile-served`` also profiles llama3.2-1b's
served run from each checkout with that checkout's
``chip_smoke.profile_served`` (device ms a step by kernel group, device
idle share, CUDA events a megastep) and lists the decode RoPE and
attention kernels' calls of two megasteps. ``--served-only`` skips the
kernel cases. It prints the card's name and power limit, then one JSON
object: each case's readings on each side, the served runs' ms a step
and tok/s, and the profiles.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import re
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "parent_ab"     # each run's readings and outputs
CALLS, REPLAYS = 20, 50

# case name: its arguments. The served main path's requests sit at
# positions under 72 (lens 40); the others at the cache's end.
ROPE_CASES = {
    "rope bf16 (64,4) B4 pos 40": dict(fmt="bf16", d=64, hq=32, hkv=8, b=4,
                                      lens=(40, 38, 45, 41)),
    "rope bf16 (64,4) B4": dict(fmt="bf16", d=64, hq=32, hkv=8, b=4),
    "rope q8_0 (64,4) B4": dict(fmt="q8_0", d=64, hq=32, hkv=8, b=4),
    "rope q4_0 (64,4) B4": dict(fmt="q4_0", d=64, hq=32, hkv=8, b=4),
    "rope bf16 paged P16 (64,4) B4": dict(fmt="bf16", d=64, hq=32, hkv=8,
                                          b=4, page=16),
    "rope bf16 (128,4) B4": dict(fmt="bf16", d=128, hq=32, hkv=8, b=4),
    "rope bf16 (64,4) B1": dict(fmt="bf16", d=64, hq=32, hkv=8, b=1),
    "rope bf16 bias (64,7) B4": dict(fmt="bf16", d=64, hq=14, hkv=2, b=4,
                                     bias=True),
    "rope q8_0 frozen ring (64,4) B4": dict(
        fmt="q8_0", d=64, hq=32, hkv=8, b=4, lens=(1023, 1024, 5, 700),
        advance=(True, False, True, True), timed=False),
    "rope q4_0 paged P16 frozen (128,1) B3": dict(
        fmt="q4_0", d=128, hq=16, hkv=16, b=3, page=16, lens=(127, 128, 0),
        advance=(True, True, False), timed=False),
}
MOE_CASES = {
    "moe phi3.5-moe T4": dict(arch="phi3.5-moe-42b-a6.6b", T=4),
    "moe phi3.5-moe T1": dict(arch="phi3.5-moe-42b-a6.6b", T=1),
    "moe kimi-k2 T4 shared": dict(arch="kimi-k2-1t-a32b", T=4),
}
S = 1024
# the served paths timed end to end in turns: llama3.2-1b's main path and
# phi3.5-moe at 24 layers, as chip_smoke.py serves them (longer runs)
SERVED = {
    "llama3.2-1b q8_0": ["--arch", "llama3.2-1b", "--precision", "q8_0",
                         "--requests", "16", "--max-new", "64"],
    "phi3.5-moe 24 layers": ["--arch", "phi3.5-moe-42b-a6.6b",
                             "--num-layers", "24", "--precision", "bf16",
                             "--requests", "8", "--max-new", "32"],
}
SERVE_COMMON = ["--no-reduced", "--kv-quant", "bf16", "--slots", "4",
                "--max-len", "1024", "--megastep-k", "8", "--temperature",
                "0", "--device", "cuda"]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def side(src: pathlib.Path, out: pathlib.Path) -> None:
    """One process: the cases through the checkout at ``src``."""
    sys.path.insert(0, str(src / "src"))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops
    from repro_torch.models import moe as moe_mod
    from repro_torch.quant.quantize import quantize_rows
    assert pathlib.Path(build.__file__).resolve().is_relative_to(src), \
        build.__file__
    dev = torch.device("cuda")
    build.build()

    def gen(seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return g

    def rope_case(i, fmt, d, hq, hkv, b, page=0, bias=False, lens=None,
                  advance=None, timed=True):
        g = gen(100 + i)
        qkv = torch.randn(b, (hq + 2 * hkv) * d, generator=g,
                          device=dev).bfloat16()
        bs = (torch.randn((hq + 2 * hkv) * d, generator=g,
                          device=dev).bfloat16() if bias else None)
        rows = b * S // page + 1 if page else b
        shape = (rows, hkv, page or S, d)
        old = torch.randn(shape, generator=g, device=dev).bfloat16()
        if fmt == "bf16":
            cache = {"k": old, "v": (old * 0.5).contiguous()}
        else:
            kq, ks = quantize_rows(old, fmt)
            vq, vs = quantize_rows(old * 0.5, fmt)
            cache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        table = None
        if page:
            perm = torch.randperm(rows - 1, generator=g, device=dev) + 1
            table = perm.to(torch.int32).reshape(b, S // page).contiguous()
        lens_t = torch.tensor(lens or [S - 1] * b, dtype=torch.int32,
                              device=dev)
        adv = (None if advance is None else
               torch.tensor(advance, dtype=torch.bool, device=dev))
        theta = 5e5

        # copies of the inputs whose bytes together exceed the 50 MB L2,
        # so that each call reads its cache from device memory, as a
        # decode step's layer does; the first copy's outputs are kept
        nbytes = sum(t.numel() * t.element_size() for t in cache.values())
        copies = [(qkv, cache)] + [
            (qkv.clone(), {n: t.clone() for n, t in cache.items()})
            for _ in range(min(CALLS, -(-160_000_000 // nbytes)) - 1)]
        turn = [0]

        def call():
            a, c = copies[turn[0] % len(copies)]
            turn[0] += 1
            return ops.rope_cache_write(a, c, lens_t, adv, theta, fmt, table,
                                        bias=bs)
        o = call()
        torch.cuda.synchronize()
        return call, {"out": o, **cache}, timed

    def moe_case(i, arch, T, timed=True):
        """One MoE layer at decode (T tokens, one position each) through
        ``moe_forward``, its weights drawn from the case's seed."""
        cfg = get_config(arch)
        g = gen(200 + i)
        D, F, E = cfg.d_model, cfg.d_ff, cfg.num_experts

        def w(*shape, fan_in):     # drawn in bf16: kimi-k2's are 34 GB
            return torch.randn(shape, generator=g, device=dev,
                               dtype=torch.bfloat16).mul_(fan_in ** -0.5)
        p = {"router": {"w": w(D, E, fan_in=D)},
             "experts": {"w_gate_up": w(E, D, 2 * F, fan_in=D),
                         "w_down": w(E, F, D, fan_in=F)}}
        if cfg.num_shared_experts:
            n = cfg.num_shared_experts
            p["shared"] = {"w_gate_up": w(D, n * 2 * F, fan_in=D),
                           "w_down": w(n * F, D, fan_in=n * F)}
        x = torch.randn(T, 1, D, generator=g, device=dev).bfloat16()

        def call():
            return moe_mod.moe_forward(p, cfg, x)
        o = call()
        torch.cuda.synchronize()
        return call, {"out": o}, timed

    def pad():
        # spin kernels at a trace window's edges, left out of its events:
        # a window now and then loses its first or last events
        for _ in range(16):
            torch.cuda._sleep(500_000)
        torch.cuda.synchronize()

    def traced(fn):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pad()
            fn()
            torch.cuda.synchronize()
            pad()
        return [e for e in prof.events() if e.device_type == DeviceType.CUDA]

    pad_names = {e.name for e in traced(lambda: None)}

    def device_ms(call):
        """(device ms, CUDA events, device ms by kernel) a call."""
        def calls():
            for _ in range(CALLS):
                call()
        ev = [e for e in traced(calls) if e.name not in pad_names]
        by = {}
        for e in ev:
            m = re.search(r"\w*_kernel\w*", e.name)
            name = m.group(0) if m else e.name[:40]
            by[name] = by.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / CALLS
        return (sum(e.time_range.elapsed_us() for e in ev) / 1e3 / CALLS,
                len(ev) / CALLS, by)

    def graph_ms(call):
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):        # the stream's tickets first
            call()
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(CALLS):
                call()
        for _ in range(3):
            graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPLAYS):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (REPLAYS * CALLS)

    results, outputs = {}, {}
    for i, (name, kw) in enumerate(ROPE_CASES.items()):
        call, outs, timed = rope_case(i, **kw)
        outputs[name] = {n: t.cpu() for n, t in outs.items()}
        if timed:
            dms, ev, by = device_ms(call)
            results[name] = dict(device_ms=dms, events=ev, by_kernel=by,
                                 graph_ms=graph_ms(call))
        del call, outs
    for i, (name, kw) in enumerate(MOE_CASES.items()):
        call, outs, timed = moe_case(i, **kw)
        outputs[name] = {n: t.cpu() for n, t in outs.items()}
        if timed:
            dms, ev, by = device_ms(call)
            results[name] = dict(device_ms=dms, events=ev, by_kernel=by,
                                 graph_ms=graph_ms(call))
        del call, outs
        torch.cuda.empty_cache()
    torch.save(outputs, OUT / f"{out.name}.pt")
    out.with_suffix(".json").write_text(json.dumps(dict(results=results)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=pathlib.Path,
                    help="an unpacked checkout of the commit to compare "
                         "with")
    ap.add_argument("--served-pairs", type=int, default=2,
                    help="pairs of served runs a model, in turns (parent, "
                         "tree), (tree, parent), ...")
    ap.add_argument("--served-models", nargs="+", choices=list(SERVED),
                    default=list(SERVED),
                    help="the served paths timed in turns (default: all)")
    ap.add_argument("--served-only", action="store_true",
                    help="only the served runs, no kernel cases")
    ap.add_argument("--profile-served", action="store_true",
                    help="also profile llama3.2-1b's served run from each "
                         "checkout (chip_smoke.py's profile_served)")
    ap.add_argument("--profile-side", type=pathlib.Path,
                    help=argparse.SUPPRESS)
    ap.add_argument("--side", type=pathlib.Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=pathlib.Path, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.side is not None:
        side(a.side.resolve(), a.out)
        return
    if a.profile_side is not None:
        profile_side(a.profile_side.resolve(), a.out)
        return
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("parent_ab: no CUDA device")
    if a.parent is None:
        raise SystemExit("parent_ab: --parent DIR is required")
    OUT.mkdir(parents=True, exist_ok=True)
    sides = (("parent", a.parent.resolve()), ("tree", ROOT))
    order = [sides[0], sides[1], sides[1], sides[0]]
    checked, table = ([], {}) if a.served_only else kernel_cases(order)
    served = {}
    for model in a.served_models if a.served_pairs else ():
        args = SERVED[model]
        for i in range(a.served_pairs):
            for label, src in sides[::-1] if i % 2 else sides:
                line = subprocess.run(
                    [sys.executable, "-m", "repro_torch.launch.serve", *args,
                     *SERVE_COMMON], cwd=src, capture_output=True, text=True,
                    env={**os.environ, "PYTHONPATH": str(src / "src")},
                    check=True).stdout
                m = re.search(
                    r"= ([\d.]+) tok/s, ([\d.]+) ms per decode step", line)
                served.setdefault(model, {}).setdefault(label, []).append(
                    {"tok_s": float(m.group(1)),
                     "ms_per_step": float(m.group(2))})
        print(f"  {model}: ms a decode step " + "; ".join(
            f"{lab} " + " / ".join(f"{r['ms_per_step']:.3f}" for r in rs)
            + f" (median {statistics.median(r['ms_per_step'] for r in rs):.3f})"
            for lab, rs in served[model].items()), flush=True)
    profiles = {}
    for n, (label, src) in enumerate(order if a.profile_served else ()):
        out = OUT / f"profile-{n}-{label}.json"
        subprocess.run([sys.executable, __file__, "--profile-side",
                        str(src), "--out", str(out)], check=True)
        prof = json.loads(out.read_text())
        profiles.setdefault(label, []).append(prof)
        g = prof["device_ms_per_step_by_group"]
        print(f"  profiled llama3.2-1b q8_0 ({label}): wall "
              f"{prof['profiled_ms_per_step']:.3f} ms a step, device "
              f"{prof['device_ms_per_step']:.3f}, idle "
              f"{prof['device_idle_share']:.3f}, events a megastep "
              f"{prof['events_per_megastep']}; " + ", ".join(
                  f"{k} {v:.3f}" for k, v in g.items() if v), flush=True)
    print(card_line())
    print(json.dumps({"bit_equal": checked, "cases": table,
                      "served": served, "profiles": profiles}))


def profile_side(src: pathlib.Path, out: pathlib.Path) -> None:
    """One process: llama3.2-1b's main path served from the checkout at
    ``src`` and profiled by that checkout's ``chip_smoke.profile_served``
    (device ms a step by kernel group, the idle share)."""
    sys.path[:0] = [str(src / "src"), str(src)]
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.launch import serve
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cs.pad_window()
    cs.window_events.pad_names = frozenset(
        e.name for e in prof.events() if e.device_type == DeviceType.CUDA)
    res = serve.main([*SERVED["llama3.2-1b q8_0"], *SERVE_COMMON])
    eng = res.engine
    numbers, _ = cs.profile_served(eng, lambda: serve.make_requests(
        eng.cfg.vocab_size, 8, 32, seed=0))
    # the attention kernel's calls of two megasteps, in order
    eng.reset()
    for r in serve.make_requests(eng.cfg.vocab_size, 4, 32, seed=0):
        eng.submit(r)
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cs.pad_window()
        eng.step()
        eng.step()
        torch.cuda.synchronize()
        cs.pad_window()
    ev = sorted((e for e in cs.window_events(prof)
                 if "decode_attention" in e.name or "rope_cache" in e.name),
                key=lambda e: e.time_range.start)
    numbers["attention_calls_us"] = [
        (re.search(r"\w*_kernel", e.name).group(0),
         round(e.time_range.elapsed_us(), 2))
        for e in ev]
    torch.cuda.synchronize()
    out.write_text(json.dumps(numbers))


def kernel_cases(order):
    """The kernel cases through each checkout of ``order`` in turn: the
    outputs held bit for bit, the readings by case and side."""
    import torch
    runs = []
    for n, (label, src) in enumerate(order):
        out = OUT / f"{n}-{label}"
        subprocess.run([sys.executable, __file__, "--side", str(src),
                        "--out", str(out)], check=True)
        runs.append((label, json.loads(out.with_suffix(".json").read_text()),
                     torch.load(OUT / f"{out.name}.pt")))
    parent, tree = runs[0], runs[1]
    checked = []
    for name in list(ROPE_CASES) + list(MOE_CASES):
        for leaf, want in parent[2][name].items():
            got = tree[2][name][leaf]
            if not torch.equal(got, want):
                raise SystemExit(f"parent_ab: {name}: {leaf} is not "
                                 "bit-equal to the parent's")
        # the two runs of each side agree with each other too
        for label, _, outs in runs[2:]:
            ref = tree if label == "tree" else parent
            for leaf, want in ref[2][name].items():
                if not torch.equal(outs[name][leaf], want):
                    raise SystemExit(f"parent_ab: {name}: {leaf} differs "
                                     f"between two {label} runs")
        checked.append(name)
    table = {}
    for name in list(ROPE_CASES) + list(MOE_CASES):
        row = {}
        for label, meta, _ in runs:
            r = meta["results"].get(name)
            if not r or "device_ms" not in r:
                continue
            row.setdefault(label, []).append(
                {k: r[k] for k in ("device_ms", "graph_ms", "events",
                                   "by_kernel")})
        table[name] = row
    for name, row in table.items():
        if "tree" not in row:
            continue
        pd = min(x["device_ms"] for x in row["parent"])
        td = min(x["device_ms"] for x in row["tree"])
        pg = min(x["graph_ms"] for x in row["parent"])
        tg = min(x["graph_ms"] for x in row["tree"])
        print(f"  {name}: device ms parent {pd:.5f} tree {td:.5f}; graph ms "
              f"parent {pg:.5f} tree {tg:.5f}", flush=True)
        for label in ("parent", "tree"):
            by = row[label][0]["by_kernel"]
            print(f"    {label}: " + ", ".join(
                f"{k} {v:.5f}" for k, v in sorted(by.items())), flush=True)
    return checked, table


if __name__ == "__main__":
    main()
