"""Compare the machine code (SASS) that two checkouts' kernel sources
compile to, kernel by kernel.

    python3 tools/sass_diff.py --parent DIR [STEM ...]

DIR is an unpacked checkout of another commit of this repository (for a
pull request, its parent). For each STEM (default: ``decode_attention``
and ``flash_attention``) the script compiles ``csrc/<STEM>.cu`` of this
tree and of DIR to a cubin for ``sm_90a`` with the port's own nvcc flags
(all compiles at once), dumps each cubin with ``cuobjdump -sass`` and
compares every kernel function (by mangled name) present on both sides,
instruction for instruction (the compared text of each side is kept
under ``build/sass_diff``). It prints one JSON object: for each stem,
the functions whose SASS is the same, those whose SASS differs, and
those found on one side only. It needs ``nvcc`` and ``cuobjdump`` (the
CUDA toolkit), not a card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402

OUT = ROOT / "build" / "sass_diff"
CSRC = pathlib.Path("src/repro_torch/kernels/csrc")
ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}")
LABEL = re.compile(r"\.L_x_\d+")


def _flags() -> list:
    """The port's nvcc flags for a cubin in place of a shared library."""
    drop = {"-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"}
    return [f for f in build.NVCC_FLAGS if f not in drop] + ["-cubin"]


def _functions(sass: str) -> dict:
    """{mangled name: its instructions, one a line, whitespace cut}, with
    what differs between two compiles of the same code cut out: the
    anonymous namespace's per-file tag (a hash of the checkout) in names
    and instructions, and the branch labels' numbers, which count over
    the whole file (renumbered from 0 in each function)."""
    funcs, name = {}, None
    for line in sass.splitlines():
        line = ANON.sub("_GLOBAL__N_", line)
        m = re.search(r"Function : (\S+)", line)
        if m:
            name, labels = m.group(1), {}
            funcs[name] = []
        elif name and "/*" in line:
            line = LABEL.sub(
                lambda m: f".L{labels.setdefault(m.group(0), len(labels))}",
                line)
            funcs[name].append(" ".join(line.split()))
    return funcs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=pathlib.Path)
    ap.add_argument("stems", nargs="*",
                    default=["decode_attention", "flash_attention"])
    args = ap.parse_args()
    nvcc = build._nvcc()
    cuobjdump = str(pathlib.Path(nvcc).with_name("cuobjdump"))
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for side, root in (("parent", args.parent.resolve()), ("tree", ROOT)):
        for stem in args.stems:
            cubin = OUT / f"{side}-{stem}.cubin"
            jobs[side, stem] = (cubin, subprocess.Popen(
                [nvcc, *_flags(), "-o", str(cubin),
                 str(root / CSRC / f"{stem}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    sass = {}
    for key, (cubin, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed on {key}:\n{out.decode(errors='replace')}")
        sass[key] = _functions(subprocess.run(
            [cuobjdump, "-sass", str(cubin)], check=True,
            capture_output=True, text=True).stdout)
        cubin.with_suffix(".sass").write_text("".join(  # the compared text
            f"Function : {f}\n" + "\n".join(body) + "\n"
            for f, body in sorted(sass[key].items())))
    report = {}
    for stem in args.stems:
        par, tree = sass["parent", stem], sass["tree", stem]
        both = sorted(set(par) & set(tree))
        report[stem] = dict(
            same=[f for f in both if par[f] == tree[f]],
            differ=[f for f in both if par[f] != tree[f]],
            parent_only=sorted(set(par) - set(tree)),
            tree_only=sorted(set(tree) - set(par)))
        print(f"{stem}: {len(report[stem]['same'])} kernels the same, "
              f"{len(report[stem]['differ'])} differ, "
              f"{len(report[stem]['tree_only'])} only in this tree, "
              f"{len(report[stem]['parent_only'])} only in the parent",
              flush=True)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
