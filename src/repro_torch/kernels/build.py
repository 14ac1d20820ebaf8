"""Build the hand-written CUDA kernels and load them with ``ctypes``.

Every ``csrc/*.cu`` file is compiled with ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface, under
``build/repro_torch_kernels/`` at the repository root, at first use.
All sources compile at once (one ``nvcc`` process each). A library is
named after the hash of its source, the shared headers (``csrc/*.cuh``)
and the flags, so an edited source or header is rebuilt and an
unchanged one is loaded as it is. Nothing is fetched or
prebuilt. The compiler's report (ptxas ``-v``) is kept beside each
library; ``perf_notes`` reads its performance warnings, ``ptxas_usage``
each kernel's registers and spills.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time
from typing import Dict, Tuple

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the "
                       "port's CUDA kernels are built from source at "
                       "first use")


def _lib_path(src: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):     # included by some sources
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:12]}.so"


@functools.lru_cache(maxsize=None)
def build() -> Tuple[Dict[str, ctypes.CDLL], float]:
    """Build (where needed) and load every kernel library, once per
    process. Returns the libraries by source stem and the wall seconds
    spent compiling (0 when every library was already built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    srcs = sorted(CSRC.glob("*.cu"))
    todo = [(s, _lib_path(s)) for s in srcs if not _lib_path(s).exists()]
    t0 = time.perf_counter()
    if todo:
        nvcc = _nvcc()
        procs = []
        for src, lib in todo:
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((src, lib, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for src, lib, tmp, p in procs:
            out, _ = p.communicate()
            if p.returncode:
                failed.append(f"{src.name}:\n{out.decode(errors='replace')}")
            else:
                lib.with_suffix(".log").write_bytes(out)
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    secs = time.perf_counter() - t0
    return {s.stem: ctypes.CDLL(str(_lib_path(s))) for s in srcs}, secs


def perf_notes(stem: str) -> list:
    """The "Potential Performance Loss" lines of ptxas's report on the
    library built from ``csrc/<stem>.cu`` (for example C7520: its
    ``wgmma`` instructions were serialized)."""
    log = _lib_path(CSRC / f"{stem}.cu").with_suffix(".log")
    return [line.strip() for line in log.read_text(errors="replace")
            .splitlines() if "Performance Loss" in line]


def ptxas_usage(stem: str) -> list:
    """(mangled entry function, registers, spill store bytes, spill load
    bytes) of every kernel ptxas compiled from ``csrc/<stem>.cu``, from
    its ``-v`` report."""
    log = _lib_path(CSRC / f"{stem}.cu").with_suffix(".log")
    usage, fn, spills = [], None, (0, 0)
    for line in log.read_text(errors="replace").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn, spills = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            usage.append((fn, int(m.group(1))) + spills)
            fn = None
    return usage


@functools.lru_cache(maxsize=None)
def function(lib: str, name: str, argtypes: tuple):
    """A kernel library's C entry point with its argument types set
    (``c_void_p`` for every pointer and the stream, so 64-bit addresses
    are not cut) and an ``int`` (cudaError_t) result."""
    fn = getattr(build()[0][lib], name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")
