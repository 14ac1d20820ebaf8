"""The decode step's RoPE + cache write and decode attention, and, at
decode, ``moe_down`` folded into the combine (``moe_down_combine``), on
the CPU.

- ``ops.rope_cache_write`` (its plain version here) then the decode
  attention's plain version over the written cache, against the JAX
  package's steps on the same seeded numpy inputs: the bias add,
  ``layers.apply_rope`` of q and k, ``attention.kv_cache_write`` into
  ring slot ``lens % S`` (the caller's select of a frozen row's old
  cache; the paged write's mask), then ``ops._decode_attention_jnp``
  over the written cache (dequantized for q8_0 / q4_0; gathered through
  the table when paged). Each cache format once dense, and a ring past
  its wrap, a paged cache, the qwen2 bias and frozen rows once each.
- ``decode_rope_takes``: the head dims and quantization groups the
  decode RoPE kernel takes (every attention config's), and the ones it
  refuses.
- The model's decode step enters the RoPE + cache write and the
  attention once a layer each; an MoE decode step enters
  ``moe_down_combine`` once a layer and no ``moe_down`` / ``moe_combine``
  (one launch a layer fewer), and the prefill keeps the two MoE
  launches.

Tolerances: the attention output within one bf16 ulp at its scale
(2**-7 * max|ref|): both round q, q * scale and p at the same points and
sum in f32, but XLA sums in another order and its cos/sin may land an
f32 ulp from PyTorch's. The written rows as in test_torch_fused_ops.py:
bf16 rows within one ulp, scales bit-equal, payloads at most one step
apart on exact .5 ties.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.quant.quantize import dequantize_rows as jdequantize_rows
from repro.quant.quantize import quantize_rows as jquantize_rows
from repro_torch.bridge import to_tensor
from repro_torch.configs import CONFIGS, get_config, reduced
from repro_torch.kernels import moe as moe_kernels
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.decode_attention_quant import (
    decode_attention_quant_plain)
from repro_torch.kernels.fused_ops import decode_rope_takes
from repro_torch.models import Model
from repro_torch.models.moe import capacity as moe_capacity

CPU = torch.device("cpu")
THETA = 1e4


def t(a) -> torch.Tensor:
    return to_tensor(np.asarray(a), CPU)


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _unpack(payload, fmt: str) -> np.ndarray:
    p = torch.as_tensor(np.asarray(payload)) if not isinstance(
        payload, torch.Tensor) else payload
    if fmt == "q8_0":
        return p.numpy().astype(np.int32)
    lo = (p.to(torch.int32) << 28) >> 28
    hi = p.to(torch.int32) >> 4
    return torch.stack([lo, hi], -1).flatten(-2).numpy()


# (B, Hq, Hkv, D, S or (P, max_pages), lens, advance, bias)
CASES = {
    "dense": (3, 8, 2, 32, 64, [5, 63, 20], [True, True, False], False),
    "dense bias": (2, 4, 2, 64, 128, [127, 0], None, True),
    "ring": (3, 4, 2, 32, 64, [64, 130, 63], [True, False, True], False),
    "paged": (3, 4, 2, 32, (8, 8), [16, 7, 63], [True, False, True], False),
    "paged bias": (2, 8, 2, 64, (16, 4), [17, 48], None, True),
}


def _inputs(case, fmt, seed):
    B, Hq, Hkv, D, S, lens, advance, bias = CASES[case]
    rng = np.random.default_rng(seed)
    width = (Hq + 2 * Hkv) * D
    qkv = jnp.asarray(rng.standard_normal((B, width)), jnp.bfloat16)
    jb = (jnp.asarray(rng.standard_normal(width), jnp.bfloat16)
          if bias else None)
    table = None
    if isinstance(S, tuple):
        P, max_pages = S
        n_blocks = B * max_pages + 2
        shape = (n_blocks, Hkv, P, D)
        table = rng.permutation(np.arange(1, n_blocks))[
            :B * max_pages].reshape(B, max_pages).astype(np.int32)
    else:
        shape = (B, Hkv, S, D)
    old = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    if fmt == "bf16":
        cache = {"k": old, "v": old * 0.5}
    else:
        kq, ks = jquantize_rows(old, fmt)
        vq, vs = jquantize_rows(old * 0.5, fmt)
        cache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    return qkv, jb, cache, table


@functools.partial(jax.jit, static_argnames=("case", "fmt"))
def _jax_decode(qkv, bias, cache, table, case, fmt):
    """The JAX steps: bias add, apply_rope, kv_cache_write (the caller's
    select for a dense frozen row, the write mask for a paged one), and
    the decode attention over the written cache; jitted whole, as the
    megastep runs them (one compile a case)."""
    B, Hq, Hkv, D, S, lens, advance, _ = CASES[case]
    if table is not None:
        S = S[0] * S[1]
    if bias is not None:
        qkv = qkv + bias
    pos = jnp.asarray(lens, jnp.int32)
    q = jlayers.apply_rope(qkv[:, :Hq * D].reshape(B, Hq, D), pos, THETA)
    k = jlayers.apply_rope(qkv[:, Hq * D:(Hq + Hkv) * D].reshape(
        B, Hkv, D), pos, THETA)
    v = qkv[:, (Hq + Hkv) * D:].reshape(B, Hkv, D)
    mask = None if advance is None else jnp.asarray(advance)
    if table is None:
        new = jattn.kv_cache_write(cache, k, v, pos % S, kv_quant=fmt,
                                   group=32)
        if mask is not None:
            new = {n: jnp.where(mask[:, None, None, None], leaf, cache[n])
                   for n, leaf in new.items()}
        view = new
    else:
        new = jattn.kv_cache_write(
            dict(cache, block_table=jnp.asarray(table)), k, v, pos % S,
            kv_quant=fmt, group=32, write_mask=mask)
        view = {n: jattn.paged_gather(leaf, jnp.asarray(table))
                for n, leaf in new.items()}
    if fmt == "bf16":
        kk, vv = view["k"], view["v"]
    else:
        kk = jdequantize_rows(view["k"], view["k_scale"], fmt)
        vv = jdequantize_rows(view["v"], view["v_scale"], fmt)
    kv_len = jnp.minimum(pos + 1, S)
    return jops._decode_attention_jnp(q, kk, vv, kv_len), new


@pytest.mark.parametrize("case,fmt", [
    ("dense", "bf16"), ("dense", "q8_0"), ("dense", "q4_0"),
    ("ring", "q8_0"), ("paged", "q4_0"), ("dense bias", "bf16"),
    ("paged bias", "q8_0")])
def test_rope_write_then_attention_matches_jax(case, fmt):
    B, Hq, Hkv, D, S, lens, advance, _ = CASES[case]
    qkv, jb, jcache, table = _inputs(case, fmt, seed=len(case) * 7 + D)
    want, jnew = _jax_decode(qkv, jb, jcache,
                             None if table is None else jnp.asarray(table),
                             case=case, fmt=fmt)
    cache = {n: t(a) for n, a in jcache.items()}
    before = {n: x.clone() for n, x in cache.items()}
    S_all = S[0] * S[1] if table is not None else S
    lens_t = torch.tensor(lens, dtype=torch.int32)
    adv = None if advance is None else torch.tensor(advance)
    tb = None if table is None else t(table)
    q = ops.rope_cache_write(t(qkv), cache, lens_t, adv, THETA, fmt, tb,
                             bias=None if jb is None else t(jb))
    kv_len = torch.clamp(lens_t + 1, max=S_all)
    if fmt == "bf16":
        out = decode_attention_plain(q, cache["k"], cache["v"], kv_len,
                                     block_table=tb)
    else:
        out = decode_attention_quant_plain(
            q, cache["k"], cache["k_scale"], cache["v"], cache["v_scale"],
            kv_len, fmt=fmt, block_table=tb)
    assert out.shape == (B, Hq, D) and out.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(out), f32(want), rtol=0,
                               atol=2.0 ** -7 * float(np.abs(f32(want)).max()))
    # the written rows as the JAX write's, every other row as it was but
    # the paged garbage block 0 (where both plain writes send a frozen
    # row's; the kernel writes nothing for it)
    written = torch.zeros(cache["k"].shape[:1] + cache["k"].shape[2:3],
                          dtype=torch.bool)
    for b, (pos, a) in enumerate(zip(lens, advance or [True] * B)):
        if a:
            slot = pos % S_all
            if table is None:
                written[b, slot] = True
            else:
                written[int(table[b, slot // S[0]]), slot % S[0]] = True
    for n, leaf in cache.items():
        keep = ~written[:, None, :].expand(leaf.shape[:3]).clone()
        if table is not None:
            keep[0] = False          # the plain write's garbage block
        assert torch.equal(leaf[keep], before[n][keep]), n
        got = leaf.transpose(1, 2)[written]
        ref = t(jnew[n]).transpose(1, 2)[written]
        if fmt == "bf16" and n == "k":
            np.testing.assert_allclose(
                f32(got), f32(ref), rtol=0,
                atol=2.0 ** -7 * float(np.abs(f32(ref)).max()))
        elif fmt == "bf16" or n.endswith("scale"):
            assert torch.equal(got, ref), n
        else:
            diff = np.abs(_unpack(got, fmt) - _unpack(ref, fmt))
            assert diff.max() <= 1 and (diff > 0).mean() < 0.02, n


@pytest.mark.parametrize("arch", sorted(
    n for n, c in CONFIGS.items() if c.num_heads))
def test_decode_rope_takes_every_attention_config(arch):
    """Every attention config's head dim, bf16 and at the cache group of
    32 (q8_0 / q4_0), is one the decode RoPE kernel takes."""
    D = get_config(arch).head_dim
    assert decode_rope_takes(D, 0) and decode_rope_takes(D, D // 32)


@pytest.mark.parametrize("D,ng,ok", [
    (32, 1, True), (64, 2, True), (128, 4, True), (128, 2, True),
    (128, 1, True), (512, 16, True), (16, 1, True), (48, 0, False),
    (24, 0, False), (1024, 0, False), (64, 4, True), (64, 16, False),
    (128, 3, False), (96, 3, False)])
def test_decode_rope_takes(D, ng, ok):
    """D a multiple of 16 with D / 16 a power of two up to 32; a group
    of D / ng features a multiple of 8 that divides D / 2, or the whole
    row."""
    assert decode_rope_takes(D, ng) == ok


class _Calls:
    """Counts the calls of the model's kernel entries in ``ops``."""

    def __init__(self, monkeypatch, names):
        self.n = dict.fromkeys(names, 0)
        for name in names:
            monkeypatch.setattr(ops, name, self._wrap(name, getattr(ops, name)))

    def _wrap(self, name, fn):
        def counted(*a, **kw):
            self.n[name] += 1
            return fn(*a, **kw)
        return counted


ENTRIES = ("rope_cache_write", "decode_attention",
           "decode_attention_quant", "rope_cache_write_prefill", "moe_down",
           "moe_combine", "moe_down_combine")


@pytest.mark.parametrize("arch,kv_quant", [
    ("llama3.2-1b", "bf16"), ("llama3.2-1b", "q8_0"),
    ("phi3.5-moe-42b-a6.6b", "bf16"), ("kimi-k2-1t-a32b", "q4_0")])
def test_decode_step_entries_a_layer(monkeypatch, arch, kv_quant):
    """A decode step: the RoPE + cache write and the attention of the
    cache's format once a layer each, and an MoE layer's down GEMM and
    combine as one entry (kimi-k2's shared expert keeps its own
    ``moe_down``); a prefill: the prefill RoPE, and the MoE pair as the
    route of its capacity says (past the 16-row tile ``moe_down`` and
    ``moe_combine`` apart)."""
    cfg = dataclasses.replace(reduced(get_config(arch)), kv_quant=kv_quant)
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    L, moe = cfg.num_layers, cfg.is_moe
    shared = L * bool(cfg.num_shared_experts)
    cache = model.init_cache(2, 40)
    calls = _Calls(monkeypatch, ENTRIES)

    def moe_calls(T):
        if not moe:
            return {}
        fused = moe_kernels.moe_down_combined(moe_capacity(cfg, T))
        return {"moe_down": shared + (0 if fused else L),
                "moe_combine": 0 if fused else L,
                "moe_down_combine": L if fused else 0}
    model.prefill(params, torch.ones((2, 20), dtype=torch.long), cache,
                  seq_lens=torch.tensor([20, 3]))
    assert calls.n == dict.fromkeys(ENTRIES, 0) | {
        "rope_cache_write_prefill": L} | moe_calls(40)
    if moe:
        assert not moe_kernels.moe_down_combined(moe_capacity(cfg, 40))
    calls.n = dict.fromkeys(ENTRIES, 0)
    model.decode_step(params, torch.ones((2, 1), dtype=torch.long), cache)
    attn = "decode_attention" if kv_quant == "bf16" else \
        "decode_attention_quant"
    assert calls.n == dict.fromkeys(ENTRIES, 0) | {
        "rope_cache_write": L, attn: L} | moe_calls(2)
    if moe:
        assert moe_kernels.moe_down_combined(moe_capacity(cfg, 2))
