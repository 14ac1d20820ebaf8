"""The split-along-the-cache decode attention (flash decoding) of
``csrc/decode_attention.cu``, written out in plain PyTorch and held to
the JAX package and to the port's plain versions on the CPU.

``split_merge`` below is the kernel's algorithm: each split of
``SPLIT`` absolute cache positions runs its own online softmax over
64-position tiles (q*scale and p rounded to bf16, l summing the
unrounded p) into an unnormalized (m, l, acc); the splits that hold a
visible position are merged in split order (in the kernel, by the last
of their CTAs to finish); a slot that sees no position gives 0.
It is held to ``ops._decode_attention_jnp`` (bf16 cache) or
``ops.decode_attention_quant`` (the XLA path over a q8_0/q4_0 cache), and
to ``decode_attention_plain`` / ``decode_attention_quant_plain``.

Tolerance: one bf16 ulp at the output's scale (2**-7 * max|ref|), the
existing kernel tests' bf16 tolerance: all round at the same points and
accumulate in f32, but the split version keeps a running max per tile
and per split, so p is rounded to bf16 against another max.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.quant.quantize import quantize_rows
from repro_torch.bridge import to_tensor
from repro_torch.kernels.decode_attention import (NEG_INF, SPLIT,
                                                  decode_attention_plain,
                                                  num_splits, softmax_scale,
                                                  split_scratch_elems)
from repro_torch.kernels.decode_attention_quant import (
    decode_attention_quant_plain)
from repro_torch.quant.quantize import dequantize_rows

CPU = torch.device("cpu")
TILE = 64                       # the kernel's positions per tile
S = 2 * SPLIT + 88              # three splits, the last one partial
# kv_len 0, 1, split - 1, split, split + 1 and S
LENS = [0, 1, SPLIT - 1, SPLIT, SPLIT + 1, S]
# windows whose visible run crosses a split boundary (window: kv_lens):
# SPLIT + 44 under window 100 starts at SPLIT - 56, 2 * SPLIT + 8 at
# 2 * SPLIT - 92; under window SPLIT + 44 the latter starts at SPLIT - 36
# (three splits); SPLIT + 1 under window 2 starts at SPLIT - 1
WINDOW_LENS = {100: [SPLIT + 44, 0, 1, SPLIT, 2 * SPLIT + 8, S],
               SPLIT + 44: [2 * SPLIT + 8, SPLIT + 44, 1, S, 0, 40],
               2: [SPLIT + 1, SPLIT, 1, 0, S, 5]}
DG = [(64, 4), (32, 2)]


def _t(a) -> torch.Tensor:
    return to_tensor(np.asarray(a), CPU)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def assert_bf16_close(port, ref):
    ref = _f32(ref)
    tol = 2.0 ** -7 * float(np.abs(ref).max())
    np.testing.assert_allclose(_f32(port), ref, rtol=0, atol=tol)


def split_merge(q, k, v, kv_len, window=0):
    """q (B, Hq, D); k, v (B, Hkv, S, D) bf16 (a dequantized view for a
    quantized cache); kv_len (B,) → (B, Hq, D), by the kernel's
    split-and-merge algorithm."""
    B, Hq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    G = Hq // Hkv
    qs = (q.float() * softmax_scale(D)).to(q.dtype).float()
    qs = qs.reshape(B, Hkv, G, D)
    out = torch.zeros(B, Hkv, G, D)
    for b in range(B):
        n = max(0, min(int(kv_len[b]), Sk))
        lo = max(0, n - window) if window else 0
        m_t = torch.full((Hkv, G), NEG_INF)
        l_t = torch.zeros(Hkv, G)
        a_t = torch.zeros(Hkv, G, D)
        for sp in range(num_splits(Sk)):
            t_lo, t_hi = max(lo, sp * SPLIT), min(n, (sp + 1) * SPLIT)
            if t_lo >= t_hi:
                continue                 # nothing visible: not merged
            m = torch.full((Hkv, G), NEG_INF)
            l = torch.zeros(Hkv, G)
            acc = torch.zeros(Hkv, G, D)
            for t0 in range(t_lo, t_hi, TILE):
                t1 = min(t0 + TILE, t_hi)
                s = torch.einsum("hgd,hnd->hgn", qs[b], k[b, :, t0:t1].float())
                m_new = torch.maximum(m, s.amax(-1))
                p = torch.exp(s - m_new[..., None])
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum(
                    "hgn,hnd->hgd", p.to(q.dtype).float(), v[b, :, t0:t1].float())
                m = m_new
            m_new = torch.maximum(m_t, m)
            c_old, c_new = torch.exp(m_t - m_new), torch.exp(m - m_new)
            l_t = l_t * c_old + l * c_new
            a_t = a_t * c_old[..., None] + acc * c_new[..., None]
            m_t = m_new
        l_t = torch.where(l_t == 0, torch.ones(()), l_t)
        out[b] = a_t / l_t[..., None]
    return out.reshape(B, Hq, D).to(q.dtype)


def _inputs(seed, D, G, lens, Hkv=2):
    rng = np.random.default_rng(seed)
    B = len(lens)
    q = jnp.asarray(rng.standard_normal((B, Hkv * G, D)), jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((B, Hkv, S, D)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((B, Hkv, S, D)), jnp.bfloat16)
    return q, k, v, jnp.asarray(lens, jnp.int32)


def _check_format(fmt, D, G, lens, window, seed):
    q, k, v, lens_j = _inputs(seed, D, G, lens)
    lens_t = torch.tensor(lens)
    if fmt == "bf16":
        kt, vt = _t(k), _t(v)
        jax_ref = jops._decode_attention_jnp(q, k, v, lens_j, window=window)
        plain = decode_attention_plain(_t(q), kt, vt, lens_t, window=window)
    else:
        kq, ks = quantize_rows(k, fmt)
        vq, vs = quantize_rows(v, fmt)
        args = [_t(a) for a in (kq, ks, vq, vs)]
        kt = dequantize_rows(args[0], args[1], fmt)
        vt = dequantize_rows(args[2], args[3], fmt)
        jax_ref = jops.decode_attention_quant(q, kq, ks, vq, vs, lens_j,
                                              fmt=fmt, window=window)
        plain = decode_attention_quant_plain(_t(q), *args, lens_t, fmt=fmt,
                                             window=window)
    got = split_merge(_t(q), kt, vt, lens_t, window)
    assert got.dtype == torch.bfloat16 and got.shape == plain.shape
    assert_bf16_close(got, jax_ref)
    assert_bf16_close(got, plain)
    for b, n in enumerate(lens):
        if n == 0:
            assert float(got[b].abs().max()) == 0.0
    return got, (_t(q), kt, vt, lens_t)


@pytest.mark.parametrize("fmt", ["bf16", "q8_0", "q4_0"])
@pytest.mark.parametrize("dg", DG, ids=lambda dg: f"D{dg[0]}G{dg[1]}")
def test_split_merge_matches_jax_and_plain(fmt, dg):
    """kv_len 0, 1, split - 1, split, split + 1 and S."""
    _check_format(fmt, *dg, LENS, 0, seed=0)


@pytest.mark.parametrize("fmt", ["bf16", "q8_0", "q4_0"])
@pytest.mark.parametrize("dg", DG, ids=lambda dg: f"D{dg[0]}G{dg[1]}")
@pytest.mark.parametrize("window", sorted(WINDOW_LENS))
def test_split_merge_windows_across_split_boundaries(fmt, dg, window):
    _check_format(fmt, *dg, WINDOW_LENS[window], window, seed=1)


@pytest.mark.parametrize("fmt", ["bf16", "q8_0", "q4_0"])
def test_split_merge_slot_alone_is_bit_equal(fmt):
    """A slot's output does not depend on the batch or the cache length:
    the same slot alone, in a cache cut to fewer splits, gives the same
    bits (empty splits contribute nothing, not even a rounding)."""
    lens = [SPLIT - 1, SPLIT + 1, 2 * SPLIT - 20]
    window = 100
    got, (q, k, v, lens_t) = _check_format(fmt, 64, 4, lens, window, seed=2)
    for b, n in enumerate(lens):
        cut = -(-n // TILE) * TILE          # the cache cut past kv_len
        alone = split_merge(q[b:b + 1], k[b:b + 1, :, :cut],
                            v[b:b + 1, :, :cut], lens_t[b:b + 1], window)
        assert num_splits(cut) < num_splits(S)
        assert torch.equal(alone[0], got[b])


def test_scratch_size_matches_its_formula():
    assert SPLIT > 0 and SPLIT % TILE == 0
    for B, Hkv, G, Sc, D in [(4, 8, 4, 1024, 64), (1, 8, 4, 512, 64),
                             (3, 16, 1, 333, 128), (2, 2, 2, 50, 32),
                             (1, 1, 1, 1, 32), (2, 2, 2, SPLIT, 32),
                             (2, 2, 2, SPLIT + 1, 32)]:
        splits = -(-Sc // SPLIT)
        assert num_splits(Sc) == splits
        assert split_scratch_elems(B, Hkv, G, Sc, D) == \
            B * Hkv * splits * G * (D + 2)
    assert num_splits(SPLIT) == 1 and num_splits(SPLIT + 1) == 2


def test_ticket_counts_start_zeroed_and_are_shared():
    """The kernel's ticket counts come zeroed, hold at least B * Hkv, and
    are allocated once for all launches on a stream that fit them."""
    from repro_torch.kernels.tickets import tickets
    t = tickets(4 * 8, CPU)
    assert t.dtype == torch.int32 and t.numel() >= 32
    assert int(t.abs().sum()) == 0
    assert tickets(2, CPU) is t
    big = tickets(t.numel() + 1, CPU)
    assert big.numel() > t.numel() and int(big.abs().sum()) == 0
    assert tickets(1, CPU) is big
