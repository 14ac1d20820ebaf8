"""The tile schedule of the Hopper flash-attention kernel
(``csrc/flash_attention.cu``), written out in plain PyTorch and held to
the JAX package and to the port's plain version on the CPU.

``tiled_attention`` below is the kernel's algorithm, with the tile
constants, the tile order, the grid and the KV tile ranges taken from
``repro_torch.kernels.flash_attention``: work items of one query tile of
one (batch row, query head), in the heaviest-first order of
``tile_order``, taken round robin by ``plan``'s persistent CTAs; an item
holds ``BLOCK_Q`` queries of one head, its query rows past Sq zero, and
walks the KV
tiles ``kv_tiles`` gives, each ``block_k`` keys anchored at position 0
and zero past Skv; the online softmax runs per KV tile in the kernel's
exp2 form (log2(e) folded into the f32 score scale), with q*scale and p
rounded to bf16 and l summing the unrounded p; masked scores are -1e30
and masked p 0; acc / l is rounded once. Each item computes at the
kernel's fixed tile shapes, so a row's arithmetic depends only on its
own query and the keys, as in the kernel.

It is held to the JAX package's ``chunked_attention`` (what the model
path runs), to the Pallas ``flash_attention`` in interpret mode, and to
``flash_attention_plain``. Tolerance: one bf16 ulp at the output's scale
(2**-7 * max|ref|), the kernel tests' bf16 tolerance: all accumulate in
f32 but in other orders and over other tiles (the Pallas kernel keeps q
and p in f32), so a bf16 output may differ by one rounding step.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_fa
from repro.models.attention import chunked_attention
from repro_torch.bridge import to_tensor
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.decode_attention import NEG_INF, softmax_scale

CPU = torch.device("cpu")
LOG2E = 1.4426950408889634

# B, Hq, Hkv, Sq, Skv, D, window, q_offset: test_torch_flash.py's CASES,
# then tile boundaries: Sq one short of and one past a query tile (block_q
# 128, at G 4 and G 1), Skv one past a KV tile (block_k 128, 64 at
# D 128), window edges inside a tile, q_offsets that are no multiple of
# a tile, and keys that end before the last query (Skv < Sq + q_offset)
CASES = [
    (2, 4, 2, 256, 256, 64, 0, 0),
    (1, 8, 1, 128, 128, 32, 0, 0),
    (2, 4, 4, 256, 256, 64, 64, 0),
    (1, 2, 1, 128, 256, 64, 0, 128),
    (1, 2, 2, 64, 64, 128, 16, 0),
    (2, 4, 2, 1, 1, 32, 0, 0),
    (2, 4, 2, 333, 333, 32, 0, 0),
    (1, 4, 2, 200, 200, 64, 100, 0),
    (1, 4, 1, 40, 120, 32, 0, 80),
    (1, 8, 2, 127, 127, 64, 0, 0),
    (1, 8, 2, 129, 129, 64, 0, 0),
    (1, 2, 2, 127, 127, 64, 0, 0),
    (1, 2, 2, 129, 129, 64, 0, 0),
    (1, 2, 2, 65, 65, 128, 0, 0),
    (1, 8, 2, 200, 200, 64, 50, 0),
    (1, 4, 2, 300, 300, 32, 70, 0),
    (1, 8, 2, 50, 200, 64, 0, 13),
    (1, 8, 2, 64, 40, 64, 0, 8),
    (1, 8, 2, 24, 16, 64, 12, 8),
    # recurrentgemma-2b's (256, 10): block_k 32, ragged tiles, its window
    (1, 10, 1, 129, 129, 256, 0, 0),
    (1, 10, 1, 150, 150, 256, 64, 0),
]
def _t(a) -> torch.Tensor:
    return to_tensor(np.asarray(a), CPU)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _inputs(case, seed):
    B, Hq, Hkv, Sq, Skv, D, _, _ = case
    rng = np.random.default_rng(seed)
    return tuple(jnp.asarray(rng.standard_normal(s), jnp.bfloat16) for s in
                 ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D)))


def schedule(pl, B, Hq):
    """Per persistent CTA, the work items (query tile, batch row, query
    head) it takes, in order: CTA c takes items c, c + ctas, ..., and
    item w is query tile order[w // (B Hq)] of (batch row, query head)
    w % (B Hq)."""
    BH = B * Hq
    return [[(pl.order[w // BH], w % BH // Hq, w % Hq)
             for w in range(c, pl.items, pl.ctas)] for c in range(pl.ctas)]


def tiled_attention(q, k, v, *, causal=True, window=0, q_offset=0, sms=3):
    """q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D) bf16 → (out (B, Hq, Sq, D)
    bf16, per persistent CTA the work items (query tile, batch row, query
    head) it takes, in order), by the kernel's schedule on a card of
    ``sms`` SMs."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    G = Hq // Hkv
    pl = fa.plan(B, Hq, Hkv, Sq, Skv, D, causal=causal, window=window,
                 q_offset=q_offset, sms=sms)
    bq, bk = pl.block_q, pl.block_k
    n_q = len(pl.order)
    n_k = -(-Skv // bk) + 1
    # q rows past Sq and keys past Skv are zero, as the kernel reads them
    qs = torch.zeros(B, Hq, n_q * bq, D)
    qs[:, :, :Sq] = (q.float() * softmax_scale(D)).to(q.dtype).float()
    kz = torch.zeros(B, Hkv, n_k * bk, D)
    vz = torch.zeros(B, Hkv, n_k * bk, D)
    kz[:, :, :Skv], vz[:, :, :Skv] = k.float(), v.float()
    out = torch.zeros(B, Hq, n_q * bq, D)
    ctas = schedule(pl, B, Hq)
    for tile, b, head in (item for cta in ctas for item in cta):
        q0 = tile * bq
        qt = qs[b, head, q0:q0 + bq]                       # (bq, D)
        pos = (q0 + q_offset + torch.arange(bq))[:, None]
        m = torch.full((bq,), NEG_INF)
        l = torch.zeros(bq)
        acc = torch.zeros(bq, D)
        first, count = fa.kv_tiles(q0, bq, Sq, Skv, bk, causal, window,
                                   q_offset)
        for t in range(first, first + count):
            kpos = t * bk + torch.arange(bk)[None, :]
            kt = kz[b, head // G, t * bk:(t + 1) * bk]
            vt = vz[b, head // G, t * bk:(t + 1) * bk]
            ok = kpos < Skv
            if causal:
                ok = ok & (kpos <= pos)
            if window > 0:
                ok = ok & (kpos > pos - window)
            s = torch.where(ok, qt @ kt.T, torch.tensor(NEG_INF))
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2((m - m_new) * LOG2E)
            p = torch.where(ok, torch.exp2(
                s * LOG2E - (m_new * LOG2E)[..., None]), torch.zeros(()))
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p.to(q.dtype).float() @ vt
            m = m_new
        l = torch.where(l == 0, torch.ones(()), l)
        out[b, head, q0:q0 + bq] = acc / l[..., None]
    return out[:, :, :Sq].to(q.dtype), ctas


@functools.lru_cache(maxsize=None)
def _references(case):
    """chunked_attention, the Pallas kernel (interpret mode) and the plain
    version on the case's seeded inputs, as f32 numpy arrays."""
    B, Hq, Hkv, Sq, Skv, D, win, off = case
    q, k, v = _inputs(case, seed=0)
    kw = dict(causal=True, window=win, q_offset=off)
    # the Pallas kernel needs blocks that divide Sq and Skv
    pallas = pallas_fa(q, k, v, bq=64 if Sq % 64 == 0 else Sq,
                       bk=64 if Skv % 64 == 0 else Skv, interpret=True, **kw)
    return (_f32(chunked_attention(q, k, v, **kw)), _f32(pallas),
            _f32(fa.flash_attention_plain(_t(q), _t(k), _t(v), **kw)))


def _bf16_tol(ref) -> float:
    return 2.0 ** -7 * float(np.abs(_f32(ref)).max())


@pytest.mark.parametrize("case", CASES, ids=str)
def test_tiled_model_matches_jax_and_plain(case):
    B, Hq, Hkv, Sq, Skv, D, win, off = case
    q, k, v = _inputs(case, seed=0)
    got, _ = tiled_attention(_t(q), _t(k), _t(v), causal=True, window=win,
                             q_offset=off)
    assert got.dtype == torch.bfloat16 and got.shape == (B, Hq, Sq, D)
    for ref in _references(case):
        np.testing.assert_allclose(_f32(got), ref, rtol=0,
                                   atol=_bf16_tol(ref))


@pytest.mark.parametrize("sms", [1, 3, 132])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_order_visits_every_item_once_heaviest_first(case, sms):
    """Every (query tile, batch row, query head) is one work item, taken
    once; the launch order, and so each persistent CTA's own sequence,
    has non-increasing work (KV tiles walked); the grid is min(items,
    SMs)."""
    B, Hq, Hkv, Sq, Skv, D, win, off = case
    pl = fa.plan(B, Hq, Hkv, Sq, Skv, D, window=win, q_offset=off, sms=sms)
    assert pl.block_q == fa.BLOCK_Q
    n_q = -(-Sq // pl.block_q)
    assert sorted(pl.order) == list(range(n_q))

    def work(tile):
        return fa.kv_tiles(tile * pl.block_q, pl.block_q, Sq, Skv,
                           pl.block_k, True, win, off)[1]

    assert all(work(a) >= work(b) for a, b in zip(pl.order, pl.order[1:]))
    ctas = schedule(pl, B, Hq)
    assert len(ctas) == pl.ctas == min(pl.items, sms)
    items = [item for cta in ctas for item in cta]
    assert len(items) == len(set(items)) == pl.items
    assert set(items) == {(t, b, h) for t in range(n_q) for b in range(B)
                          for h in range(Hq)}
    for cta in ctas:
        assert all(work(a[0]) >= work(b[0]) for a, b in zip(cta, cta[1:]))


@pytest.mark.parametrize("sq, skv, win, off, n_q, want", [
    # causal, no window: the tiles in reverse (work grows with the tile)
    (512, 512, 0, 0, 4, [3, 2, 1, 0]),
    # keys end inside the first tile: the clipped tiles tie, later first
    (300, 100, 0, 0, 3, [2, 1, 0]),
    # a window of 100 from position 0: tile 0 walks one KV tile, the
    # others two
    (512, 512, 100, 0, 4, [3, 2, 1, 0]),
    # a window of 40 at q_offset 700: tiles 0 and 1 walk two KV tiles,
    # the short last tile (positions 956-999) one
    (300, 1200, 40, 700, 3, [1, 0, 2]),
])
def test_tile_order_examples(sq, skv, win, off, n_q, want):
    """Worked orders at block_q 128, block_k 128."""
    order = fa.tile_order(sq, skv, 128, 128, True, win, off)
    assert len(order) == n_q and list(order) == want


@pytest.mark.parametrize("case", [(2, 8, 2, 96, 96, 64, 0, 0),
                                  (1, 4, 4, 300, 300, 64, 0, 0),
                                  (1, 2, 2, 130, 130, 128, 0, 0),
                                  (1, 4, 2, 200, 200, 32, 60, 0)], ids=str)
def test_rows_are_bit_equal_whatever_sq(case):
    """A row's output is the same bits whether the sequence stops right
    after it or runs on (a padded bucket against the prompt alone): KV
    tiles are anchored at position 0 and tiles a row cannot see leave it
    as it was."""
    *_, Sq, _, _, win, off = case
    q, k, v = (_t(a) for a in _inputs(case, seed=3))
    kw = dict(window=win, q_offset=off)
    full, _ = tiled_attention(q, k, v, **kw)
    for cut in (1, Sq // 3, Sq - 1):
        part, _ = tiled_attention(q[:, :, :cut], k[:, :, :cut],
                                  v[:, :, :cut], **kw)
        assert torch.equal(part, full[:, :, :cut])


def test_tile_constants():
    """An item holds two m64 warpgroups of rows; KV tiles are a multiple
    of the k16 step; one launch orders the query tiles of a 32K prompt."""
    assert fa.BLOCK_Q == 128
    for D in (32, 64, 128, 256):
        assert fa.block_k(D) % 16 == 0
    assert fa.MAX_TILES * fa.BLOCK_Q >= 32768
