"""The hybrid family's kernel plans, held on the CPU as pure functions:
the (256, 10) instances of both attention kernels (the flash kernel's
block_k and shared-memory budget at head dim 256, the decode kernel's
splits and CTAs at the served kv_len and at 1024, every served config's
(head_dim, G) instantiated in both sources) and the RG-LRU kernels' grids.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import pathlib
import re

import pytest
import torch

from repro_torch.configs import CONFIGS, get_config
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rglru as krg

CSRC = pathlib.Path(fa.__file__).resolve().parent / "csrc"


def _served_pairs():
    return {(c.head_dim, c.num_heads // c.num_kv_heads)
            for c in CONFIGS.values() if c.num_heads}


def test_every_served_pair_is_instantiated_in_both_attention_kernels():
    """The dispatch of decode_attention.cu and the FA_CASE list of
    flash_attention.cu hold every served config's (head_dim, G), the
    flash cases at ``block_k(head_dim)``; recurrentgemma-2b's (256, 10)
    among them."""
    dec = {(int(d), int(g)) for d, g in re.findall(
        r"if \(D == (\d+) && G == (\d+)\)",
        (CSRC / "decode_attention.cu").read_text())}
    flash = {(int(d), int(g)): int(bk) for d, g, bk in re.findall(
        r"FA_CASE\((\d+), (\d+), (\d+)\)",
        (CSRC / "flash_attention.cu").read_text())}
    assert (256, 10) in _served_pairs()
    assert _served_pairs() <= dec
    assert _served_pairs() <= set(flash)
    for (d, g), bk in flash.items():
        assert bk == fa.block_k(d), (d, g)


@pytest.mark.parametrize("D", [32, 64, 128, 256])
def test_flash_tiles_fit_a_cta(D):
    """block_k 32 at head dim 256, Q kept in shared memory there (one
    buffer, the output staged in it); every head dim's carve fits the
    232448 bytes a CTA may use, at D 256 with 67 KB to spare; the D 128
    carve is the one it was (two Q buffers and an output staging)."""
    assert fa.smem_bytes(D) <= fa.SMEM_PER_BLOCK
    assert fa.q_in_smem(D) == (D == 256)
    if D == 256:
        assert fa.block_k(D) == 32
        # 3 stages of 32 KB of K and V, one 64 KB Q tile, the barriers
        assert fa.smem_bytes(D) == 3 * 2 * 32 * 512 + 128 * 512 + 8 * 8 + 1024
        assert fa.SMEM_PER_BLOCK - fa.smem_bytes(D) > 64 * 1024
    if D == 128:
        assert fa.smem_bytes(D) == (3 * 2 * 64 * 256 + 2 * 128 * 256
                                    + 128 * 272 + 10 * 8 + 1024)


@pytest.mark.parametrize("B, S, window, items, ctas, most_tiles", [
    (4, 512, 0, 160, 132, 16),         # causal 4 x 512
    (1, 4500, 2048, 360, 132, 68),     # the window leg's prompt
])
def test_flash_plan_at_256_10(B, S, window, items, ctas, most_tiles):
    """The work items (query tiles x rows x 10 heads) on at most 132
    persistent CTAs, heaviest first; a windowed item walks at most the
    window's tiles of 32 keys and one more."""
    pl = fa.plan(B, 10, 1, S, S, 256, window=window)
    assert (pl.block_q, pl.block_k, pl.items, pl.ctas) == (128, 32, items,
                                                           ctas)
    n = [fa.kv_tiles(t * 128, 128, S, S, 32, True, window, 0)[1]
         for t in pl.order]
    assert n == sorted(n, reverse=True) and n[0] == most_tiles
    if window:
        assert max(n) <= -(-(window + 128) // 32) + 1


@pytest.mark.parametrize("kv_len, splits", [(40, 1), (128, 1), (129, 2),
                                            (1024, 8), (2048, 16)])
def test_decode_splits_at_256_10(kv_len, splits):
    """One kv head: 4 slots are 4 (slot, kv head) pairs, so the splits
    along the cache are what spread a step over the SMs: 4 CTAs at the
    served kv_len (tens of positions), 32 at 1024, 64 at the 2048 ring;
    the f32 scratch a split (10 x (256 + 2))."""
    assert da.num_splits(kv_len) == splits
    assert 4 * 1 * da.num_splits(kv_len) == 4 * splits
    assert da.split_scratch_elems(4, 1, 10, kv_len, 256) == \
        4 * splits * 10 * 258


def test_rglru_grids():
    """The scan a CTA of 32 channels of one sequence (a chain warp and 16
    producers): 80 CTAs at one sequence of recurrentgemma-2b's 2560
    channels; the decode step 10 CTAs of 256 a slot."""
    w = get_config("recurrentgemma-2b").lru_width
    assert krg.scan_grid(1, w) == (80, 1) and krg.scan_grid(4, w) == (80, 4)
    assert krg.step_grid(4, w) == (10, 4)
    assert krg.SCAN_CHANNELS * krg.scan_grid(1, 2561)[0] >= 2561
    assert krg.SCAN_THREADS == 32 * 17


@pytest.mark.parametrize("S", [1, 17])
def test_scan_plain_version_rows_alone(S):
    """The scan's plain version (the kernel's sequential order): a
    sequence alone is bit-equal to its row of a batch, the state it
    stores is its last y whatever the row held, and its recurrence is
    ``linear_scan`` on the gated input."""
    g = torch.Generator().manual_seed(0)
    B, W = 3, 24
    x, gate = (torch.randn(B, S, W, generator=g).bfloat16() for _ in "ab")
    gx = torch.randn(B, S, 2 * W, generator=g).bfloat16()
    ba, bx = (torch.randn(W, generator=g).bfloat16() for _ in "ab")
    a_param = (4 + torch.randn(W, generator=g)).bfloat16()
    st0 = torch.randn(B, W, generator=g)
    st = st0.clone()
    y = krg.rglru_scan_plain(x, gx, gate, ba, bx, a_param, st)
    for r in range(B):
        sr = st0[r:r + 1].clone()
        yr = krg.rglru_scan_plain(x[r:r + 1], gx[r:r + 1], gate[r:r + 1], ba,
                                  bx, a_param, sr)
        assert torch.equal(yr[0], y[r]) and torch.equal(sr[0], st[r])
    a, i = krg.gates_plain(gx, ba, bx, a_param)
    h = krg.linear_scan(a, x.float() * i.float())
    want = (h * krg.gelu(gate.float())).to(x.dtype)
    assert torch.equal(want, y)
    assert torch.equal(st, y[:, -1].float())
