"""The port's prefill attention (``repro_torch.kernels.flash_attention``)
against the JAX package, on the same seeded numpy inputs, plus the
wrapper's CPU routing and input checks.

- Against ``chunked_attention`` (the function the JAX model path runs,
  and the one the plain version ports): one bf16 ulp at the output's
  scale (2**-7 * max|ref|) for bf16, 1e-5 relative for f32. Both round
  at the same points and accumulate in f32, in another order.
- Against the Pallas ``flash_attention`` (interpret mode) and
  ``attention_ref``: the JAX package's own tolerances
  (``tests/test_kernels.py``: 2e-2 absolute for bf16, 2e-5 for f32).
  Both keep q, k, v and p in f32, where the plain version rounds q*scale
  and p to bf16 as ``chunked_attention`` does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_fa
from repro.models.attention import chunked_attention
from repro_torch.bridge import to_tensor
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)

CPU = torch.device("cpu")

# B, Hq, Hkv, Sq, Skv, D, window, q_offset: tests/test_kernels.py's
# CASES, then Sq = 1, ragged S, a window over a ragged S, and a query
# block past the keys (q_offset > 0, Skv > Sq)
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
]
DTYPES = [jnp.float32, jnp.bfloat16]


def _inputs(case, dtype, seed=0):
    B, Hq, Hkv, Sq, Skv, D, _, _ = case
    rng = np.random.default_rng(seed)
    return tuple(jnp.asarray(rng.standard_normal(s), dtype) for s in
                 ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D)))


def _t(a) -> torch.Tensor:
    return to_tensor(np.asarray(a), CPU)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _plain(q, k, v, window, q_offset):
    return flash_attention_plain(_t(q), _t(k), _t(v), causal=True,
                                 window=window, q_offset=q_offset)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_matches_chunked_attention(case, dtype):
    *_, win, off = case
    q, k, v = _inputs(case, dtype)
    want = _f32(chunked_attention(q, k, v, causal=True, window=win,
                                  q_offset=off))
    got = _plain(q, k, v, win, off)
    assert got.dtype == (torch.float32 if dtype == jnp.float32
                         else torch.bfloat16)
    scale = float(np.abs(want).max())
    tol = 2.0 ** -7 * scale if dtype == jnp.bfloat16 else 1e-5 * scale
    np.testing.assert_allclose(_f32(got), want, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_matches_pallas_and_ref(case, dtype):
    B, Hq, Hkv, Sq, Skv, D, win, off = case
    q, k, v = _inputs(case, dtype, seed=1)
    # the Pallas kernel needs blocks that divide Sq and Skv
    bq = 64 if Sq % 64 == 0 else Sq
    bk = 64 if Skv % 64 == 0 else Skv
    tol = 2e-2 if dtype == jnp.bfloat16 else 2e-5
    got = _f32(_plain(q, k, v, win, off))
    pallas = pallas_fa(q, k, v, causal=True, window=win, q_offset=off,
                       bq=bq, bk=bk, interpret=True)
    np.testing.assert_allclose(got, _f32(pallas), rtol=0, atol=tol)
    want = jref.attention_ref(q, k, v, causal=True, window=win,
                              q_offset=off)
    np.testing.assert_allclose(got, _f32(want), rtol=0, atol=tol)


def test_row_with_no_visible_key_is_zero():
    """Queries far past the keys with a short window see nothing: the
    plain version gives 0 there, as ``attention_ref`` does (l == 0 is
    read as 1), and the rows that do see keys match the oracle."""
    case = (1, 4, 2, 24, 16, 32, 12, 8)     # positions 8..31, keys 0..15
    q, k, v = _inputs(case, jnp.float32, seed=2)
    got = _f32(_plain(q, k, v, 12, 8))
    want = _f32(jref.attention_ref(q, k, v, causal=True, window=12,
                                   q_offset=8))
    blind = np.arange(24) + 8 - 12 >= 15      # no key in (pos - 12, pos]
    assert blind.any() and not blind.all()
    assert (got[:, :, blind] == 0).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_rows_do_not_depend_on_the_padding_after_them():
    """A query row's output is the same whether the sequence stops right
    after it or runs on (a padded bucket against the prompt alone)."""
    case = (2, 4, 2, 96, 96, 32, 0, 0)
    q, k, v = (_t(a) for a in _inputs(case, jnp.bfloat16, seed=3))
    full = flash_attention_plain(q, k, v)
    part = flash_attention_plain(q[:, :, :70], k[:, :, :70], v[:, :, :70])
    np.testing.assert_allclose(_f32(part), _f32(full[:, :, :70]), rtol=0,
                               atol=2.0 ** -7 * float(full.abs().max()))


def test_wrapper_routes_cpu_tensors_to_the_plain_version():
    q, k, v = (_t(a) for a in _inputs(CASES[0], jnp.bfloat16))
    before = flash_attention.launches
    out = ops.attention(q, k, v, causal=True, window=64)
    assert torch.equal(out, flash_attention_plain(q, k, v, window=64))
    assert torch.equal(flash_attention(q, k, v, window=64), out)
    assert flash_attention.launches == before       # no kernel launched


@pytest.mark.parametrize("bad", ["rank", "heads", "batch", "head_dim",
                                 "kv_shape", "dtype", "empty"])
def test_wrapper_raises_on_bad_inputs(bad):
    q = torch.zeros(2, 4, 8, 32, dtype=torch.bfloat16)
    k = torch.zeros(2, 2, 8, 32, dtype=torch.bfloat16)
    v = k.clone()
    if bad == "rank":
        q = q[0]
    elif bad == "heads":
        k = v = torch.zeros(2, 3, 8, 32, dtype=torch.bfloat16)
    elif bad == "batch":
        k = v = torch.zeros(1, 2, 8, 32, dtype=torch.bfloat16)
    elif bad == "head_dim":
        k = v = torch.zeros(2, 2, 8, 16, dtype=torch.bfloat16)
    elif bad == "kv_shape":
        v = torch.zeros(2, 2, 9, 32, dtype=torch.bfloat16)
    elif bad == "dtype":
        k = k.float()
    else:
        k = v = torch.zeros(2, 2, 0, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention(q, k, v)
