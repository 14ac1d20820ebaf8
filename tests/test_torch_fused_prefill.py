"""The residual add folded into RMSNorm (``add_rmsnorm``) and the prefill's
RoPE + cache write (``rope_cache_write_prefill``), both in
``repro_torch.kernels.fused_ops``: their plain versions against the JAX
package's functions on the same seeded numpy inputs, the wrappers'
routing and input checks, and the model that now runs through them
(reduced llama3.2-1b) against the JAX ``Model``.

Tolerances:
- ``add_rmsnorm``: h exact (both sides add in f32 and round once to x's
  dtype); the norm within one bf16 ulp at its scale (2**-7 * max|ref|),
  or 1e-6 of it in f32, because XLA sums the mean of squares in another
  order.
- ``rope_cache_write_prefill``: q, k, v and the bf16 cache rows exact
  (both sides form cos/sin of position * freq in f32 and round the
  rotated rows once to bf16); quantized scales exact (amax / qmax in f32,
  one rounding to bf16); quantized payloads may differ by one step, and
  only where the f32 division lands on an exact .5, which the two
  frameworks may break differently (``test_torch_quant.py``).
- The model, f32 params: logits within 1e-4 absolute, as in
  ``test_torch_prefill.py``.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models import Model as JModel
from repro.models import layers as jlayers
from repro.models.model import _write_prefill_kv as jwrite_prefill_kv
from repro.quant.quantize import quantize_rows as jquantize_rows
from repro_torch.bridge import from_jax, to_tensor
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import fused_ops, ops
from repro_torch.models import Model
from repro_torch.models import attention as attn
from repro_torch.models import layers

CPU = torch.device("cpu")
THETA = 5e5


def t(a) -> torch.Tensor:
    return to_tensor(np.asarray(a), CPU)


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _jdtype(dtype):
    return jnp.bfloat16 if dtype == "bf16" else jnp.float32


# -- add_rmsnorm ----------------------------------------------------------
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("M", [1, 4, 333])
def test_add_rmsnorm_plain_matches_jax(dtype, M):
    d = 256
    rng = np.random.default_rng(M)
    x = jnp.asarray(rng.standard_normal((M, d)) * 3.0, _jdtype(dtype))
    z = jnp.asarray(rng.standard_normal((M, d)), _jdtype(dtype))
    w = jnp.asarray(1.0 + 0.1 * rng.standard_normal(d), _jdtype(dtype))
    want_h = x + z
    want = jlayers.rmsnorm(want_h, w, 1e-5)
    h, out = fused_ops.add_rmsnorm_plain(t(x), t(z), t(w), 1e-5)
    assert h.dtype == out.dtype == t(x).dtype
    assert h.shape == out.shape == (M, d)
    np.testing.assert_array_equal(f32(h), f32(want_h))
    ref = f32(want)
    tol = (2.0 ** -7 if dtype == "bf16" else 1e-6) * float(np.abs(ref).max())
    np.testing.assert_allclose(f32(out), ref, rtol=0, atol=tol)
    # the norm of h is the plain RMSNorm's, bit for bit
    assert torch.equal(out, fused_ops.rmsnorm_plain(h, t(w), 1e-5))
    # the wrapper and the model's entry take the plain version on the CPU
    before = fused_ops.add_rmsnorm.launches
    for got in (ops.add_rmsnorm(t(x), t(z), t(w), 1e-5),
                layers.add_rmsnorm(t(x), t(z), t(w), 1e-5)):
        assert torch.equal(got[0], h) and torch.equal(got[1], out)
    assert fused_ops.add_rmsnorm.launches == before


def test_add_rmsnorm_keeps_leading_dims():
    rng = np.random.default_rng(7)
    x = t(rng.standard_normal((2, 5, 64)).astype(np.float32)).bfloat16()
    z = t(rng.standard_normal((2, 5, 64)).astype(np.float32)).bfloat16()
    w = torch.ones(64, dtype=torch.bfloat16)
    h, out = fused_ops.add_rmsnorm(x, z, w)
    flat_h, flat_out = fused_ops.add_rmsnorm(x.reshape(10, 64),
                                             z.reshape(10, 64), w)
    assert torch.equal(h.reshape(10, 64), flat_h)
    assert torch.equal(out.reshape(10, 64), flat_out)


# -- rope_cache_write_prefill ---------------------------------------------
# (B, S, S_cache, Hq, Hkv, D, seq_lens): right-padded rows, S below and
# at the cache length, G 2 / 4 / 1, D 32 / 64 / 128
PREFILL_CASES = [
    (2, 8, 16, 4, 2, 32, [8, 5]),
    (3, 16, 16, 8, 2, 64, [16, 9, 1]),
    (1, 5, 12, 4, 4, 128, [5]),
]


def _prefill_inputs(case, fmt):
    B, S, S_cache, Hq, Hkv, D, _ = case
    rng = np.random.default_rng(S * D + B)
    qkv = jnp.asarray(rng.standard_normal((B, S, (Hq + 2 * Hkv) * D)),
                      jnp.bfloat16)
    # a cache already holding other rows, so that untouched positions show
    old = jnp.asarray(rng.standard_normal((B, Hkv, S_cache, D)),
                      jnp.bfloat16)
    if fmt == "bf16":
        cache = {"k": old, "v": old * 0.5}
    else:
        kq, ks = jquantize_rows(old, fmt)
        vq, vs = jquantize_rows(old * 0.5, fmt)
        cache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    return qkv, cache


def _jax_prefill(qkv, cache, case, fmt):
    """The JAX ``attention_forward`` split, ``apply_rope`` and swap of q,
    k and v, then ``model._write_prefill_kv`` (its non-ring branch)."""
    B, S, S_cache, Hq, Hkv, D, seq_lens = case
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    q = qkv[..., :Hq * D].reshape(B, S, Hq, D)
    k = qkv[..., Hq * D:(Hq + Hkv) * D].reshape(B, S, Hkv, D)
    v = qkv[..., (Hq + Hkv) * D:].reshape(B, S, Hkv, D)
    q = jnp.swapaxes(jlayers.apply_rope(q, pos, THETA), 1, 2)
    k = jnp.swapaxes(jlayers.apply_rope(k, pos, THETA), 1, 2)
    v = jnp.swapaxes(v, 1, 2)
    c_l = dict(cache, lens=jnp.zeros((B,), jnp.int32))
    new = jwrite_prefill_kv(c_l, k, v, S, jnp.asarray(seq_lens, jnp.int32),
                            kv_quant=fmt, group=32)
    assert np.asarray(new.pop("lens")).tolist() == seq_lens
    return q, k, v, new


def _unpack(payload: np.ndarray, fmt: str) -> np.ndarray:
    p = payload.astype(np.int32)
    if fmt == "q8_0":
        return p
    lo = (p << 28) >> 28
    return np.stack([lo, p >> 4], -1).reshape(p.shape[:-1] + (-1,))


def _ties(x: np.ndarray, fmt: str, ng: int) -> np.ndarray:
    """Where x (..., D) divided by its group's f32 scale lands on an
    exact .5: the division there may round either way."""
    qmax = 127.0 if fmt == "q8_0" else 7.0
    xg = x.astype(np.float32).reshape(x.shape[:-1] + (ng, -1))
    sc = np.float32(np.abs(xg).max(-1) / np.float32(qmax))
    sc = np.where(sc == 0, np.float32(1), sc)
    r = np.abs(xg / sc[..., None])
    return ((r - np.floor(r)) == 0.5).reshape(x.shape)


@pytest.mark.parametrize("fmt", ["bf16", "q8_0", "q4_0"])
@pytest.mark.parametrize("case", PREFILL_CASES)
def test_rope_cache_write_prefill_plain_matches_jax(case, fmt):
    B, S, S_cache, Hq, Hkv, D, _ = case
    qkv, jcache = _prefill_inputs(case, fmt)
    want_q, want_k, want_v, want = _jax_prefill(qkv, jcache, case, fmt)
    cache = {n: t(a) for n, a in jcache.items()}
    before = {n: leaf.clone() for n, leaf in cache.items()}
    launches = fused_ops.rope_cache_write_prefill.launches
    q, k, v = ops.rope_cache_write_prefill(t(qkv), cache, THETA, fmt)
    assert fused_ops.rope_cache_write_prefill.launches == launches
    assert q.shape == (B, Hq, S, D) and k.shape == v.shape == (B, Hkv, S, D)
    for got, ref in ((q, want_q), (k, want_k), (v, want_v)):
        assert got.dtype == torch.bfloat16 and got.is_contiguous()
        np.testing.assert_array_equal(f32(got), f32(ref))
    for n, leaf in cache.items():
        # positions [S, S_cache) keep their bits; the padding rows' junk
        # below S is written like every other row
        assert torch.equal(leaf[:, :, S:], before[n][:, :, S:]), n
    if fmt == "bf16":
        for n in ("k", "v"):
            np.testing.assert_array_equal(f32(cache[n]), f32(want[n]))
        return
    ng = cache["k_scale"].shape[-1]
    for n, rows in (("k", f32(k)), ("v", f32(v))):
        np.testing.assert_array_equal(f32(cache[f"{n}_scale"]),
                                      f32(want[f"{n}_scale"]))
        diff = np.abs(_unpack(cache[n].numpy(), fmt)
                      - _unpack(np.asarray(want[n]), fmt))[:, :, :S]
        assert diff.max() <= 1
        assert ((diff == 0) | _ties(rows, fmt, ng)).all(), n


def test_rope_cache_write_prefill_plain_keeps_f32_rows():
    """Under f32 params the prefill attends over f32 q/k/v, as the JAX
    package's does; the cache gets them rounded to its format."""
    case = PREFILL_CASES[0]
    B, S, S_cache, Hq, Hkv, D, _ = case
    qkv, jcache = _prefill_inputs(case, "bf16")
    qkv32 = t(qkv).float() * 1.001
    cache = {n: t(a) for n, a in jcache.items()}
    q, k, v = fused_ops.rope_cache_write_prefill(qkv32, cache, THETA, "bf16")
    assert q.dtype == k.dtype == v.dtype == torch.float32
    assert torch.equal(cache["k"][:, :, :S], k.bfloat16())
    assert torch.equal(cache["v"][:, :, :S], v.bfloat16())


def test_prefill_wrappers_reject_bad_inputs():
    cache = {"k": torch.zeros(2, 2, 8, 32, dtype=torch.bfloat16),
             "v": torch.zeros(2, 2, 8, 32, dtype=torch.bfloat16)}
    qkv = torch.zeros(2, 4, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bias"):      # not one a column
        fused_ops.rope_cache_write_prefill(
            qkv, cache, THETA, "bf16",
            bias=torch.zeros(255, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="width"):
        fused_ops.rope_cache_write_prefill(
            torch.zeros(2, 4, 100, dtype=torch.bfloat16), cache, THETA,
            "bf16")
    with pytest.raises(ValueError, match=r"\(B, S, width\)"):
        fused_ops.rope_cache_write_prefill(qkv[:, 0], cache, THETA, "bf16")
    with pytest.raises(ValueError, match="format"):
        fused_ops.rope_cache_write_prefill(qkv, cache, THETA, "q5_0")
    x = torch.zeros(3, 64, dtype=torch.bfloat16)
    w = torch.ones(64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="delta"):     # not x's shape
        fused_ops.add_rmsnorm(x, torch.zeros(1, 64, dtype=torch.bfloat16), w)
    with pytest.raises(ValueError, match="delta"):     # not x's dtype
        fused_ops.add_rmsnorm(x, torch.zeros(3, 64), w)


def test_prefill_wrappers_never_take_the_plain_version_off_the_cpu():
    """A tensor that is not on the CPU reaches the kernel's checks and is
    refused there (here: the meta device, which is no CUDA device); it
    never falls back to the plain version."""
    meta = torch.device("meta")
    x = torch.empty(3, 64, dtype=torch.bfloat16, device=meta)
    w = torch.empty(64, dtype=torch.bfloat16, device=meta)
    cache = {n: torch.empty(2, 2, 8, 32, dtype=torch.bfloat16, device=meta)
             for n in ("k", "v")}
    qkv = torch.empty(2, 4, 256, dtype=torch.bfloat16, device=meta)
    counts = dict(ops.launch_counts())
    with pytest.raises(ValueError, match="CUDA"):
        fused_ops.add_rmsnorm(x, x, w)
    with pytest.raises(ValueError, match="bf16 or f32"):
        fused_ops.add_rmsnorm(x.half(), x.half(), w)
    with pytest.raises(ValueError, match="CUDA"):
        fused_ops.rope_cache_write_prefill(qkv, cache, THETA, "bf16")
    with pytest.raises(ValueError, match="bf16 qkv"):
        fused_ops.rope_cache_write_prefill(qkv.float(), cache, THETA, "bf16")
    qcache = {"k": torch.empty(2, 2, 8, 32, dtype=torch.int8, device=meta),
              "v": torch.empty(2, 2, 8, 32, dtype=torch.int8, device=meta),
              "k_scale": torch.empty(2, 2, 8, 3, dtype=torch.bfloat16,
                                     device=meta),
              "v_scale": torch.empty(2, 2, 8, 3, dtype=torch.bfloat16,
                                     device=meta)}
    with pytest.raises(ValueError, match="scales"):    # 3 groups of 32
        fused_ops.rope_cache_write_prefill(qkv, qcache, THETA, "q8_0")
    assert ops.launch_counts() == counts


# -- the model through the fused entries ----------------------------------
def _pair(kvq):
    jcfg = dataclasses.replace(jreduced(jget("llama3.2-1b")), kv_quant=kvq,
                               param_dtype="f32")
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0), quantize=False)
    cfg = dataclasses.replace(reduced(get_config("llama3.2-1b")),
                              kv_quant=kvq, param_dtype="f32")
    model = Model(cfg, device="cpu")
    params = from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jm, jp, model, params


@pytest.mark.parametrize("kvq", ["bf16", "q8_0", "q4_0"])
def test_prefill_then_decode_matches_jax(kvq):
    """The slice as a whole: a right-padded prefill, then decode steps
    over the cache it wrote, against the JAX ``Model``."""
    jm, jp, model, params = _pair(kvq)
    rng = np.random.default_rng(3)
    toks = rng.integers(1, model.cfg.vocab_size, (3, 12)).astype(np.int32)
    seq_lens = np.array([12, 7, 2], np.int32)
    jc = jm.init_cache(3, 20)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks),
                                      "seq_lens": jnp.asarray(seq_lens)}, jc)
    tc = model.init_cache(3, 20)
    tl = model.prefill(params, torch.from_numpy(toks).long(), tc,
                       seq_lens=torch.from_numpy(seq_lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    dec = jax.jit(jm.decode_step)
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    for _ in range(3):
        jl, jc = dec(jp, jnp.asarray(tok), jc, jnp.ones((3,), bool))
        tl = model.decode_step(params, torch.from_numpy(tok).long(), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-4)
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    assert tc["lens"].tolist() == (seq_lens + 3).tolist()


class _Calls:
    """Counts the calls of the model's kernel entries in ``ops``."""

    def __init__(self, monkeypatch, names):
        self.n = dict.fromkeys(names, 0)
        for name in names:
            fn = getattr(ops, name)
            monkeypatch.setattr(ops, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def counted(*a, **kw):
            self.n[name] += 1
            return fn(*a, **kw)
        return counted


ENTRIES = ("rmsnorm", "add_rmsnorm", "rope_cache_write",
           "rope_cache_write_prefill")


def test_decode_step_folds_every_residual_add_and_takes_kv_len_once(
        monkeypatch):
    model = Model(reduced(get_config("llama3.2-1b")), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    cache = model.init_cache(2, 6)
    cache["lens"].copy_(torch.tensor([2, 6], dtype=torch.int32))
    L = model.cfg.num_layers
    calls = _Calls(monkeypatch, ENTRIES)
    seen = []
    decode = attn.attention_decode

    def spy(p, cfg, x, c, lens, kv_len, *rest):
        seen.append(kv_len)
        return decode(p, cfg, x, c, lens, kv_len, *rest)

    monkeypatch.setattr(attn, "attention_decode", spy)
    model.decode_step(params, torch.ones((2, 1), dtype=torch.long), cache)
    # one norm alone (layer 0's attn_norm), every other norm with the add
    # before it: no residual add runs outside add_rmsnorm
    assert calls.n == {"rmsnorm": 1, "add_rmsnorm": 2 * L,
                       "rope_cache_write": L, "rope_cache_write_prefill": 0}
    assert len(seen) == L and all(k is seen[0] for k in seen)
    assert seen[0].tolist() == [3, 6]          # min(lens + 1, S)


def test_prefill_runs_rope_and_the_cache_write_through_one_entry(
        monkeypatch):
    model = Model(dataclasses.replace(reduced(get_config("llama3.2-1b")),
                                      kv_quant="q8_0"), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    L = model.cfg.num_layers
    calls = _Calls(monkeypatch, ENTRIES)
    model.prefill(params, torch.ones((2, 5), dtype=torch.long),
                  model.init_cache(2, 8), seq_lens=torch.tensor([5, 3]))
    assert calls.n == {"rmsnorm": 1, "add_rmsnorm": 2 * L,
                       "rope_cache_write": 0, "rope_cache_write_prefill": L}
