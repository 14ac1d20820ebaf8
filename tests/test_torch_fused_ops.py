"""The plain versions of the port's fused small-op kernels
(``repro_torch.kernels.fused_ops``: RMSNorm, SwiGLU, RoPE + decode cache
write) against the JAX package's functions, on the same seeded numpy
inputs, and the wrappers' CPU routing and input checks.

Tolerances:
- bf16 outputs: one bf16 ulp at the output's scale (2**-7 * max|ref|).
  Both sides compute in f32 and round once at the same points, but XLA
  sums the mean of squares in another order, and its cos/sin may land an
  f32 ulp from PyTorch's, so a bf16 output can sit one rounding step
  apart.
- f32 outputs: 1e-6 relative to the output's scale.
- Quantized cache rows: scales bit-equal (both take amax / qmax in f32
  and round once to bf16); payloads may differ by one quantization step
  on exact .5 ties of the f32 division, which the two frameworks can
  break differently (as in test_torch_quant.py). On these inputs the
  roped rows, scales and payloads are all bit-equal to the JAX
  package's. Rows with ``advance`` False, and every position but the
  written slot, keep their bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.quant.quantize import quantize_rows as jquantize_rows
from repro_torch.bridge import to_tensor
from repro_torch.kernels import fused_ops, ops
from repro_torch.quant.quantize import kv_group_size

CPU = torch.device("cpu")


def t(a) -> torch.Tensor:
    return to_tensor(np.asarray(a), CPU)


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def assert_bf16_close(port, ref):
    ref = f32(ref)
    tol = 2.0 ** -7 * float(np.abs(ref).max())
    np.testing.assert_allclose(f32(port), ref, rtol=0, atol=tol)


def assert_f32_close(port, ref):
    ref = f32(ref)
    np.testing.assert_allclose(f32(port), ref, rtol=0,
                               atol=1e-6 * float(np.abs(ref).max()))


def _jdtype(dtype):
    return jnp.bfloat16 if dtype == "bf16" else jnp.float32


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("M,d", [(1, 64), (5, 128), (33, 2048)])
def test_rmsnorm_plain_matches_jax(dtype, M, d):
    rng = np.random.default_rng(M * d)
    x = jnp.asarray(rng.standard_normal((M, d)) * 3.0, _jdtype(dtype))
    w = jnp.asarray(1.0 + 0.1 * rng.standard_normal(d), _jdtype(dtype))
    want = jlayers.rmsnorm(x, w, 1e-5)
    got = fused_ops.rmsnorm_plain(t(x), t(w), 1e-5)
    assert got.dtype == t(x).dtype and got.shape == (M, d)
    (assert_bf16_close if dtype == "bf16" else assert_f32_close)(got, want)
    # the wrapper and the model's entry take the plain version on the CPU
    before = fused_ops.rmsnorm.launches
    assert torch.equal(ops.rmsnorm(t(x), t(w), 1e-5), got)
    assert fused_ops.rmsnorm.launches == before


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("lead,F", [((1,), 64), ((3,), 8192), ((2, 5), 96)])
def test_swiglu_on_the_fused_gate_up(dtype, lead, F):
    rng = np.random.default_rng(F)
    gu = jnp.asarray(rng.standard_normal(lead + (2 * F,)) * 2.0,
                     _jdtype(dtype))
    got = fused_ops.swiglu_plain(t(gu))
    assert got.shape == lead + (F,) and got.dtype == t(gu).dtype
    # the port's f32 form: silu(g) * u in f32, one rounding
    g, u = t(gu).float().chunk(2, dim=-1)
    want_port = (g / (1.0 + torch.exp(-g)) * u).to(got.dtype)
    (assert_bf16_close if dtype == "bf16" else assert_f32_close)(
        got, want_port)
    if dtype == "f32":      # JAX's silu(g) * u, as mlp_forward computes it
        jg, ju = jnp.split(gu, 2, axis=-1)
        assert_f32_close(got, jax.nn.silu(jg) * ju)
    assert torch.equal(ops.swiglu(t(gu)), got)


# (B, Hq, Hkv, S, D, lens, advance)
ROPE_CASES = [
    (4, 8, 2, 16, 32, [0, 5, 15, 16], [True, True, True, True]),
    (3, 4, 2, 16, 32, [16, 7, 15], [True, False, True]),
    (2, 32, 8, 64, 64, [1000, 63], [False, True]),
    (2, 4, 4, 8, 128, [3, 8], None),
]


def _rope_inputs(case, fmt):
    B, Hq, Hkv, S, D, lens, advance = case
    rng = np.random.default_rng(S * D + B)
    qkv = jnp.asarray(rng.standard_normal((B, (Hq + 2 * Hkv) * D)),
                      jnp.bfloat16)
    # a cache already holding other rows, so that frozen rows show
    old = jnp.asarray(rng.standard_normal((B, Hkv, S, D)), jnp.bfloat16)
    if fmt == "bf16":
        cache = {"k": old, "v": old * 0.5}
    else:
        kq, ks = jquantize_rows(old, fmt)
        vq, vs = jquantize_rows(old * 0.5, fmt)
        cache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    return qkv, cache


def _jax_rope_cache_write(qkv, cache, case, fmt):
    """JAX apply_rope of q and k, attention.kv_cache_write at lens % S,
    and the caller's select of the old rows where advance is False."""
    B, Hq, Hkv, S, D, lens, advance = case
    pos = jnp.asarray(lens, jnp.int32)
    q = qkv[:, :Hq * D].reshape(B, Hq, D)
    k = qkv[:, Hq * D:(Hq + Hkv) * D].reshape(B, Hkv, D)
    v = qkv[:, (Hq + Hkv) * D:].reshape(B, Hkv, D)
    q = jlayers.apply_rope(q, pos, 1e4)
    k = jlayers.apply_rope(k, pos, 1e4)
    new = jattn.kv_cache_write(cache, k, v, pos % S, kv_quant=fmt,
                               group=32)
    if advance is not None:
        keep = jnp.asarray(advance)[:, None, None, None]
        new = {n: jnp.where(keep, leaf, cache[n]) for n, leaf in new.items()}
    return q, new


def _unpack(payload: torch.Tensor, fmt: str) -> np.ndarray:
    if fmt == "q8_0":
        return payload.numpy().astype(np.int32)
    lo = (payload.to(torch.int32) << 28) >> 28
    hi = payload.to(torch.int32) >> 4
    return torch.stack([lo, hi], -1).flatten(-2).numpy()


@pytest.mark.parametrize("fmt", ["bf16", "q8_0", "q4_0"])
@pytest.mark.parametrize("case", ROPE_CASES)
def test_rope_cache_write_plain_matches_jax(case, fmt):
    B, Hq, Hkv, S, D, lens, advance = case
    qkv, jcache = _rope_inputs(case, fmt)
    want_q, want = _jax_rope_cache_write(qkv, jcache, case, fmt)
    cache = {n: t(a) for n, a in jcache.items()}
    before = {n: leaf.clone() for n, leaf in cache.items()}
    adv = None if advance is None else torch.tensor(advance)
    q = ops.rope_cache_write(t(qkv), cache, torch.tensor(lens,
                                                         dtype=torch.int32),
                             adv, 1e4, fmt)
    assert q.shape == (B, Hq, D) and q.dtype == torch.bfloat16
    assert_bf16_close(q, want_q)
    slot = [p % S for p in lens]
    for b in range(B):
        # every position but the written slot, and the whole row of a
        # frozen slot, keeps its bits
        written = advance is None or advance[b]
        for n, leaf in cache.items():
            for s in range(S):
                if written and s == slot[b]:
                    continue
                assert torch.equal(leaf[b, :, s], before[n][b, :, s]), \
                    (n, b, s)
    if fmt == "bf16":
        for n in ("k", "v"):
            assert_bf16_close(cache[n], want[n])
        return
    g = D // cache["k_scale"].shape[-1]
    assert g == kv_group_size(D, 32, fmt)
    for n in ("k", "v"):
        np.testing.assert_array_equal(f32(cache[f"{n}_scale"]),
                                      f32(want[f"{n}_scale"]))
        diff = np.abs(_unpack(cache[n], fmt) - _unpack(t(want[n]), fmt))
        assert diff.max() <= 1
        assert (diff > 0).mean() < 0.02


def test_rope_cache_write_plain_is_apply_rope_and_kv_cache_write():
    """On the CPU the wrapper's result is bit for bit today's path:
    apply_rope of q and k, then kv_cache_write at lens % S."""
    case = ROPE_CASES[1]
    B, Hq, Hkv, S, D, lens, advance = case
    for fmt in ("bf16", "q8_0", "q4_0"):
        qkv, jcache = _rope_inputs(case, fmt)
        qkv = t(qkv)
        a = {n: t(x) for n, x in jcache.items()}
        b = {n: x.clone() for n, x in a.items()}
        pos = torch.tensor(lens, dtype=torch.int32)
        adv = torch.tensor(advance)
        q = fused_ops.rope_cache_write(qkv, a, pos, adv, 1e4, fmt)
        want_q = fused_ops.apply_rope(qkv[:, :Hq * D].reshape(B, Hq, D),
                                      pos, 1e4)
        k = fused_ops.apply_rope(
            qkv[:, Hq * D:(Hq + Hkv) * D].reshape(B, Hkv, D), pos, 1e4)
        v = qkv[:, (Hq + Hkv) * D:].reshape(B, Hkv, D)
        fused_ops.kv_cache_write(b, k, v, pos % S, kv_quant=fmt, group=32,
                                 advance=adv)
        assert torch.equal(q, want_q)
        for n in a:
            assert torch.equal(a[n], b[n]), (fmt, n)


def test_wrappers_reject_bad_inputs():
    cache = {"k": torch.zeros(2, 2, 8, 32, dtype=torch.bfloat16),
             "v": torch.zeros(2, 2, 8, 32, dtype=torch.bfloat16)}
    lens = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):      # width is not (Hq + 2 Hkv) x D
        fused_ops.rope_cache_write(torch.zeros(2, 100, dtype=torch.bfloat16),
                                   cache, lens, None, 1e4, "bf16")
    with pytest.raises(ValueError):
        fused_ops.rope_cache_write(torch.zeros(2, 256, dtype=torch.bfloat16),
                                   cache, lens, None, 1e4, "q5_0")
