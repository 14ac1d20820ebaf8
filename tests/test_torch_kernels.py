"""Plain versions of the port's kernels against the JAX package's
kernels (Pallas in interpret mode) and its XLA paths, on the same seeded
numpy inputs; plus the kernel wrappers' CPU routing and input checks.

Tolerance: one bf16 ulp at the output's scale (2**-7 * max|ref|) for
bf16 outputs. Both sides round at the same points (q*scale and p to the
input dtype, dequantized weights and cache rows to bf16) and accumulate
in f32, but in another order, and the Pallas kernels keep an online
softmax over cache blocks; a bf16 output may therefore land one rounding
step apart. f32 outputs: 1e-5 relative.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.decode_attention import decode_attention as pallas_da
from repro.kernels.decode_attention_quant import (
    decode_attention_quant as pallas_daq)
from repro.kernels.quant_matmul import quant_matmul as pallas_qmm
from repro.quant.quantize import QuantizedTensor as JQT
from repro.quant.quantize import quantize_q4_0, quantize_q8_0, quantize_rows
from repro_torch.bridge import to_tensor
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain)
from repro_torch.kernels.decode_attention_quant import (
    decode_attention_quant, decode_attention_quant_plain)
from repro_torch.kernels.quant_matmul import quant_matmul, quant_matmul_plain
from repro_torch.quant.quantize import QuantizedTensor

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


def _attn_inputs(seed, B, Hq, Hkv, S, D, qdtype=jnp.bfloat16):
    rng = np.random.default_rng(seed)
    q = jnp.asarray(rng.standard_normal((B, Hq, D)), qdtype)
    k = jnp.asarray(rng.standard_normal((B, Hkv, S, D)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((B, Hkv, S, D)), jnp.bfloat16)
    return q, k, v


ATTN_CASES = [
    # (B, Hq, Hkv, S, D, kv_len, window)
    (3, 8, 2, 64, 32, [0, 1, 64], 0),       # empty row, one key, full
    (2, 4, 4, 128, 64, [37, 128], 0),       # MHA, ragged kv_len
    (2, 8, 2, 64, 32, [64, 20], 8),         # sliding window
    (1, 8, 1, 32, 64, [5], 0),              # MQA
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_decode_attention_plain_matches_jax(case):
    B, Hq, Hkv, S, D, lens, window = case
    q, k, v = _attn_inputs(0, B, Hq, Hkv, S, D)
    lens_j = jnp.asarray(lens, jnp.int32)
    got = decode_attention_plain(t(q), t(k), t(v), torch.tensor(lens),
                                 window=window)
    assert got.dtype == torch.bfloat16 and got.shape == (B, Hq, D)
    assert_bf16_close(got, jops._decode_attention_jnp(q, k, v, lens_j,
                                                      window=window))
    assert_bf16_close(got, pallas_da(q, k, v, lens_j, window=window,
                                     bk=32, interpret=True))
    # the wrapper takes the plain version for CPU tensors
    wrapped = decode_attention(t(q), t(k), t(v), torch.tensor(lens),
                               window=window)
    assert torch.equal(wrapped, got)
    if 0 in lens:
        assert float(got[lens.index(0)].abs().max()) == 0.0


def test_decode_attention_plain_f32_query_matches_jax():
    """f32 params serve a bf16 cache: q is f32, K/V bf16 (promoted)."""
    q, k, v = _attn_inputs(1, 2, 8, 2, 64, 32, qdtype=jnp.float32)
    lens = [17, 64]
    got = decode_attention_plain(t(q), t(k), t(v), torch.tensor(lens))
    want = jops._decode_attention_jnp(q, k, v, jnp.asarray(lens, jnp.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fmt", ["q8_0", "q4_0"])
@pytest.mark.parametrize("case", ATTN_CASES[:3])
def test_decode_attention_quant_plain_matches_jax(fmt, case):
    B, Hq, Hkv, S, D, lens, window = case
    q, k, v = _attn_inputs(2, B, Hq, Hkv, S, D)
    kq, ks = quantize_rows(k, fmt)
    vq, vs = quantize_rows(v, fmt)
    lens_j = jnp.asarray(lens, jnp.int32)
    args = [t(a) for a in (q, kq, ks, vq, vs)]
    got = decode_attention_quant_plain(*args, torch.tensor(lens), fmt=fmt,
                                       window=window)
    assert_bf16_close(got, jops.decode_attention_quant(
        q, kq, ks, vq, vs, lens_j, fmt=fmt, window=window))
    assert_bf16_close(got, pallas_daq(q, kq, ks, vq, vs, lens_j, fmt=fmt,
                                      window=window, bk=32, interpret=True))
    wrapped = decode_attention_quant(*args, torch.tensor(lens), fmt=fmt,
                                     window=window)
    assert torch.equal(wrapped, got)


def test_decode_attention_quant_rejects_bad_inputs():
    q = torch.zeros(1, 4, 32, dtype=torch.bfloat16)
    kq = torch.zeros(1, 2, 8, 32, dtype=torch.int8)
    ks = torch.zeros(1, 2, 8, 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        decode_attention_quant(q, kq, ks, kq, ks, [1], fmt="q5_0")
    with pytest.raises(ValueError):          # q4_0 payload must be D/2
        decode_attention_quant(q, kq, ks, kq, ks, [1], fmt="q4_0")


def _jax_weight(seed, K, N, fmt):
    rng = np.random.default_rng(seed)
    w = jnp.asarray(rng.standard_normal((K, N)) * K ** -0.5, jnp.float32)
    return (quantize_q8_0 if fmt == "q8_0" else quantize_q4_0)(w)


def _port_weight(jw: JQT) -> QuantizedTensor:
    return QuantizedTensor(t(jw.data), t(jw.scales), jw.fmt, jw.group)


@pytest.mark.parametrize("fmt", ["q8_0", "q4_0"])
@pytest.mark.parametrize("mkn", [(1, 64, 128), (3, 96, 80), (4, 256, 48)])
def test_quant_matmul_plain_matches_jax(fmt, mkn):
    M, K, N = mkn
    jw = _jax_weight(3, K, N, fmt)
    x = jnp.asarray(np.random.default_rng(4).standard_normal((M, K)),
                    jnp.bfloat16)
    w = _port_weight(jw)
    got = quant_matmul_plain(t(x), w)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert_bf16_close(got, jops.matmul(x, jw))                   # XLA path
    assert_bf16_close(got, pallas_qmm(x, jw, bm=M, bn=N, bk=K,
                                      interpret=True))
    got32 = quant_matmul_plain(t(x), w, torch.float32)
    want32 = pallas_qmm(x, jw, bm=M, bn=N, bk=K, out_dtype=jnp.float32,
                        interpret=True)
    np.testing.assert_allclose(f32(got32), f32(want32), rtol=1e-5,
                               atol=1e-5 * float(np.abs(f32(want32)).max()))
    before = quant_matmul.launches
    assert torch.equal(quant_matmul(t(x), w), got)   # CPU: plain version
    assert quant_matmul.launches == before


def test_quant_matmul_rejects_bad_shapes():
    w = _port_weight(_jax_weight(5, 64, 16, "q8_0"))
    with pytest.raises(ValueError):
        quant_matmul(torch.zeros(2, 32, dtype=torch.bfloat16), w)
    odd = QuantizedTensor(torch.zeros(48, 16, dtype=torch.int8),
                          torch.zeros(1, 16, dtype=torch.bfloat16), "q8_0")
    with pytest.raises(ValueError):
        quant_matmul(torch.zeros(2, 48, dtype=torch.bfloat16), odd)


def test_matmul_routes_plain_and_quantized_weights():
    """bf16 weights: f32-accumulated library product cast to out_dtype
    (f32 logits for the unembedding); quantized: quant_matmul."""
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.standard_normal((2, 1, 64)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((64, 40)) * 0.125, jnp.bfloat16)
    got = ops.matmul(t(x), t(w), out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (2, 1, 40)
    want = jops.matmul(x, w, out_dtype=jnp.float32)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=1e-5)
    assert_bf16_close(ops.matmul(t(x), t(w)), jops.matmul(x, w))
    jw = _jax_weight(7, 64, 40, "q4_0")
    assert_bf16_close(ops.matmul(t(x), _port_weight(jw)),
                      jops.matmul(x, jw))
