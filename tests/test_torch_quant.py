"""The port's quantization helpers against the JAX package's
(``repro.quant.quantize``), on the same seeded numpy inputs.

Tolerances: scales are bit-equal (both compute amax / qmax in f32 and
round once to bf16). Payloads may differ by one quantization step on
exact .5 ties, because the two frameworks' f32 divisions can land one
ulp apart there; everything else is bit-equal. Dequantized values
follow from payload and scale, so they agree wherever the payloads do.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.bridge import to_tensor

# the packages re-export a ``quantize`` function over the module name
jq = importlib.import_module("repro.quant.quantize")
tq = importlib.import_module("repro_torch.quant.quantize")

CPU = torch.device("cpu")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp(a) -> np.ndarray:
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _payload_close(port, ref, fmt):
    """Equal except for a one-step difference on a small share of
    elements (the .5 ties)."""
    if fmt == "q4_0":
        p = _unpacked(port)
        r = _unpacked(torch.from_numpy(np.array(ref)))
    else:
        p = port.numpy().astype(np.int32)
        r = np.asarray(ref).astype(np.int32)
    diff = np.abs(p - r)
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.02


def _unpacked(packed: torch.Tensor) -> np.ndarray:
    lo, hi = tq._sign_extend_nibbles(packed)
    return np.concatenate([lo.numpy(), hi.numpy()]).astype(np.int32)


@pytest.mark.parametrize("fmt", ["q8_0", "q4_0"])
@pytest.mark.parametrize("shape", [(64, 48), (96, 80), (2, 32, 16)])
def test_weight_quantize_matches_jax(fmt, shape):
    rng = np.random.default_rng(0)
    w = rng.standard_normal(shape).astype(np.float32)
    ref = (jq.quantize_q8_0 if fmt == "q8_0" else jq.quantize_q4_0)(
        jnp.asarray(w))
    port = (tq.quantize_q8_0 if fmt == "q8_0" else tq.quantize_q4_0)(
        torch.from_numpy(w))
    assert port.fmt == ref.fmt and port.group == ref.group
    assert port.logical_shape == tuple(ref.logical_shape) == shape
    np.testing.assert_array_equal(_np(port.scales), _jnp(ref.scales))
    _payload_close(port.data, ref.data, fmt)
    deq = tq.dequantize(port, torch.float32).numpy()
    want = np.asarray(jq.dequantize(ref, jnp.float32))
    step = np.repeat(_jnp(ref.scales), 32, axis=-2)
    assert np.all(np.abs(deq - want) <= step + 1e-6)


def test_pack_int4_nibble_order_matches_jax():
    """Low nibble = even K index, high nibble = odd; sign-extended."""
    rng = np.random.default_rng(1)
    q = rng.integers(-8, 8, size=(16, 12)).astype(np.int8)
    packed = tq.pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jq.pack_int4(jnp.asarray(q))))
    u = packed.numpy().astype(np.uint8)
    np.testing.assert_array_equal(((u & 0xF) ^ 8).astype(np.int8) - 8,
                                  q[0::2])
    np.testing.assert_array_equal(tq.unpack_int4(packed).numpy(), q)
    rows = tq.pack_int4_rows(torch.from_numpy(q))
    np.testing.assert_array_equal(
        rows.numpy(), np.asarray(jq.pack_int4_rows(jnp.asarray(q))))
    np.testing.assert_array_equal(tq.unpack_int4_rows(rows).numpy(), q)


@pytest.mark.parametrize("fmt", ["q8_0", "q4_0"])
@pytest.mark.parametrize("dim", [32, 64, 128, 48, 20])
def test_kv_rows_match_jax(fmt, dim):
    assert tq.kv_group_size(dim, 32, fmt) == jq.kv_group_size(dim, 32, fmt)
    rng = np.random.default_rng(dim)
    x = rng.standard_normal((3, 2, 7, dim)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    rq, rs = jq.quantize_rows(xb, fmt)
    pq, ps = tq.quantize_rows(to_tensor(np.asarray(xb), CPU), fmt)
    np.testing.assert_array_equal(_np(ps), _jnp(rs))
    diff = np.abs(_unpacked_rows(pq, fmt) - _unpacked_rows(
        torch.from_numpy(np.asarray(rq)), fmt))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.05
    # the dequantized view of the port's own payload equals JAX's
    # dequantization of the same payload, bit for bit
    np.testing.assert_array_equal(
        _np(tq.dequantize_rows(pq, ps, fmt)),
        _jnp(jq.dequantize_rows(jnp.asarray(pq.numpy()),
                                jnp.asarray(np.asarray(rs)), fmt)))


def _unpacked_rows(payload: torch.Tensor, fmt: str) -> np.ndarray:
    if fmt == "q4_0":
        payload = tq.unpack_int4_rows(payload)
    return payload.numpy().astype(np.int32)


def test_kv_group_size_rejects_odd_q4_dims():
    with pytest.raises(ValueError):
        tq.kv_group_size(33, 32, "q4_0")
    assert tq.kv_group_size(33, 32, "q8_0") == 11


def test_quantize_tree_selects_the_same_leaves_as_jax():
    """Matrices with K % group == 0 quantize; embed and norm paths and
    sub-2-D leaves stay plain; lists (per-layer params) are walked."""
    rng = np.random.default_rng(2)
    mats = {"embedding": (64, 32), "w_odd": (33, 32), "w": (64, 32)}
    tree_np = {k: rng.standard_normal(s).astype(np.float32)
               for k, s in mats.items()}
    tree_np["final_norm"] = np.ones((32,), np.float32)
    tree_np["norm_mat"] = rng.standard_normal((64, 32)).astype(np.float32)
    ref = jq.quantize_tree(jax.tree_util.tree_map(jnp.asarray, tree_np),
                           "q8_0")
    port = tq.quantize_tree(
        {k: torch.from_numpy(v) for k, v in tree_np.items()}, "q8_0")
    for k in tree_np:
        assert isinstance(port[k], tq.QuantizedTensor) == \
            isinstance(ref[k], jq.QuantizedTensor), k
    layered = tq.quantize_tree({"layers": [{"w": torch.zeros(64, 8)}]},
                               "q4_0")
    assert isinstance(layered["layers"][0]["w"], tq.QuantizedTensor)
    again = tq.quantize_tree(port, "q8_0")
    assert again["w"] is port["w"]
    assert tq.quantize_tree(port, "bf16") is port
