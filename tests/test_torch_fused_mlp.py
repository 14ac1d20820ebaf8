"""The FFN's gate-up product with its SwiGLU as one operation
(``repro_torch.kernels.quant_matmul.quant_matmul_swiglu``): its plain
version against the JAX package's chain on the same seeded numpy inputs,
the wrapper's routing and input checks, and the model that runs through
it (reduced llama3.2-1b) against the JAX ``mlp_forward``.

Tolerances:
- ``quant_matmul_swiglu_plain`` is the unfused plain chain, bit for bit.
- Against the JAX chain (the Pallas ``quant_matmul`` in interpret mode,
  ``jnp.split``, silu in f32 times u, one rounding to bf16): one bf16 ulp
  at the output's scale (2**-7 * max|ref|). Both sides round the product
  and h once to bf16, but sum the product in another order.
- ``mlp_forward`` against the JAX ``mlp_forward``: 0.025 of the output's
  largest magnitude, as in ``test_torch_model.py``: XLA's bf16
  ``logistic`` inside ``jax.nn.silu`` rounds differently from the port's
  f32 silu with one rounding.
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
from repro.kernels.quant_matmul import quant_matmul as pallas_qmm
from repro.models import mlp as jmlp
from repro.quant.quantize import quantize_q4_0, quantize_q8_0
from repro_torch.bridge import to_tensor
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import fused_ops, ops
from repro_torch.kernels.quant_matmul import (quant_matmul,
                                              quant_matmul_plain,
                                              quant_matmul_swiglu,
                                              quant_matmul_swiglu_plain)
from repro_torch.models import Model, layers
from repro_torch.models import mlp as mlp_mod
from repro_torch.quant.quantize import QuantizedTensor, quantize_tree

CPU = torch.device("cpu")


def t(a) -> torch.Tensor:
    return to_tensor(np.asarray(a), CPU)


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _jax_weight(seed, K, N, fmt):
    rng = np.random.default_rng(seed)
    w = jnp.asarray(rng.standard_normal((K, N)) * K ** -0.5, jnp.float32)
    return (quantize_q8_0 if fmt == "q8_0" else quantize_q4_0)(w)


def _port_weight(jw) -> QuantizedTensor:
    return QuantizedTensor(t(jw.data), t(jw.scales), jw.fmt, jw.group)


def _jax_chain(x, jw, M, K, F):
    """The Pallas ``quant_matmul`` (interpret mode, one block), then the
    JAX ``mlp_forward``'s split and SwiGLU in f32, rounded once."""
    gu = pallas_qmm(x, jw, bm=M, bn=2 * F, bk=K, interpret=True)
    g, u = jnp.split(gu, 2, axis=-1)
    h = jax.nn.silu(g.astype(jnp.float32)) * u.astype(jnp.float32)
    return h.astype(jnp.bfloat16)


# -- the operation --------------------------------------------------------
@pytest.mark.parametrize("F", [64, 100, 8])
@pytest.mark.parametrize("K", [64, 256])
@pytest.mark.parametrize("M", [1, 4, 33])
@pytest.mark.parametrize("fmt", ["q8_0", "q4_0"])
def test_quant_matmul_swiglu_plain_matches_jax(fmt, M, K, F):
    jw = _jax_weight(K + F, K, 2 * F, fmt)
    x = jnp.asarray(np.random.default_rng(M * K).standard_normal((M, K)),
                    jnp.bfloat16)
    w = _port_weight(jw)
    got = quant_matmul_swiglu_plain(t(x), w)
    assert got.dtype == torch.bfloat16 and got.shape == (M, F)
    # the unfused plain chain, bit for bit
    assert torch.equal(got, fused_ops.swiglu_plain(
        quant_matmul_plain(t(x), w)))
    ref = f32(_jax_chain(x, jw, M, K, F))
    tol = 2.0 ** -7 * float(np.abs(ref).max())
    np.testing.assert_allclose(f32(got), ref, rtol=0, atol=tol)
    # the wrapper takes the plain version on the CPU and counts nothing
    before = quant_matmul_swiglu.launches
    assert torch.equal(quant_matmul_swiglu(t(x), w), got)
    assert torch.equal(ops.quant_matmul_swiglu(t(x), w), got)
    assert quant_matmul_swiglu.launches == before


def test_quant_matmul_swiglu_keeps_f32_activations_on_the_cpu():
    """f32 params (the models' tight-parity configuration): the plain
    chain in x's dtype, as the unfused ``ops.matmul`` + ``swiglu``."""
    w = _port_weight(_jax_weight(3, 64, 48, "q8_0"))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (5, 64)).astype(np.float32))
    got = quant_matmul_swiglu(x, w)
    assert got.dtype == torch.float32 and got.shape == (5, 24)
    assert torch.equal(got, ops.swiglu(ops.matmul(x, w)))


def test_quant_matmul_swiglu_rejects_bad_inputs_and_never_falls_back():
    """An odd width, a K that is no multiple of the group or of the
    weight's, and (off the CPU: the meta device, which is no CUDA device)
    a non-bf16 x, a misshapen scale table or a non-CUDA tensor raise; no
    launch is counted and no plain version runs."""
    w = _port_weight(_jax_weight(5, 64, 32, "q8_0"))
    odd = QuantizedTensor(torch.zeros(64, 33, dtype=torch.int8),
                          torch.zeros(2, 33, dtype=torch.bfloat16), "q8_0")
    with pytest.raises(ValueError, match="odd"):
        quant_matmul_swiglu(torch.zeros(2, 64, dtype=torch.bfloat16), odd)
    with pytest.raises(ValueError, match="K=32"):
        quant_matmul_swiglu(torch.zeros(2, 32, dtype=torch.bfloat16), w)
    ragged = QuantizedTensor(torch.zeros(48, 16, dtype=torch.int8),
                             torch.zeros(1, 16, dtype=torch.bfloat16), "q8_0")
    with pytest.raises(ValueError, match="group"):
        quant_matmul_swiglu(torch.zeros(2, 48, dtype=torch.bfloat16), ragged)
    meta = torch.device("meta")
    mw = QuantizedTensor(torch.empty(64, 32, dtype=torch.int8, device=meta),
                         torch.empty(2, 32, dtype=torch.bfloat16,
                                     device=meta), "q8_0")
    x = torch.empty(3, 64, dtype=torch.bfloat16, device=meta)
    counts = dict(ops.launch_counts())
    with pytest.raises(ValueError, match="CUDA"):
        quant_matmul_swiglu(x, mw)
    with pytest.raises(ValueError, match="bf16"):
        quant_matmul_swiglu(x.float(), mw)
    bad_scales = dataclasses.replace(
        mw, scales=torch.empty(1, 32, dtype=torch.bfloat16, device=meta))
    with pytest.raises(ValueError, match="scales"):
        quant_matmul_swiglu(x, bad_scales)
    assert ops.launch_counts() == counts


# -- the model through it -------------------------------------------------
def _mlp_params(fmt, D, F):
    jp = {"w_gate_up": {"w": _jax_weight(1, D, 2 * F, fmt)},
          "w_down": {"w": _jax_weight(2, F, D, fmt)}}
    tp = {name: {"w": _port_weight(leaf["w"])} for name, leaf in jp.items()}
    return jp, tp


@pytest.mark.parametrize("shape", [(2, 1), (3, 5)])
@pytest.mark.parametrize("fmt", ["q8_0", "q4_0"])
def test_mlp_forward_quantized_matches_jax(fmt, shape):
    """The port's FFN with a quantized ``w_gate_up`` (the fused operation)
    against the JAX ``mlp_forward`` on the same quantized params, for
    decode-shaped (B, 1) and prefill-shaped (B, S) inputs; and bit-equal
    to the unfused port chain."""
    jcfg = jreduced(jget("llama3.2-1b"))
    D, F = jcfg.d_model, jcfg.d_ff
    jp, tp = _mlp_params(fmt, D, F)
    x = jnp.asarray(np.random.default_rng(sum(shape)).standard_normal(
        shape + (D,)), jnp.bfloat16)
    want = f32(jmlp.mlp_forward(jp, jcfg, x))
    got = mlp_mod.mlp_forward(tp, t(x))
    assert got.shape == shape + (D,) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), want, rtol=0,
                               atol=0.025 * float(np.abs(want).max()))
    unfused = layers.linear(tp["w_down"], layers.swiglu(
        layers.linear(tp["w_gate_up"], t(x))))
    assert torch.equal(got, unfused)


class _Calls:
    """Counts the calls of ``ops`` entries (CPU calls launch nothing, so
    the wrappers' counters stay still)."""

    def __init__(self, monkeypatch, names):
        self.n = dict.fromkeys(names, 0)
        for name in names:
            monkeypatch.setattr(ops, name, self._wrap(name, getattr(ops,
                                                                   name)))

    def _wrap(self, name, fn):
        def counted(*a, **kw):
            self.n[name] += 1
            return fn(*a, **kw)
        return counted


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("entry", ["decode_step", "prefill"])
def test_model_takes_the_fused_gate_up_only_with_quantized_weights(
        monkeypatch, entry, quantized):
    """A decode step and a prefill call run the gate-up product and its
    SwiGLU once a layer: as ``quant_matmul_swiglu`` (and no standalone
    SwiGLU, no quant_matmul of the gate-up) under quantized weights, as
    ``matmul`` + ``swiglu`` under bf16 weights."""
    model = Model(reduced(get_config("llama3.2-1b")), device="cpu")
    params = model.init(torch.Generator().manual_seed(0), quantize=False)
    if quantized:
        params = quantize_tree(params, "q8_0", model.cfg.quant_group)
    L = model.cfg.num_layers
    calls = _Calls(monkeypatch, ("quant_matmul_swiglu", "swiglu", "matmul"))
    cache = model.init_cache(2, 8)
    if entry == "decode_step":
        model.decode_step(params, torch.ones((2, 1), dtype=torch.long),
                          cache)
    else:
        model.prefill(params, torch.ones((2, 5), dtype=torch.long), cache,
                      seq_lens=torch.tensor([5, 3]))
    # the other linears (wqkv, wo, w_down) and the unembedding go through
    # matmul either way; the gate-up too with plain weights
    assert calls.n == {"quant_matmul_swiglu": L if quantized else 0,
                       "swiglu": 0 if quantized else L,
                       "matmul": 3 * L + 1 + (0 if quantized else L)}


def test_quantized_decode_step_equals_the_unfused_chain(monkeypatch):
    """On the CPU the fused operation is the unfused chain: a quantized
    model's logits do not move when ``mlp_forward`` runs ``matmul`` +
    ``swiglu`` in its place."""
    model = Model(reduced(get_config("llama3.2-1b")), device="cpu")
    params = quantize_tree(model.init(torch.Generator().manual_seed(1),
                                      quantize=False), "q4_0",
                           model.cfg.quant_group)
    toks = torch.tensor([[3], [7]])
    fused = model.decode_step(params, toks, model.init_cache(2, 4))
    monkeypatch.setattr(ops, "quant_matmul_swiglu",
                        lambda x, w: ops.swiglu(ops.matmul(x, w)))
    unfused = model.decode_step(params, toks, model.init_cache(2, 4))
    assert torch.equal(fused, unfused)
    # and the kernel entry's plain version is the same chain
    x = torch.randn(3, model.cfg.d_model, generator=torch.Generator()
                    .manual_seed(2)).bfloat16()
    w = params["layers"][0]["mlp"]["w_gate_up"]["w"]
    assert torch.equal(quant_matmul_swiglu(x, w),
                       fused_ops.swiglu(quant_matmul(x, w)))
