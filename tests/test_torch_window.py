"""The windowed family and the ring prefill write in the port against the
JAX package on the CPU: reduced mistral-7b with a sliding window of 16
and max_len 64, so that every slot's cache is a ring of 16 positions (f32
params drawn by JAX and carried by ``repro_torch.bridge``).

- The ring write alone: ``rope_cache_write_prefill``'s plain version
  (with a bias) against the JAX ``apply_rope`` and the ring branch of
  ``_write_prefill_kv``, in the three cache formats: q, k and v equal,
  bf16 rows equal, quantized scales equal and payloads one step apart
  only on .5 ties (the comparison of test_torch_fused_prefill.py).
- ``Model.prefill`` of 10, 16, 23 and 40 tokens (23 and 40 take the ring)
  and decode steps across the ring's edge, against the JAX ``Model``:
  logits within 1e-4, cache rows within a bf16 rounding step (plus one
  quantization step for a quantized cache), each decode step from the
  JAX cache carried over (test_torch_paper_models.py says why).
- The engines: equal greedy streams under chunked and stall admission,
  paging off for the window, and ``PromptTooLong`` raised in exactly the
  cases where the JAX ``submit`` raises it.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import functools

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
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch.bridge import from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import fused_ops
from repro_torch.models import Model
from repro_torch.models.attention import kv_cache_read
from repro_torch.serving import PromptTooLong, Request, ServingEngine
from test_torch_fused_prefill import _ties, _unpack, f32, t

WINDOW, MAX_LEN = 16, 64
FMTS = ["bf16", "q8_0", "q4_0"]
THETA = 1e4


@functools.lru_cache(maxsize=None)
def _pair(kvq="bf16", window=WINDOW):
    over = dict(sliding_window=window, kv_quant=kvq, param_dtype="f32")
    jm = JModel(jreduced(jget("mistral-7b-v0.1"), **over))
    jp = jm.init(jax.random.PRNGKey(0), quantize=False)
    model = Model(reduced(get_config("mistral-7b-v0.1"), **over),
                  device="cpu")
    params = from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jm, jp, model, params


@functools.lru_cache(maxsize=None)
def _jits(kvq):
    jm = _pair(kvq)[0]
    return jax.jit(jm.prefill), jax.jit(jm.decode_step)


def _port_cache(jc):
    return from_jax(jax.tree_util.tree_map(np.asarray, jc), device="cpu")


def _prompt(n, seed=3):
    return np.random.default_rng(seed).integers(1, 512, n).astype(np.int32)


# -- the ring write alone ------------------------------------------------------
@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("S", [23, 40])
def test_ring_prefill_write_plain_matches_jax(S, fmt):
    """B 2, Hq 4, Hkv 2, D 32 into a 16-position cache already holding
    other rows (every position is written), with a fused-QKV bias."""
    B, Hq, Hkv, D, S_cache = 2, 4, 2, 32, WINDOW
    rng = np.random.default_rng(S)
    W = (Hq + 2 * Hkv) * D
    qkv = jnp.asarray(rng.standard_normal((B, S, W)), jnp.bfloat16)
    bias = jnp.asarray(rng.standard_normal((W,)), jnp.bfloat16)
    old = jnp.asarray(rng.standard_normal((B, Hkv, S_cache, D)),
                      jnp.bfloat16)
    if fmt == "bf16":
        jcache = {"k": old, "v": old * 0.5}
    else:
        kq, ks = jquantize_rows(old, fmt)
        vq, vs = jquantize_rows(old * 0.5, fmt)
        jcache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    biased = qkv + bias                        # the JAX layers.linear's add
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    q = jlayers.apply_rope(biased[..., :Hq * D].reshape(B, S, Hq, D), pos,
                           THETA)
    k = jlayers.apply_rope(
        biased[..., Hq * D:(Hq + Hkv) * D].reshape(B, S, Hkv, D), pos, THETA)
    v = biased[..., (Hq + Hkv) * D:].reshape(B, S, Hkv, D)
    q, k, v = (jnp.swapaxes(a, 1, 2) for a in (q, k, v))
    want = jwrite_prefill_kv(dict(jcache, lens=jnp.zeros((B,), jnp.int32)),
                             k, v, S, kv_quant=fmt, group=32)
    assert np.asarray(want.pop("lens")).tolist() == [S] * B
    cache = {n: t(a) for n, a in jcache.items()}
    got = fused_ops.rope_cache_write_prefill(t(qkv), cache, THETA, fmt,
                                             bias=t(bias))
    for g_, w_ in zip(got, (q, k, v)):
        assert g_.shape[2] == S                # all S positions, not the ring
        np.testing.assert_array_equal(f32(g_), f32(w_))
    if fmt == "bf16":
        for n in ("k", "v"):
            np.testing.assert_array_equal(f32(cache[n]), f32(want[n]))
        return
    ng = cache["k_scale"].shape[-1]
    for n, rows in (("k", f32(got[1])), ("v", f32(got[2]))):
        np.testing.assert_array_equal(f32(cache[f"{n}_scale"]),
                                      f32(want[f"{n}_scale"]))
        diff = np.abs(_unpack(cache[n].numpy(), fmt)
                      - _unpack(np.asarray(want[n]), fmt))
        # ring slot j holds position S - S_cache + (j - S) % S_cache
        slot_pos = S - S_cache + (np.arange(S_cache) - S) % S_cache
        assert diff.max() <= 1
        assert ((diff == 0) | _ties(rows[:, :, slot_pos], fmt, ng)).all()


# -- the model -----------------------------------------------------------------
def _rows_close(t_layers, want_layers, kvq):
    for t_l, w_l in zip(t_layers, want_layers):
        tol = 0.02
        if kvq != "bf16":
            tol += max(float(w_l[n].float().max())
                       for n in ("k_scale", "v_scale"))
        for got, ref in zip(kv_cache_read(t_l, kv_quant=kvq),
                            kv_cache_read(w_l, kv_quant=kvq)):
            torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                                       atol=tol)


@pytest.mark.parametrize("kvq", FMTS)
@pytest.mark.parametrize("S", [10, 16, 23, 40])
def test_prefill_matches_jax(S, kvq):
    jm, jp, model, params = _pair(kvq)
    pre, _ = _jits(kvq)
    prompt = _prompt(S)
    jl, jc = pre(jp, {"tokens": jnp.asarray(prompt[None])},
                 jm.init_cache(1, MAX_LEN))
    tc = model.init_cache(1, MAX_LEN)
    assert model.cache_len(tc) == WINDOW
    tl = model.prefill(params, torch.from_numpy(prompt[None]).long(), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-4)
    want = _port_cache(jc)
    assert tc["lens"].tolist() == want["lens"].tolist() == [S]
    _rows_close(tc["layers"], want["layers"], kvq)


@pytest.mark.parametrize("kvq", FMTS)
def test_decode_across_the_ring_edge(kvq):
    """A 10-token prefill, then 10 decode steps: the write cursor crosses
    slot 16 (back to 0) at the seventh; logits and every row of the ring
    after each step."""
    jm, jp, model, params = _pair(kvq)
    pre, dec = _jits(kvq)
    _, jc = pre(jp, {"tokens": jnp.asarray(_prompt(10)[None])},
                jm.init_cache(1, MAX_LEN))
    for tok in _prompt(10, seed=4):
        toks = np.array([[tok]], np.int32)
        tc = _port_cache(jc)
        jl, jc = dec(jp, jnp.asarray(toks), jc)
        tl = model.decode_step(params, torch.from_numpy(toks).long(), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-4)
        _rows_close(tc["layers"], _port_cache(jc)["layers"], kvq)
    assert tc["lens"].tolist() == [20]


def test_the_window_is_a_ring_and_never_paged():
    jm, jp, model, params = _pair()
    assert model.window_for(MAX_LEN) == jm.window_for(MAX_LEN) == WINDOW
    assert model.paging_effective(MAX_LEN, 8) == 0
    assert jm.paging_effective(MAX_LEN, 8) == 0
    eng = ServingEngine(model, params, slots=2, max_len=MAX_LEN, page_size=8)
    assert not eng.paged and eng.max_pages == 0 and eng._cache_seq == WINDOW
    assert Model.cache_len(eng.cache) == WINDOW
    # a dense config past max_full_attn falls back to window_long_ctx
    long = Model(reduced(get_config("llama3.2-1b"), max_full_attn=32,
                         window_long_ctx=8), device="cpu")
    assert (long.window_for(32), long.window_for(33)) == (0, 8)
    assert Model.cache_len(long.init_cache(1, 64)) == 8


@pytest.mark.parametrize("admission", ["chunked", "stall"])
def test_engine_streams_equal_jax(admission):
    """Prompts of 5, 20, 13 and 30 tokens (20 and 30 past the ring: under
    stall admission exact-length buckets through the ring write) with 12
    new tokens each, every stream crossing the ring's edge."""
    jm, jp, model, params = _pair()
    outs = []
    for eng, req_cls in (
            (JEngine(jm, jp, slots=2, max_len=MAX_LEN, megastep_k=4,
                     admission=admission), JRequest),
            (ServingEngine(model, params, slots=2, max_len=MAX_LEN,
                           megastep_k=4, admission=admission), Request)):
        reqs = [req_cls(uid=i, prompt=_prompt(n, seed=10 + i),
                        max_new_tokens=12)
                for i, n in enumerate((5, 20, 13, 30))]
        for r in reqs:
            eng.submit(r)
        eng.run()
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]
    assert all(len(o) == 12 for o in outs[1])
    if admission == "stall":
        assert outs[1][1] == model.reference_decode(
            params, _prompt(20, seed=11), 12, max_len=MAX_LEN,
            stepwise_prefill=False)


def test_fused_reference_decode_past_max_len_matches_jax():
    """Without a window, a fused prompt of 40 tokens into a 32-position
    cache takes the ring write too (the resumed request's case), and
    ``reference_decode`` gives the JAX stream."""
    jm, jp, model, params = _pair(window=0)
    prompt = _prompt(40, seed=6)
    want = jm.reference_decode(jp, prompt, 8, max_len=32,
                               stepwise_prefill=False)
    assert model.reference_decode(params, prompt, 8, max_len=32,
                                  stepwise_prefill=False) == want


# (engine kind, engine arguments): a dense full-attention cache, a paged
# one whose pool takes the request, a paged one whose pool cannot, and
# the windowed ring; each gets a 40-token prompt on a 32-position cache
KINDS = {"dense": dict(), "paged": dict(page_size=8),
         "paged-short": dict(page_size=8, cache_blocks=4),
         "windowed": dict()}


@pytest.mark.parametrize("admission", ["chunked", "stall"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_prompt_too_long_where_jax_rejects(kind, admission):
    jm, jp, model, params = _pair(window=WINDOW if kind == "windowed" else 0)
    kw = dict(KINDS[kind], slots=2, max_len=32, admission=admission)
    raised = []
    for eng, req_cls in ((JEngine(jm, jp, **kw), JRequest),
                         (ServingEngine(model, params, **kw), Request)):
        try:
            eng.submit(req_cls(uid=0, prompt=_prompt(40), max_new_tokens=4))
        except Exception as e:         # the JAX engine's own PromptTooLong
            assert type(e).__name__ == "PromptTooLong"
            raised.append(True)
        else:
            raised.append(False)
    assert raised[0] == raised[1] == (kind in ("dense", "paged-short"))
    if raised[1]:
        with pytest.raises(PromptTooLong):
            ServingEngine(model, params, **kw).submit(
                Request(uid=1, prompt=_prompt(40), max_new_tokens=4))
