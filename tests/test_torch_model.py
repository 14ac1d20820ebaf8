"""The port's dense model against the JAX package's ``Model`` on reduced
llama3.2-1b and deepseek-7b, with the JAX parameters (and, where a test
starts mid-sequence, the JAX cache) carried over by
``repro_torch.bridge``.

Tolerances:
- bf16 params: logits within 2.5% of their largest magnitude. The
  numerics differ by a bf16 rounding step here and there: XLA's bf16
  ``logistic`` (inside ``silu``) rounds differently from PyTorch's,
  which computes in f32 and rounds once (a third of the SwiGLU elements
  differ by one ulp); measured worst case 1.1% over these configs.
- f32 params: 1e-4 absolute, and greedy streams are equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models import Model as JModel
from repro.quant.quantize import quantize_tree as jquantize_tree
from repro_torch.bridge import from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.models import Model
from repro_torch.models.attention import kv_cache_read

ARCHS = ["llama3.2-1b", "deepseek-7b"]


def _pair(arch, wq="bf16", kvq="bf16", param_dtype="bf16"):
    jcfg = dataclasses.replace(jreduced(jget(arch)), kv_quant=kvq,
                               param_dtype=param_dtype)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0), quantize=False)
    if wq != "bf16":
        jp = jquantize_tree(jp, wq)
    cfg = dataclasses.replace(reduced(get_config(arch)), kv_quant=kvq,
                              param_dtype=param_dtype)
    model = Model(cfg, device="cpu")
    params = from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jm, jp, model, params


def _steps(jm, jp, model, params, n_steps, *, seed=0, batch=2,
           max_len=32, freeze=True):
    """Feed the same tokens through both decode steps; yields the two
    logits and the advance mask per step."""
    dec = jax.jit(jm.decode_step)
    jc = jm.init_cache(batch, max_len)
    tc = model.init_cache(batch, max_len)
    rng = np.random.default_rng(seed)
    for step in range(n_steps):
        toks = rng.integers(1, model.cfg.vocab_size,
                            size=(batch, 1)).astype(np.int32)
        adv = np.ones((batch,), bool)
        if freeze:
            adv[-1] = step % 2 == 0         # the last row freezes now and then
        jl, jc = dec(jp, jnp.asarray(toks), jc, jnp.asarray(adv))
        tl = model.decode_step(params, torch.from_numpy(toks).long(), tc,
                               torch.from_numpy(adv))
        yield np.asarray(jl), tl.numpy(), adv, jc, tc


@pytest.mark.parametrize("kvq", ["bf16", "q8_0"])
@pytest.mark.parametrize("wq", ["bf16", "q8_0", "q4_0"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_logits_match_jax(arch, wq, kvq):
    jm, jp, model, params = _pair(arch, wq, kvq)
    for jl, tl, adv, _, _ in _steps(jm, jp, model, params, 4):
        assert tl.shape == jl.shape == (2, model.cfg.vocab_size)
        assert tl.dtype == np.float32
        # frozen rows' logits are junk on both sides (never emitted)
        scale = np.abs(jl[adv]).max()
        np.testing.assert_allclose(tl[adv], jl[adv], rtol=0,
                                   atol=0.025 * scale)


@pytest.mark.parametrize("kvq", ["bf16", "q8_0", "q4_0"])
def test_decode_step_f32_params_match_jax_and_freeze_rows(kvq):
    """Tight parity with f32 params; the frozen row's cache and lens
    stay as they were (no write), equal to the JAX cache after its
    write-then-select freeze; a wrapping ring (max_len 8, 10 steps)."""
    jm, jp, model, params = _pair("llama3.2-1b", "q8_0", kvq, "f32")
    for jl, tl, adv, jc, tc in _steps(jm, jp, model, params, 10,
                                      max_len=8):
        np.testing.assert_allclose(tl[adv], jl[adv], rtol=0, atol=1e-4)
    jlens = np.asarray(jc["layers"]["lens"])
    assert (jlens == tc["lens"].numpy()[None]).all()
    assert tc["lens"].tolist() == [10, 5]
    for i, layer in enumerate(tc["layers"]):
        jk = np.asarray(kv_cache_read_jax(jc, i, kvq))
        tk, _ = kv_cache_read(layer, kv_quant=kvq)
        # bf16 rows are equal to a rounding step; quantized rows to one
        # quantization step on .5 ties
        np.testing.assert_allclose(tk.float().numpy(), jk, rtol=0,
                                   atol=0.02 + 0.15 * (kvq != "bf16"))


def kv_cache_read_jax(jc, layer, kvq):
    from repro.models.attention import kv_cache_read as jread
    leaves = {k: v[layer] for k, v in jc["layers"].items()}
    return jnp.asarray(jread(leaves, kv_quant=kvq)[0], jnp.float32)


@pytest.mark.parametrize("kvq", ["bf16", "q8_0"])
def test_decode_continues_from_bridged_jax_cache(kvq):
    """JAX prefills a prompt (a path not yet in the port), the cache is
    carried over, and both sides decode on from it."""
    jm, jp, model, params = _pair("deepseek-7b", "q8_0", kvq, "f32")
    prompt = np.random.default_rng(3).integers(1, 512, (2, 7)).astype(
        np.int32)
    jc = jm.init_cache(2, 16)
    _, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(prompt)}, jc)
    tc = from_jax(jax.tree_util.tree_map(np.asarray, jc), device="cpu")
    assert tc["lens"].tolist() == [7, 7]
    toks = np.array([[11], [23]], np.int32)
    jl, _ = jax.jit(jm.decode_step)(jp, jnp.asarray(toks), jc)
    tl = model.decode_step(params, torch.from_numpy(toks).long(), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("arch,wq,kvq", [("llama3.2-1b", "q8_0", "bf16"),
                                         ("deepseek-7b", "q4_0", "q8_0")])
def test_reference_decode_greedy_equals_jax(arch, wq, kvq):
    jm, jp, model, params = _pair(arch, wq, kvq, "f32")
    prompt = [3, 17, 101, 9, 44]
    want = jm.reference_decode(jp, prompt, 12, max_len=32)
    assert model.reference_decode(params, prompt, 12, max_len=32) == want
    eos = want[4]
    assert model.reference_decode(params, prompt, 12, eos_id=eos,
                                  max_len=32) == want[:want.index(eos) + 1]
    assert model.reference_decode(params, prompt, 0) == []


def test_init_is_seeded_with_the_jax_std_rules():
    cfg = reduced(get_config("deepseek-7b"))
    model = Model(cfg, device="cpu")
    p1 = model.init(torch.Generator().manual_seed(0))
    p2 = model.init(torch.Generator().manual_seed(0))
    assert torch.equal(p1["layers"][1]["mlp"]["w_down"]["w"],
                       p2["layers"][1]["mlp"]["w_down"]["w"])
    assert p1["embedding"].shape == (cfg.padded_vocab, cfg.d_model)
    assert p1["lm_head"].shape == (cfg.d_model, cfg.padded_vocab)
    assert len(p1["layers"]) == cfg.num_layers
    std = lambda w: float(w.float().std())
    assert abs(std(p1["embedding"]) * cfg.d_model ** 0.5 - 1) < 0.05
    w_down = p1["layers"][0]["mlp"]["w_down"]["w"]        # (d_ff, d_model)
    assert abs(std(w_down) * cfg.d_ff ** 0.5 - 1) < 0.05
    assert torch.equal(p1["final_norm"], torch.ones(cfg.d_model,
                                                    dtype=torch.bfloat16))
    q = Model(dataclasses.replace(cfg, quant_policy="q4_0"),
              device="cpu").init(torch.Generator().manual_seed(0))
    assert q["layers"][0]["attn"]["wqkv"]["w"].fmt == "q4_0"
    assert q["embedding"].dtype == torch.bfloat16


@pytest.mark.parametrize("cfg_kvq,cache_kvq", [("bf16", "q8_0"),
                                               ("q4_0", "bf16")])
def test_decode_step_rejects_a_cache_of_another_format(cfg_kvq, cache_kvq):
    """The cache format is the config's: a cache built under another
    ``kv_quant`` raises instead of being misread."""
    base = dataclasses.replace(reduced(get_config("llama3.2-1b")),
                               num_layers=1)
    model = Model(dataclasses.replace(base, kv_quant=cfg_kvq), device="cpu")
    other = Model(dataclasses.replace(base, kv_quant=cache_kvq),
                  device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    cache = other.init_cache(2, 8)
    with pytest.raises(ValueError, match="cache"):
        model.decode_step(params, torch.ones((2, 1), dtype=torch.long),
                          cache)
    assert model.init_cache(2, 8)["layers"][0].keys() == (
        {"k", "v"} if cfg_kvq == "bf16"
        else {"k", "v", "k_scale", "v_scale"})
