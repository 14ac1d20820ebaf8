"""The paper's six models (its Fig. 4) in the port against the JAX package
on the CPU: the copied configs field by field, and a reduced variant of
each new model that keeps what its family adds, with the JAX parameters
carried over by ``repro_torch.bridge``:

- qwen2-0.5b and qwen2-1.5b: the QKV bias, set to seeded random values
  (``Model.init`` draws zeros, which would test nothing);
- llama3.1-8b ("llama3.2-8b"): the untied ``lm_head``, quantized to q8_0
  with every other weight;
- mistral-7b: the sliding window (16 positions, so a 23-token prompt
  takes the ring branch);
- each at the real (head_dim, query heads per kv head) pair the full
  model's kernels instantiate: (64, 7), (128, 6), (128, 3) and (128, 4).

Tolerances: f32 params, logits within 1e-4 absolute and greedy streams
equal (as in test_torch_model.py and test_torch_prefill.py); bf16 params
(qwen2's bias add in bf16), logits within 2.5% of their largest
magnitude, for the silu reason those files give.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import functools

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
from repro_torch.configs import CONFIGS, PAPER_MODELS, get_config, reduced
from repro_torch.launch import serve
from repro_torch.models import Model
from repro_torch.quant import QuantizedTensor

# the reduced variant of each new model: its family's features at the
# full model's (head_dim, G), d_model 128, 2 layers, vocabulary 512
VARIANTS = {
    "qwen2-0.5b": dict(num_heads=14, num_kv_heads=2, head_dim=64),
    "qwen2-1.5b": dict(num_heads=6, num_kv_heads=1, head_dim=128),
    "llama3.2-3b": dict(num_heads=3, num_kv_heads=1, head_dim=128),
    "llama3.2-8b": dict(num_heads=4, num_kv_heads=1, head_dim=128),
    "mistral-7b-v0.1": dict(num_heads=4, num_kv_heads=1, head_dim=128,
                            sliding_window=16),
}
WEIGHTS = {"llama3.2-8b": "q8_0"}
MAX_LEN = 32
PROMPT = np.random.default_rng(21).integers(1, 512, 23).astype(np.int32)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_configs_equal_jax_field_by_field(name):
    cfg, jcfg = get_config(name), jget(name)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    red, jred = reduced(cfg), jreduced(jcfg)
    for f in dataclasses.fields(red):
        assert getattr(red, f.name) == getattr(jred, f.name), f.name


def test_the_paper_models_under_their_jax_names():
    assert sorted(PAPER_MODELS) == sorted(
        ["qwen2-0.5b", "qwen2-1.5b", "llama3.2-1b", "llama3.2-3b",
         "llama3.2-8b", "mistral-7b-v0.1"])
    assert set(PAPER_MODELS) <= set(CONFIGS)
    assert get_config("llama3.2-1b").max_seq_len == 131072
    # the parity values where the JAX configs leave the published ones
    assert get_config("qwen2-0.5b").rope_theta == 10000.0
    assert {c.norm_eps for c in PAPER_MODELS.values()} == {1e-6}


@functools.lru_cache(maxsize=None)
def _pair(name, param_dtype="f32"):
    """(JAX model, JAX params, port model, port params) of the reduced
    variant, with the JAX ``wqkv.b`` drawn at random under qkv_bias."""
    over = dict(VARIANTS[name], param_dtype=param_dtype)
    jm = JModel(jreduced(jget(name), **over))
    jp = jm.init(jax.random.PRNGKey(0), quantize=False)
    if jm.cfg.qkv_bias:
        b = jp["layers"]["attn"]["wqkv"]["b"]
        rng = np.random.default_rng(7)
        jp["layers"]["attn"]["wqkv"]["b"] = jnp.asarray(
            0.5 * rng.standard_normal(b.shape), b.dtype)
    if name in WEIGHTS:
        jp = jquantize_tree(jp, WEIGHTS[name])
    model = Model(reduced(get_config(name), **over), device="cpu")
    params = from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jm, jp, model, params


@functools.lru_cache(maxsize=None)
def _jits(name, param_dtype="f32"):
    jm = _pair(name, param_dtype)[0]
    return jax.jit(jm.prefill), jax.jit(jm.decode_step)


def _features(name, model, params):
    """What the variant carries: the bias leaf, the untied quantized
    head, the window, the real (head_dim, G)."""
    cfg = model.cfg
    b = params["layers"][0]["attn"]["wqkv"].get("b")
    assert (b is not None) == cfg.qkv_bias
    if b is not None:
        assert b.shape == (cfg.q_dim + 2 * cfg.kv_dim,) and bool(b.any())
    assert ("lm_head" in params) == (not cfg.tie_embeddings)
    if name in WEIGHTS:
        assert isinstance(params["lm_head"], QuantizedTensor)
    assert (model.window_for(MAX_LEN) == 16) == (name == "mistral-7b-v0.1")
    full = get_config(name)
    assert (cfg.head_dim, cfg.num_heads // cfg.num_kv_heads) == (
        full.head_dim, full.num_heads // full.num_kv_heads)


def _port_cache(jc):
    return from_jax(jax.tree_util.tree_map(np.asarray, jc), device="cpu")


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_prefill_and_decode_logits_match_jax(name):
    """A 23-token prefill (the ring branch for mistral's 16-position
    window): its logits, ``lens`` and the cache rows, within a bf16
    rounding step (f32 K/V rounded into the bf16 cache: an element at a
    rounding boundary may land one step apart, as test_torch_prefill.py
    allows). Then three decode steps, each from the JAX cache carried
    over, so that such a step does not carry into the logits."""
    jm, jp, model, params = _pair(name)
    _features(name, model, params)
    pre, dec = _jits(name)
    jc = jm.init_cache(1, MAX_LEN)
    tc = model.init_cache(1, MAX_LEN)
    jl, jc = pre(jp, {"tokens": jnp.asarray(PROMPT[None])}, jc)
    tl = model.prefill(params, torch.from_numpy(PROMPT[None]).long(), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-4)
    want = _port_cache(jc)
    assert tc["lens"].tolist() == want["lens"].tolist() == [len(PROMPT)]
    for t_l, w_l in zip(tc["layers"], want["layers"]):
        for n in ("k", "v"):
            torch.testing.assert_close(t_l[n].float(), w_l[n].float(),
                                       rtol=0, atol=0.02)
    for tok in (5, 311, 97):
        toks = np.array([[tok]], np.int32)
        tc = _port_cache(jc)
        jl, jc = dec(jp, jnp.asarray(toks), jc)
        tl = model.decode_step(params, torch.from_numpy(toks).long(), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-4)
    assert tc["lens"].tolist() == [len(PROMPT) + 3]


@pytest.mark.parametrize("stepwise", [True, False])
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_reference_decode_matches_jax(name, stepwise):
    jm, jp, model, params = _pair(name)
    want = jm.reference_decode(jp, PROMPT[:9], 10, max_len=MAX_LEN,
                               stepwise_prefill=stepwise)
    got = model.reference_decode(params, PROMPT[:9], 10, max_len=MAX_LEN,
                                 stepwise_prefill=stepwise)
    assert got == want


def test_qwen2_bias_under_bf16_params_matches_jax():
    """The bias add in bf16 (rounded once, before RoPE), prefill and a
    decode step, against the JAX ``layers.linear``'s add."""
    jm, jp, model, params = _pair("qwen2-0.5b", "bf16")
    pre, dec = _jits("qwen2-0.5b", "bf16")
    jc = jm.init_cache(1, MAX_LEN)
    tc = model.init_cache(1, MAX_LEN)
    jl, jc = pre(jp, {"tokens": jnp.asarray(PROMPT[None, :12])}, jc)
    tl = model.prefill(params, torch.from_numpy(PROMPT[None, :12]).long(),
                       tc)
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0,
                               atol=0.025 * np.abs(jl).max())
    jl, _ = dec(jp, jnp.asarray([[7]], jnp.int32), jc)
    tl = model.decode_step(params, torch.tensor([[7]]), tc)
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0,
                               atol=0.025 * np.abs(jl).max())


def test_init_draws_the_bias_and_the_untied_head():
    """The port's own ``Model.init``: qwen2's ``wqkv`` gets a zero bias
    that stays bf16 under quantization; the 8B model an ``lm_head`` that
    is quantized with the linears."""
    g = torch.Generator().manual_seed(0)
    qwen = Model(dataclasses.replace(reduced(get_config("qwen2-0.5b")),
                                     quant_policy="q8_0"), device="cpu")
    p = qwen.init(g)
    b = p["layers"][0]["attn"]["wqkv"]["b"]
    assert b.dtype == torch.bfloat16 and not bool(b.any())
    assert isinstance(p["layers"][0]["attn"]["wqkv"]["w"], QuantizedTensor)
    assert "lm_head" not in p
    big = Model(dataclasses.replace(reduced(get_config("llama3.2-8b")),
                                    quant_policy="q4_0"), device="cpu")
    p = big.init(g)
    assert isinstance(p["lm_head"], QuantizedTensor)
    assert "b" not in p["layers"][0]["attn"]["wqkv"]


@pytest.mark.parametrize("name", sorted(PAPER_MODELS))
def test_serve_cli_runs_each_paper_model_reduced_on_cpu(name, capsys):
    res = serve.main(["--arch", name, "--device", "cpu", "--requests", "3",
                      "--max-new", "4", "--temperature", "0",
                      "--max-len", "64"])
    assert f"arch={name}-smoke" in capsys.readouterr().out
    eng = res.engine
    for r in res.requests:
        assert r.done and r.output == eng.model.reference_decode(
            eng.params, r.prompt, 4, max_len=64)
