"""The RG-LRU hybrid family (recurrentgemma-2b) in the port against the JAX
package on the CPU: the reduced config (3 layers, one rglru-rglru-attn
pattern, d_model 128, 4 query heads over 1 KV head of 32, window 64) with
the JAX parameters carried over by ``repro_torch.bridge``, and the RG-LRU
biases, ``a_param`` and ``conv_b`` drawn at random (their inits are
constants) so that every term of the gates and the recurrence moves.

- the config field by field, and its reduced variant; the layer pattern;
- ``gelu`` and the GeGLU MLP (fused and V0, f32 and bf16 params, bf16 and
  q8_0 weights) against the JAX ``layers.gelu`` and ``mlp_forward``;
- the recurrence from zeros against the JAX ``rglru_scan`` and the
  oracle ``ref.rglru_ref``; the scan and decode kernels' plain versions
  against the JAX layer's arithmetic;
- ``rglru_forward`` and ``rglru_decode`` layer by layer, frozen rows;
- ``Model.prefill`` + ``decode_step`` against the JAX ``Model`` under f32
  and bf16 params and bf16 / q8_0 / q4_0 weights, and two 6-layer
  patterns; ``from_jax`` of the JAX hybrid's params and cache (a list of
  layers, a ``lens`` in each);
- the leaves that quantize; ``reference_decode`` under both prefill modes
  against the JAX one;
- the engine's greedy streams against the JAX engine's under chunked and
  stall admission, with a prompt past the window; a resume after
  preemption; ``kv_quant``, paging and the prefix cache as no-ops; the
  decode step's launches a layer; the serve CLI and its floor.

Tolerances: f32 params, within 1e-5 of the largest magnitude (measured:
at most 2e-6; the port sums the recurrence sequentially, the JAX prefill
by an associative scan), and the model's decode logits within 1e-4
(measured 2.2e-5: the attention layers' rings are bf16 on both sides, and
a K or V element a few f32 ulps apart can round to neighbouring bf16
values); the RG-LRU layer under bf16 within one bf16 step
of its scale (sigmoid, exp and the scan's order differ in f32 bits before
a bf16 rounding); bf16 params, the model's logits within 5% of their
largest magnitude (measured 1.9%: a few bf16 steps of the states move
through three layers). Greedy streams exactly, under f32 params.
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
from repro.kernels.ref import rglru_ref
from repro.models import Model as JModel
from repro.models import hybrid as jhy
from repro.models import layers as jlayers
from repro.models import mlp as jmlp
from repro.quant.quantize import QuantizedTensor as JQuantizedTensor
from repro.quant.quantize import quantize_tree as jquantize_tree
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch.bridge import from_jax
from repro_torch.configs import HYBRID_MODELS, get_config, reduced
from repro_torch.kernels import ops
from repro_torch.kernels import rglru as krg
from repro_torch.launch import serve
from repro_torch.models import Model
from repro_torch.models import hybrid as thy
from repro_torch.models import layers as tlayers
from repro_torch.models import mlp as tmlp
from repro_torch.quant import QuantizedTensor
from repro_torch.serving import Request, ServingEngine

ARCH = "recurrentgemma-2b"
MAX_LEN = 64
F32_TOL = 1e-5
F32_RING_TOL = 1e-4      # decode logits over the bf16 rings, f32 params
BF16_LOGIT_TOL = 0.05
BF16_STEP = 2.0 ** -7    # one bf16 step at the output's scale


def _t(a):
    return torch.as_tensor(np.array(a))


def _err(t, j):
    j = np.asarray(jnp.asarray(j, jnp.float32))
    return float(np.abs(t.float().numpy() - j).max() / np.abs(j).max())


def _f32_states(jm):
    """The JAX model with f32 params, its RG-LRU conv state allocated in
    f32 (the JAX ``init_rglru_cache`` makes it bf16, which its decode then
    replaces with an f32 array, and its megastep's scan refuses; the port
    allocates the activation dtype) and its rings bf16, as the port's."""
    orig = jm.init_cache

    def init_cache(*a, **kw):
        c = orig(*a, **kw)
        return dict(c, layers=[dict(l, conv=l["conv"].astype(jnp.float32))
                               if "conv" in l else l for l in c["layers"]])
    jm.init_cache = init_cache
    return jm


@functools.lru_cache(maxsize=None)
def _pair(param_dtype="f32", weights="bf16", pattern=None, layers=3,
          version="v2"):
    """(JAX model, JAX params, port model, port params), the same weights
    on both sides (quantized by the JAX package under q8_0 / q4_0)."""
    over = dict(param_dtype=param_dtype, num_layers=layers,
                scheduler_version=version)
    if pattern:
        over["hybrid_pattern"] = pattern
    jm = JModel(dataclasses.replace(jreduced(jget(ARCH)), **over,
                                    dtype=param_dtype))
    jp = jm.init(jax.random.PRNGKey(0), quantize=False)
    rng = np.random.default_rng(3)
    for p_l in jp["layers"]:
        if "rglru" not in p_l:
            continue
        rg = p_l["rglru"]
        for path, scale in ((("wa", "b"), 0.5), (("wx", "b"), 0.5),
                            (("conv_b",), 0.2)):
            node = rg
            for k in path[:-1]:
                node = node[k]
            node[path[-1]] = jnp.asarray(
                scale * rng.standard_normal(node[path[-1]].shape),
                node[path[-1]].dtype)
        rg["a_param"] = jnp.asarray(
            4.0 + rng.standard_normal(rg["a_param"].shape),
            rg["a_param"].dtype)
    if weights != "bf16":
        jp = jquantize_tree(jp, weights)
    if param_dtype == "f32":
        jm = _f32_states(jm)
    model = Model(dataclasses.replace(reduced(get_config(ARCH)), **over),
                  device="cpu")
    params = from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jm, jp, model, params


def _layer(param_dtype="f32"):
    """Layer 0's RG-LRU params on both sides, and the configs."""
    jm, jp, model, params = _pair(param_dtype)
    return jm.cfg, jp["layers"][0]["rglru"], model.cfg, \
        params["layers"][0]["rglru"]


# -- configs ------------------------------------------------------------------
def test_config_and_reduced_equal_jax_field_by_field():
    assert sorted(HYBRID_MODELS) == [ARCH]
    cfg, jcfg = get_config(ARCH), jget(ARCH)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    red, jred = reduced(cfg), jreduced(jcfg)
    for f in dataclasses.fields(red):
        assert getattr(red, f.name) == getattr(jred, f.name), f.name
    assert cfg.layer_pattern() == jcfg.layer_pattern()
    assert cfg.layer_pattern().count("attn") == 8 and cfg.lru_width == 2560
    assert red.layer_pattern() == ("rglru", "rglru", "attn")
    assert (red.lru_width, red.local_attn_window, red.head_dim) == (128, 64,
                                                                    32)
    assert cfg.is_recurrent and cfg.activation == "gelu"
    assert get_config("mamba2-2.7b").layer_pattern() == ("ssm",) * 64


# -- gelu and the GeGLU MLP ---------------------------------------------------
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gelu_matches_jax(dtype):
    """The logistic gelu, f32 within 1e-6 of its scale; bf16 within one
    bf16 step (the sigmoid's exp differs in its last f32 bits)."""
    rng = np.random.default_rng(1)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    x = jnp.asarray(np.concatenate([rng.standard_normal(4000) * 3,
                                    [-30.0, -9.0, 0.0, 9.0, 30.0]]), jdt)
    tx = _t(x.astype(jnp.float32)).to(torch.float32 if dtype == "f32"
                                      else torch.bfloat16)
    got = tlayers.gelu(tx)
    assert got.dtype == tx.dtype
    assert _err(got, jlayers.gelu(x)) <= (1e-6 if dtype == "f32"
                                          else BF16_STEP)


@pytest.mark.parametrize("version", ["v2", "v0"])
@pytest.mark.parametrize("dtype,weights", [("f32", "bf16"), ("bf16", "bf16"),
                                           ("bf16", "q8_0")])
def test_geglu_mlp_matches_jax(dtype, weights, version):
    """mlp_forward (the fused gate-up and the standalone GeGLU, or under
    q8_0 the gate-up GEMM with its GeGLU; V0: w_gate and w_up apart) of
    layer 0 against the JAX ``mlp_forward``."""
    jm, jp, model, params = _pair(dtype, weights, version=version)
    rng = np.random.default_rng(2)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    x = jnp.asarray(rng.standard_normal((2, 5, model.cfg.d_model)), jdt)
    want = jmlp.mlp_forward(jp["layers"][0]["mlp"], jm.cfg, x)
    got = tmlp.mlp_forward(params["layers"][0]["mlp"],
                           _t(x.astype(jnp.float32)).to(model.dtype),
                           "gelu")
    assert _err(got, want) <= (F32_TOL if dtype == "f32" else 2 * BF16_STEP)
    gu = torch.randn(3, 2 * 8)
    assert torch.equal(ops.geglu(gu), tlayers.gelu(gu[:, :8]) * gu[:, 8:])
    if weights == "q8_0" and version == "v2":
        w = params["layers"][0]["mlp"]["w_gate_up"]["w"]
        xt = _t(x.astype(jnp.float32)).bfloat16().reshape(-1, x.shape[-1])
        assert torch.equal(ops.quant_matmul_swiglu(xt, w, act="gelu"),
                           ops.geglu(ops.quant_matmul(xt, w)))


# -- the recurrence -----------------------------------------------------------
@pytest.mark.parametrize("S", [1, 48])
def test_rglru_scan_matches_jax_and_the_oracle(S):
    """The plain versions' sequential scan (``linear_scan``, from zeros)
    against the JAX associative scan and the oracle's step loop, within
    1e-5."""
    rng = np.random.default_rng(4)
    B, W = 2, 16
    x = jnp.asarray(rng.standard_normal((B, S, W)), jnp.float32)
    a = jax.nn.sigmoid(jnp.asarray(rng.standard_normal((B, S, W)) + 2,
                                   jnp.float32))
    g = jax.nn.sigmoid(jnp.asarray(rng.standard_normal((B, S, W)),
                                   jnp.float32))
    want = jhy.rglru_scan(x * g, a)
    got = krg.linear_scan(_t(a), _t(x * g))
    assert _err(got, want) <= F32_TOL
    y_ref, h_ref = rglru_ref(x, a, g)
    assert _err(got, y_ref) <= F32_TOL
    assert _err(got[:, -1], h_ref) <= F32_TOL


def _jax_layer_inputs(jl, B, S, dtype, seed):
    """The JAX layer's conv output, [x wa | x wx] row and gate for random
    layer inputs, and their port tensors."""
    rng = np.random.default_rng(seed)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    W = jl["a_param"].shape[0]
    xb = jnp.asarray(rng.standard_normal((B, S, W)), jdt)
    gate = jnp.asarray(rng.standard_normal((B, S, W)), jdt)
    gx = jnp.concatenate([jlayers.linear({"w": jl["wa"]["w"]}, xb),
                          jlayers.linear({"w": jl["wx"]["w"]}, xb)], -1)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    port = [_t(v.astype(jnp.float32)).to(tdt) for v in (xb, gx, gate)]
    return (xb, gate), port


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("S", [1, 21])
def test_scan_kernel_plain_version_matches_the_jax_layer(S, dtype):
    """``rglru_scan_plain``'s y against the JAX layer's arithmetic (its
    ``_gates``, ``rglru_scan`` from zeros and the gelu-gated output); the
    state it stores, whatever the row held, is the last y (as the JAX
    ``rglru_forward`` returns it)."""
    jcfg, jl, cfg, tl = _layer(dtype)
    (xb, gate), (x, gx, tgate) = _jax_layer_inputs(jl, 2, S, dtype, 5)
    a, i = jhy._gates(jl, xb)
    h = jhy.rglru_scan(xb.astype(jnp.float32) * i.astype(jnp.float32), a)
    want = (h * jlayers.gelu(gate.astype(jnp.float32))).astype(xb.dtype)
    state = torch.full((2, x.shape[-1]), 7.0)
    y = krg.rglru_scan_plain(x, gx, tgate, tl["wa"]["b"], tl["wx"]["b"],
                             tl["a_param"], state)
    tol = F32_TOL if dtype == "f32" else BF16_STEP
    assert _err(y, want) <= tol
    assert torch.equal(state, y[:, -1].float())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rglru_decode_matches_jax_with_frozen_rows(dtype):
    """``rglru_decode`` (the conv, the gate products and the decode step)
    against the JAX ``rglru_decode`` + ``_freeze_rows``: output and both
    states; a frozen row's states untouched."""
    jcfg, jl, cfg, tl = _layer(dtype)
    rng = np.random.default_rng(7)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    B, W, D = 3, cfg.lru_width, cfg.d_model
    x = jnp.asarray(rng.standard_normal((B, 1, D)), jdt)
    conv = jnp.asarray(rng.standard_normal((B, 3, W)), jdt)
    state = jnp.asarray(rng.standard_normal((B, W)), jnp.float32)
    jout, jc = jhy.rglru_decode(jl, jcfg, x, {"conv": conv, "state": state,
                                              "lens": jnp.zeros(B, jnp.int32)})
    cache = {"conv": _t(conv.astype(jnp.float32)).to(tdt),
             "state": _t(state)}
    adv = torch.tensor([True, False, True])
    out = thy.rglru_decode(tl, cfg, _t(x.astype(jnp.float32)).to(tdt), cache,
                           adv)
    tol = F32_TOL if dtype == "f32" else BF16_STEP
    assert _err(out[adv], np.asarray(jout.astype(jnp.float32))[[0, 2]]) <= \
        2 * tol
    for k in ("conv", "state"):
        want = np.asarray(jc[k].astype(jnp.float32))
        assert _err(cache[k][adv], want[[0, 2]]) <= tol
    assert torch.equal(cache["state"][1], _t(state)[1])
    assert torch.equal(cache["conv"][1].float(),
                       _t(conv.astype(jnp.float32))[1])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rglru_forward_matches_jax(dtype):
    """A whole prompt's layer from zero states against the JAX
    ``rglru_forward(return_state=True)``: output, conv state, and the
    state it stores (the last position's gated output)."""
    jcfg, jl, cfg, tl = _layer(dtype)
    rng = np.random.default_rng(8)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    x = jnp.asarray(rng.standard_normal((2, 19, cfg.d_model)), jdt)
    jout, jc = jhy.rglru_forward(jl, jcfg, x, return_state=True)
    cache = thy.init_rglru_cache(cfg, 2, tdt, "cpu")
    out = thy.rglru_forward(tl, cfg, _t(x.astype(jnp.float32)).to(tdt),
                            cache)
    tol = F32_TOL if dtype == "f32" else 2 * BF16_STEP
    assert _err(out, jout) <= tol
    assert _err(cache["conv"], jc["conv"]) <= tol
    assert _err(cache["state"], jc["state"]) <= tol


# -- the model ----------------------------------------------------------------
@pytest.mark.parametrize("param_dtype,weights", [
    ("f32", "bf16"), ("bf16", "bf16"), ("bf16", "q8_0"), ("bf16", "q4_0")])
def test_model_prefill_and_decode_match_jax(param_dtype, weights):
    """A 2 x 37 prefill, then three decode steps (row 1 frozen in the
    second), the advancing rows' logits; the JAX cache carried over by
    from_jax (a list of layers with a lens each) gives the port's layout
    and one lens, and its RG-LRU states and rings match the port's."""
    jm, jp, model, params = _pair(param_dtype, weights)
    tol = F32_TOL if param_dtype == "f32" else BF16_LOGIT_TOL
    step_tol = F32_RING_TOL if param_dtype == "f32" else BF16_LOGIT_TOL
    rng = np.random.default_rng(6)
    toks = rng.integers(1, 512, (2, 37)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                        jm.init_cache(2, MAX_LEN))
    tc = model.init_cache(2, MAX_LEN)
    tl = model.prefill(params, torch.from_numpy(toks).long(), tc)
    assert _err(tl, jl) <= tol
    bridged = from_jax(jax.tree_util.tree_map(np.asarray, jc), device="cpu")
    assert bridged["lens"].tolist() == tc["lens"].tolist() == [37, 37]
    for a, b, kind in zip(bridged["layers"], tc["layers"], model.kinds):
        assert a.keys() == b.keys() == ({"conv", "state"} if kind == "rglru"
                                        else {"k", "v"})
        for k in a:
            assert _err(b[k], a[k].float().numpy()) <= max(tol, 2 * BF16_STEP)
    for step in range(3):
        t = rng.integers(1, 512, (2, 1)).astype(np.int32)
        mask = np.array([True, step != 1])
        jl, jc = jm.decode_step(jp, jnp.asarray(t), jc,
                                advance_mask=jnp.asarray(mask))
        tl = model.decode_step(params, torch.from_numpy(t).long(), tc,
                               advance_mask=torch.from_numpy(mask))
        # a frozen row's logits are junk nobody emits: the JAX decode
        # writes its token into the ring and restores the ring after, the
        # port leaves the ring alone
        assert _err(tl[torch.from_numpy(mask)],
                    np.asarray(jl)[mask]) <= step_tol
    assert tc["lens"].tolist() == [40, 39]


@pytest.mark.parametrize("pattern", [("rglru", "rglru", "attn"),
                                     ("attn", "rglru")])
def test_six_layer_patterns_match_jax(pattern):
    """Six layers of two patterns (f32 params): a 2 x 70 prefill past the
    64-position ring (the ring write), and two decode steps across the
    ring's edge."""
    jm, jp, model, params = _pair("f32", pattern=pattern, layers=6)
    assert model.kinds == jm.cfg.layer_pattern()
    rng = np.random.default_rng(9)
    toks = rng.integers(1, 512, (2, 70)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                        jm.init_cache(2, MAX_LEN))
    tc = model.init_cache(2, MAX_LEN)
    assert Model.cache_len(tc) == 64
    assert _err(model.prefill(params, torch.from_numpy(toks).long(), tc),
                jl) <= F32_TOL
    for _ in range(2):
        t = rng.integers(1, 512, (2, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jnp.asarray(t), jc)
        assert _err(model.decode_step(params, torch.from_numpy(t).long(),
                                      tc), jl) <= F32_RING_TOL


@pytest.mark.parametrize("fmt", ["q8_0", "q4_0"])
def test_quantized_leaves_are_the_jax_packages(fmt):
    """``Model.init`` under q8_0 / q4_0 quantizes exactly the leaves the
    JAX ``quantize_tree`` does on the hybrid tree: in_proj, wa, wx,
    out_proj and the attention and MLP matrices; not conv_w (K 4),
    a_param, the biases, the norms or the embedding."""
    jm, jp, model, params = _pair("bf16")

    def picked(tree, cls):
        return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in path)
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                    tree, is_leaf=lambda n: isinstance(n, cls))[0]
                if isinstance(leaf, cls)}
    want = picked(jquantize_tree(jp, fmt), JQuantizedTensor)
    m = Model(dataclasses.replace(model.cfg, quant_policy=fmt), device="cpu")
    tq = m.init(torch.Generator().manual_seed(0))

    def walk(node, path, out):
        if isinstance(node, QuantizedTensor):
            out.add(path)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}" if path else k, out)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}" if path else str(i), out)
        return out
    got = walk(tq, "", set())
    assert got == want
    assert {p.split("/", 2)[2] for p in got} == {
        "rglru/in_proj/w", "rglru/wa/w", "rglru/wx/w", "rglru/out_proj/w",
        "attn/wqkv/w", "attn/wo/w", "mlp/w_gate_up/w", "mlp/w_down/w"}


@pytest.mark.parametrize("stepwise", [True, False])
def test_reference_decode_matches_jax(stepwise):
    """Greedy streams of both prefill modes, a prompt past the ring among
    them (f32 params)."""
    jm, jp, model, params = _pair("f32")
    rng = np.random.default_rng(10)
    for n in (5, 70):
        prompt = rng.integers(1, 512, n).astype(np.int32)
        assert model.reference_decode(
            params, prompt, 8, max_len=MAX_LEN, stepwise_prefill=stepwise) \
            == jm.reference_decode(jp, prompt, 8, max_len=MAX_LEN,
                                   stepwise_prefill=stepwise)


def test_kv_quant_and_paging_are_no_ops():
    cfg = dataclasses.replace(reduced(get_config(ARCH)), kv_quant="q8_0")
    m = Model(cfg, device="cpu")
    assert m.kv_quant_effective() == "bf16" and m.attn_cfg.kv_quant == "bf16"
    assert m.paging_effective(64, 16) == 0
    assert m.window_for(10) == m.window_for(10 ** 6) == 64
    cache = m.init_cache(2, 256, page_size=16)
    assert "block_table" not in cache
    assert [sorted(c) for c in cache["layers"]] == [
        ["conv", "state"], ["conv", "state"], ["k", "v"]]
    assert cache["layers"][2]["k"].shape == (2, 1, 64, 32)
    assert cache["layers"][2]["k"].dtype == torch.bfloat16


def test_decode_step_launch_sequence():
    """A decode step of an RG-LRU layer is the residual add + norm, the
    conv, the gate products, the RG-LRU step, the residual add + norm and
    the GeGLU (the standalone kernel under bf16 weights); an attention
    layer the RoPE + cache write and decode attention in place of the
    RG-LRU layer's three; a prefill runs the scan and the prefill RoPE and
    attention. The wrappers' calls (their plain versions on the CPU)."""
    jm, jp, model, params = _pair("bf16")
    calls = []
    names = ("ssm_conv", "rglru_decode_step", "rglru_scan", "add_rmsnorm",
             "rmsnorm", "geglu", "rope_cache_write", "decode_attention",
             "rope_cache_write_prefill", "flash_attention", "swiglu")
    saved = {n: getattr(ops, n) for n in names}

    def counted(n):
        def run(*a, **kw):
            calls.append(n)
            return saved[n](*a, **kw)
        return run
    try:
        for n in names:
            setattr(ops, n, counted(n))
        cache = model.init_cache(2, MAX_LEN)
        model.decode_step(params, torch.ones((2, 1), dtype=torch.long), cache)
        rg = ["ssm_conv", "rglru_decode_step", "add_rmsnorm", "geglu",
              "add_rmsnorm"]
        at = ["rope_cache_write", "decode_attention", "add_rmsnorm", "geglu",
              "add_rmsnorm"]
        assert calls == ["rmsnorm"] + rg + rg + at
        calls.clear()
        model.prefill(params, torch.ones((2, 5), dtype=torch.long), cache)
        rg[1], at[:2] = "rglru_scan", ["rope_cache_write_prefill",
                                       "flash_attention"]
        assert calls == ["rmsnorm"] + rg + rg + at
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


# -- the engine ---------------------------------------------------------------
_ENGINES = {}
MODES = {"chunked": {}, "stall": dict(admission="stall")}


def _engines(mode):
    """(JAX engine, port engine) under f32 params, reset."""
    if mode not in _ENGINES:
        jm, jp, model, params = _pair("f32")
        kw = dict(slots=3, max_len=MAX_LEN, **MODES[mode])
        _ENGINES[mode] = (JEngine(jm, jp, **kw),
                          ServingEngine(model, params, **kw))
    for e in _ENGINES[mode]:
        e.reset()
    return _ENGINES[mode]


def _requests(cls, n=4, seed=7, lens=(3, 5, 70, 9), max_new=6):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(1, 512, lens[i % len(lens)])
                .astype(np.int32), max_new_tokens=max_new)
            for i in range(n)]


def _serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [list(r.output) for r in reqs]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_streams_match_jax_engine(mode):
    """Four requests on three slots (a refill), one prompt of 70 tokens
    past the 64-position window and ring, token for token; under stall
    admission every bucket is a prompt's exact length."""
    jeng, teng = _engines(mode)
    assert teng.kv_quant == jeng.kv_quant == "bf16"
    assert [teng._bucket_len(n) for n in (3, 5, 70)] == [3, 5, 70]
    got = _serve(teng, _requests(Request))
    assert got == _serve(jeng, _requests(JRequest))
    assert all(len(o) == 6 for o in got)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_resume_after_preemption(mode):
    """A request preempted after its first megastep resumes from its
    prompt and tokens: under chunked admission its stream is the
    uninterrupted one; under stall admission its tokens after the resume
    are the fused reference of prompt + tokens so far."""
    jm, jp, model, params = _pair("f32")
    eng = ServingEngine(model, params, slots=2, max_len=MAX_LEN,
                        megastep_k=4, **MODES[mode])
    req = _requests(Request, n=1, lens=(6,), max_new=12)[0]
    eng.submit(req)
    while not req.output:
        eng.step()
    assert eng.preempt(req) and req.preemptions == 1
    head = list(req.output)
    assert 0 < len(head) < 12
    eng.run()
    assert req.done and len(req.output) == 12
    assert req.output[:len(head)] == head
    stepwise = mode == "chunked"
    if stepwise:
        assert req.output == model.reference_decode(
            params, req.prompt, 12, max_len=MAX_LEN)
    else:
        resumed = np.concatenate([req.prompt, np.asarray(head, np.int32)])
        assert req.output[len(head):] == model.reference_decode(
            params, resumed, 12 - len(head), max_len=MAX_LEN,
            stepwise_prefill=False)


def test_no_op_flags_serve_the_dense_bf16_engine():
    """A paged, q8_0-cache, prefix-cache engine is the dense bf16 one,
    with the JAX warning."""
    jm, jp, model, params = _pair("f32")
    with pytest.warns(RuntimeWarning, match="prefix_cache requires"):
        peng = ServingEngine(model, params, slots=3, max_len=MAX_LEN,
                             page_size=8, prefix_cache=True, kv_quant="q8_0")
    assert (peng.paged, peng.prefix_cache, peng.kv_quant) == (False, False,
                                                              "bf16")
    _, dense = _engines("chunked")
    assert _serve(peng, _requests(Request)) == _serve(dense,
                                                      _requests(Request))


def test_serve_cli_and_its_floors(capsys):
    """The CLI serves the reduced hybrid under q8_0 weights with the no-op
    flags; its floor counts the RG-LRU states read and written and each
    attention layer's ring read at the run's kv_len plus one row written;
    mamba2's floor is still its weights and its whole state."""
    with pytest.warns(RuntimeWarning, match="prefix_cache requires"):
        res = serve.main(["--arch", ARCH, "--device", "cpu", "--precision",
                          "q8_0", "--requests", "3", "--max-new", "4",
                          "--temperature", "0", "--max-len", "32",
                          "--page-size", "8", "--prefix-cache", "--kv-quant",
                          "q8_0", "--slots", "2"])
    out = capsys.readouterr().out
    assert "kv_quant=bf16" in out and "local-attention rings" in out
    eng, f = res.engine, res.floor
    cfg = eng.cfg
    w = cfg.lru_width
    per_slot = 2 * (w * 4 + 3 * w * 2)             # two RG-LRU layers
    assert f["state_bytes"] == 2 * 2 * per_slot
    kv = np.mean([min(len(r.prompt) + len(r.output) // 2, 32)
                  for r in res.requests])
    assert f["kv_len"] == kv
    assert f["ring_bytes"] == int(2 * (2 * 32 * 2) * (kv + 1))   # 2 slots
    assert f["bytes"] == f["weight_bytes"] + f["state_bytes"] + \
        f["ring_bytes"]
    for r in res.requests:
        assert r.output == eng.model.reference_decode(
            eng.params, r.prompt, 4, max_len=32)
    res = serve.main(["--arch", "mamba2-2.7b", "--device", "cpu",
                      "--requests", "1", "--max-new", "2", "--max-len", "16",
                      "--slots", "2"])
    f = res.floor
    assert f["ring_bytes"] == 0 and f["bytes"] == f["weight_bytes"] + \
        f["state_bytes"]
    assert f["state_bytes"] == 2 * sum(
        t.numel() * t.element_size() for c in res.engine.cache["layers"]
        for t in c.values())
