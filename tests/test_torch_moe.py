"""The mixture-of-experts family in the port against the JAX package on
the CPU: reduced phi3.5-moe-42b-a6.6b (4 experts, top-2) and reduced
kimi-k2-1t-a32b (4 experts, top-2, one shared expert), with the JAX
parameters carried over by ``repro_torch.bridge``.

- ``moe_forward`` against the JAX ``moe_forward`` at T 1, 4, 16 and a
  2 x 24 bucket, f32 and bf16 params; ``router_aux_loss`` against its
  ``aux``;
- the routing (``route_from_logits_plain``) against the JAX module's
  own steps (``jax.lax.top_k`` of the softmax, the stable ``argsort`` and
  ``searchsorted``) on the same logits, exactly: experts, slots, the
  drop set and the counts, with a router skewed to force drops and with
  exactly tied logits;
- ``Model.prefill`` / ``decode_step`` against the JAX ``Model``;
- the serving engine's greedy streams against the JAX engine's under
  chunked and stall admission, paged with the prefix cache, a q8_0
  cache, and 12 slots whose decode drops pairs (C = 8 for 24 pairs);
- quantized weights refused with a ``ValueError`` where the JAX MoE
  fails with an ``AttributeError``.

Tolerances: f32 params, outputs and logits within 1e-5 of their largest
magnitude (measured: at most 7e-7; the sums run in another order than
XLA's); bf16 params, the MoE output within one bf16 step at its scale
(it rounds at the JAX module's points; measured bit-equal) and the
model's logits within 2.5% of their largest magnitude, for the silu
reason test_torch_paper_models.py gives. Gates within 1e-6 relative (two
softmax implementations). Greedy streams exactly.
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
from repro.models import moe as jmoe
from repro.quant.quantize import QuantizedTensor as JQuantizedTensor
from repro.quant.quantize import quantize_tree as jquantize_tree
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch.bridge import from_jax
from repro_torch.configs import MOE_MODELS, get_config, reduced
from repro_torch.kernels import ops
from repro_torch.kernels.moe import route_from_logits_plain
from repro_torch.launch import serve
from repro_torch.models import Model
from repro_torch.models import moe as tmoe
from repro_torch.serving import Request, ServingEngine

PHI, KIMI = "phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b"
ARCHS = (PHI, KIMI)
MAX_LEN = 64
F32_TOL = 1e-5           # of the output's largest magnitude
BF16_LOGIT_TOL = 0.025


@functools.lru_cache(maxsize=None)
def _pair(arch, param_dtype="f32"):
    """(JAX model, JAX params, port model, port params), the same
    weights on both sides."""
    jm = JModel(jreduced(jget(arch), param_dtype=param_dtype))
    jp = jm.init(jax.random.PRNGKey(0), quantize=False)
    model = Model(reduced(get_config(arch), param_dtype=param_dtype),
                  device="cpu")
    params = from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jm, jp, model, params


@functools.lru_cache(maxsize=None)
def _jax_moe_forward(arch, param_dtype="f32"):
    """The JAX ``moe_forward`` of the pair's config, jitted (one compile
    a shape instead of one a primitive)."""
    cfg = _pair(arch, param_dtype)[0].cfg
    return jax.jit(lambda p, x: jmoe.moe_forward(p, cfg, x))


def _dtypes(param_dtype):
    return ((jnp.float32, torch.float32) if param_dtype == "f32"
            else (jnp.bfloat16, torch.bfloat16))


def _layer0(jp):
    return jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["moe"])


def _to_torch(a, dtype):
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(dtype)


def _jax_route(logits: np.ndarray, K: int, C: int):
    """The JAX ``moe_forward``'s routing steps (moe.py:75-97) on these
    logits: (gates, experts, slots)."""
    lg = jnp.asarray(logits)
    probs = jax.nn.softmax(lg, axis=-1)
    gv, idx = jax.lax.top_k(probs, K)
    gv = gv / jnp.clip(jnp.sum(gv, -1, keepdims=True), 1e-9)
    flat = idx.reshape(-1)
    order = jnp.argsort(flat)
    se = flat[order]
    ar = jnp.arange(flat.shape[0])
    slot_sorted = ar - jnp.searchsorted(se, se, side="left")
    slots = jnp.zeros_like(flat).at[order].set(slot_sorted)
    return (np.asarray(gv), np.asarray(idx),
            np.asarray(slots).reshape(idx.shape))


def _assert_route_matches(logits: np.ndarray, K: int, C: int, E: int):
    """The port's routing equals the JAX steps on the same logits;
    returns the number of dropped pairs."""
    gv, idx, slots = _jax_route(logits, K, C)
    g, e, s, counts, src, _ = route_from_logits_plain(
        torch.from_numpy(logits), K, C)
    np.testing.assert_array_equal(e.numpy(), idx)
    np.testing.assert_array_equal(s.numpy(), slots)
    np.testing.assert_allclose(g.numpy(), gv, rtol=1e-6, atol=0)
    want = np.minimum(np.bincount(idx.reshape(-1), minlength=E), C)
    np.testing.assert_array_equal(counts.numpy(), want)
    for t in range(logits.shape[0]):          # the map of the kept pairs
        for k in range(K):
            if slots[t, k] < C:
                assert int(src[idx[t, k], slots[t, k]]) == t
    return int((slots >= C).sum())


@pytest.mark.parametrize("shape", [(1, 1), (4, 1), (16, 1), (2, 24)])
@pytest.mark.parametrize("param_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_jax(arch, param_dtype, shape):
    jm, jp, model, params = _pair(arch, param_dtype)
    jdt, tdt = _dtypes(param_dtype)
    x = np.random.default_rng(sum(shape)).standard_normal(
        (*shape, model.cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jdt)
    jo, aux = _jax_moe_forward(arch, param_dtype)(_layer0(jp), jx)
    p0 = params["layers"][0]["moe"]
    tx = _to_torch(jx, tdt)
    to = tmoe.moe_forward(p0, model.cfg, tx)
    assert to.dtype == tdt and to.shape == tx.shape
    jo = np.asarray(jo.astype(jnp.float32))
    scale = np.abs(jo).max()
    tol = F32_TOL * scale if param_dtype == "f32" else 2.0 ** -7 * scale
    np.testing.assert_allclose(to.float().numpy(), jo, rtol=0, atol=tol)
    np.testing.assert_allclose(
        float(tmoe.router_aux_loss(p0, model.cfg, tx)), float(aux),
        rtol=1e-6, atol=1e-9)
    # the routing of these logits equals the JAX steps'
    C = tmoe.capacity(model.cfg, x.shape[0] * x.shape[1])
    assert C == jmoe.capacity(jm.cfg, x.shape[0] * x.shape[1])
    logits = tmoe.router_logits(p0, tx.reshape(-1, tx.shape[-1])).numpy()
    _assert_route_matches(logits, model.cfg.experts_per_token, C,
                          model.cfg.num_experts)


def _router_case(case: str, D: int, E: int, rng):
    """(router weight (D, E), x (2, 24, D)) for a case: ``skewed`` (a
    shared direction in x that expert 0's column follows: nearly every
    token picks it, past C), ``tied`` (a zero router: every logit 0) and
    ``twin`` (experts 1 and 2 with the same column: exact ties between
    them)."""
    x = rng.standard_normal((2, 24, D)).astype(np.float32)
    w = (rng.standard_normal((D, E)) * D ** -0.5).astype(np.float32)
    if case == "skewed":
        x += 1.0
        w[:, 0] = 4.0 / D
    elif case == "tied":
        w[:] = 0.0
    else:
        w[:, 2] = w[:, 1]
    return w, x


@pytest.mark.parametrize("case", ["skewed", "tied", "twin"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forced_drops_and_ties_match_jax(arch, case):
    """The same experts, slots, drop set and counts as the JAX steps, and
    the MoE output and aux loss within the f32 tolerance."""
    jm, jp, model, params = _pair(arch)
    cfg = model.cfg
    w, x = _router_case(case, cfg.d_model, cfg.num_experts,
                        np.random.default_rng(3))
    jl = _layer0(jp)
    jl["router"]["w"] = jnp.asarray(w)
    p0 = dict(params["layers"][0]["moe"], router={"w": torch.from_numpy(w)})
    jo, aux = _jax_moe_forward(arch)(jl, jnp.asarray(x))
    to = tmoe.moe_forward(p0, cfg, torch.from_numpy(x))
    jo = np.asarray(jo)
    np.testing.assert_allclose(to.numpy(), jo, rtol=0,
                               atol=F32_TOL * np.abs(jo).max())
    np.testing.assert_allclose(
        float(tmoe.router_aux_loss(p0, cfg, torch.from_numpy(x))),
        float(aux), rtol=1e-6, atol=1e-9)
    C = tmoe.capacity(cfg, 48)
    logits = tmoe.router_logits(p0, torch.from_numpy(x.reshape(48, -1)))
    dropped = _assert_route_matches(logits.numpy(), cfg.experts_per_token,
                                    C, cfg.num_experts)
    if case == "twin":      # tied logits decided the order of 1 and 2
        lg = logits.numpy()
        assert np.array_equal(lg[:, 1], lg[:, 2])
        top = np.argsort(-lg, axis=1, kind="stable")[:, :cfg.experts_per_token]
        assert ((top == 1) | (top == 2)).any()
    else:
        assert dropped > 0


@pytest.mark.parametrize("param_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, param_dtype):
    """A right-padded 2 x 16 prefill (seq_lens 11 and 16), its logits and
    ``lens``; then three decode steps, each from the JAX cache carried
    over."""
    jm, jp, model, params = _pair(arch, param_dtype)
    tol = F32_TOL if param_dtype == "f32" else BF16_LOGIT_TOL
    rng = np.random.default_rng(9)
    toks = rng.integers(1, model.cfg.vocab_size, (2, 16)).astype(np.int32)
    lens = np.array([11, 16], np.int32)
    jc = jm.init_cache(2, MAX_LEN)
    tc = model.init_cache(2, MAX_LEN)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks),
                                      "seq_lens": jnp.asarray(lens)}, jc)
    tl = model.prefill(params, torch.from_numpy(toks).long(), tc,
                       seq_lens=torch.from_numpy(lens))
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0,
                               atol=tol * np.abs(jl).max())
    assert tc["lens"].tolist() == [11, 16]
    dec = jax.jit(jm.decode_step)
    for step in range(3):
        t = rng.integers(1, model.cfg.vocab_size, (2, 1)).astype(np.int32)
        tc = from_jax(jax.tree_util.tree_map(np.asarray, jc), device="cpu")
        jl, jc = dec(jp, jnp.asarray(t), jc)
        tl = model.decode_step(params, torch.from_numpy(t).long(), tc)
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl, rtol=0,
                                   atol=tol * np.abs(jl).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_from_jax_carries_the_moe_params(arch):
    """The stacked (L, E, D, 2F) / (L, E, F, D) experts and the (L, D, E)
    router become per-layer tensors, value for value, with the port's
    own spec shapes."""
    _, jp, model, params = _pair(arch)
    cfg = model.cfg
    specs = model.param_specs()["layers"][0]["moe"]
    for i, p_l in enumerate(params["layers"]):
        assert "mlp" not in p_l
        moe = p_l["moe"]
        assert set(moe) == set(specs) == (
            {"router", "experts", "shared"} if cfg.num_shared_experts
            else {"router", "experts"})
        for group, leaves in specs.items():
            for name, spec in leaves.items():
                got = moe[group][name]
                assert tuple(got.shape) == spec.shape
                want = np.asarray(jp["layers"]["moe"][group][name][i])
                np.testing.assert_array_equal(got.numpy(), want)


# -- the serving engine against the JAX engine ----------------------------
_ENGINES = {}
MODES = {
    "chunked": dict(),
    "stall": dict(admission="stall"),
    "paged_prefix": dict(page_size=8, prefix_cache=True),
    "kv_q8_0": dict(kv_quant="q8_0"),
    "slots12": dict(slots=12),
}


def _engines(arch, mode):
    key = (arch, mode)
    if key not in _ENGINES:
        jm, jp, model, params = _pair(arch)
        kw = dict(dict(slots=4, max_len=MAX_LEN), **MODES[mode])
        _ENGINES[key] = (JEngine(jm, jp, **kw),
                         ServingEngine(model, params, **kw))
    return _ENGINES[key]


def _requests(cls, mode, vocab):
    """Seeded prompts; with the prefix cache, the first eight tokens
    shared (one page) by all but the last; 12 requests on 12 slots; under
    stall admission 4 prompts of at most 8 tokens, one bucket of 4 x 8
    (each bucket shape is a JAX compile)."""
    rng = np.random.default_rng(5)
    n = {"slots12": 12, "stall": 4}.get(mode, 6)
    top = 9 if mode == "stall" else 14
    shared = rng.integers(1, vocab, 8).astype(np.int32)
    out = []
    for i in range(n):
        p = rng.integers(1, vocab, int(rng.integers(3, top))).astype(np.int32)
        if mode == "paged_prefix" and i < n - 1:
            p = np.concatenate([shared, p])
        out.append(cls(uid=i, prompt=p, max_new_tokens=int(
            rng.integers(4, 10))))
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_streams_match_jax_engine(arch, mode, monkeypatch):
    """Token for token, the JAX engine's greedy streams. The 12-slot
    decode routes 24 pairs into C = 8 rows an expert, and its run must
    drop at least one pair (counted from the port's routing)."""
    jeng, teng = _engines(arch, mode)
    vocab = teng.cfg.vocab_size
    dropped = []
    route = ops.moe_route

    def counting(x, w, K, C, reads=None):
        out = route(x, w, K, C, reads)
        dropped.append(int((out[2] >= C).sum()))
        return out
    monkeypatch.setattr(ops, "moe_route", counting)
    results = []
    for eng, cls in ((jeng, JRequest), (teng, Request)):
        eng.reset()
        reqs = _requests(cls, mode, vocab)
        for r in reqs:
            eng.submit(r)
        eng.run()
        assert all(r.done and r.error is None for r in reqs)
        results.append([list(r.output) for r in reqs])
    assert results[0] == results[1]
    if mode == "paged_prefix":
        assert teng.stats.prefix_hits > 0
    if mode == "slots12":
        assert tmoe.capacity(teng.cfg, 12) == 8 and sum(dropped) > 0


# -- quantized weights ----------------------------------------------------
@pytest.mark.parametrize("fmt", ["q8_0", "q4_0"])
def test_quantized_moe_weights_refused(fmt, capsys):
    """The port refuses quantized MoE weights with a ValueError that says
    why (Model.init, ServingEngine; the serve CLI exits with it), where
    the JAX MoE fails inside moe_forward: quantize_tree quantizes the
    router and the stacked experts, and moe.py:74 cannot read them."""
    jm, jp, _, _ = _pair(PHI)
    layer = jquantize_tree(_layer0(jp), fmt)     # what Model.init would do
    assert isinstance(layer["router"]["w"], JQuantizedTensor)
    with pytest.raises(AttributeError, match="astype"):
        jmoe.moe_forward(layer, jm.cfg, jnp.ones((1, 4, jm.cfg.d_model)))
    cfg = dataclasses.replace(reduced(get_config(PHI)), quant_policy=fmt)
    with pytest.raises(ValueError, match="no quantized-weight path"):
        Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    _, _, model, params = _pair(KIMI)
    with pytest.raises(ValueError, match="no quantized-weight path"):
        ServingEngine(model, params, slots=2, max_len=32, quant_policy=fmt)
    with pytest.raises(SystemExit, match="no quantized-weight path"):
        serve.main(["--arch", KIMI, "--device", "cpu", "--precision", fmt])


@pytest.mark.parametrize("arch", sorted(MOE_MODELS))
def test_serve_cli_runs_moe_reduced_on_cpu(arch, capsys):
    """The CLI serves each MoE config reduced; its floor counts the
    experts the routing read (at most all of them, at least top-k)."""
    res = serve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                      "--max-new", "4", "--temperature", "0",
                      "--max-len", "64"])
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke" in out and "experts a layer pass" in out
    eng = res.engine
    for r in res.requests:
        assert r.done and r.output == eng.model.reference_decode(
            eng.params, r.prompt, 4, max_len=64)
    cfg = eng.cfg
    fl = res.floor
    assert cfg.experts_per_token <= fl["experts_a_layer"] <= cfg.num_experts
    assert fl["moe_layer_passes"] == cfg.num_layers * eng.stats.steps
    assert fl["bytes"] <= fl["all_experts_bytes"]
