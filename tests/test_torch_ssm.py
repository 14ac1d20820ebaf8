"""The SSM family (Mamba-2 SSD) in the port against the JAX package on the
CPU: reduced mamba2-2.7b (d_model 128, N 16, P 32, 8 heads, 2 layers) with
the JAX parameters carried over by ``repro_torch.bridge``, and A_log,
dt_bias and conv_b drawn at random (their inits are zeros) so that every
term of the recurrence moves.

- the config field by field, and its reduced variant;
- each plain version against its JAX function: ``_causal_conv`` at S 1,
  2 and 5 with a state, ``ssd_chunked`` against the JAX ``ssd_chunked``
  and ``ref.ssd_scan_ref`` at S 37, 64 and 100 with an initial state, the
  scan kernel's algorithm (fixed chunks of 64, the last one masked) in
  plain PyTorch against ``ssd_scan_ref``, ``ssm_decode`` with frozen rows,
  and ``ssm_forward(return_state=True)``;
- ``Model.prefill`` + ``decode_step`` against the JAX ``Model`` under f32
  and bf16 params, and ``from_jax`` of the JAX SSM cache;
- the engine's greedy streams against the JAX engine's under chunked and
  stall admission and bf16 / q8_0 weights; exact-length buckets,
  ``kv_quant`` and paging as no-ops, a prompt past ``max_len`` served,
  and a resume after preemption;
- ``quantize_tree`` picking the JAX package's leaves at 2 layers, and
  only ``in_proj`` / ``out_proj`` at 32.

Tolerances: f32, within 1e-5 of the largest magnitude (measured: at most
3e-6; the sums run in another order than XLA's); the conv under bf16
within one bf16 step of its scale (the port rounds each product and
partial sum to bf16, as eager ops do; XLA's fused sum may not; measured
one step) and its state bit-equal; bf16
params, the model's logits within 5% of their largest magnitude (measured
3.0%; XLA fuses the bf16 silu, the gate and the conv's sums without the
eager op-by-op rounding the port keeps, so a logit moves by a few bf16
steps). Greedy streams exactly.
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
from repro.kernels.ref import ssd_scan_ref
from repro.models import Model as JModel
from repro.models import ssm as jssm
from repro.models.model import _freeze_rows
from repro.quant.quantize import QuantizedTensor as JQuantizedTensor
from repro.quant.quantize import quantize_tree as jquantize_tree
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch.bridge import from_jax
from repro_torch.configs import SSM_MODELS, get_config, reduced
from repro_torch.kernels import ops
from repro_torch.kernels import ssm as kssm
from repro_torch.launch import serve
from repro_torch.models import Model
from repro_torch.models import ssm as tssm
from repro_torch.quant import QuantizedTensor, quantize_tree
from repro_torch.serving import Request, ServingEngine

ARCH = "mamba2-2.7b"
MAX_LEN = 32
F32_TOL = 1e-5
BF16_LOGIT_TOL = 0.05
BF16_STEP = 2.0 ** -7    # one bf16 step at the output's scale


def _t(a):
    return torch.as_tensor(np.array(a))


def _err(t, j):
    j = np.asarray(j, np.float32)
    return float(np.abs(t.float().numpy() - j).max() / np.abs(j).max())


@functools.lru_cache(maxsize=None)
def _pair(param_dtype="f32", weights="bf16", layers=2):
    """(JAX model, JAX params, port model, port params), the same weights
    on both sides (quantized by the JAX package under q8_0)."""
    over = dict(param_dtype=param_dtype, num_layers=layers)
    jm = JModel(dataclasses.replace(jreduced(jget(ARCH)), **over,
                                    dtype=param_dtype))
    jp = jm.init(jax.random.PRNGKey(0), quantize=False)
    rng = np.random.default_rng(3)
    ssm = jp["layers"]["ssm"]
    for k, scale in (("A_log", 0.5), ("dt_bias", 0.5), ("conv_b", 0.2)):
        ssm[k] = jnp.asarray(scale * rng.standard_normal(ssm[k].shape),
                             ssm[k].dtype)
    if weights != "bf16":
        jp = jquantize_tree(jp, weights)
    model = Model(dataclasses.replace(reduced(get_config(ARCH)), **over),
                  device="cpu")
    params = from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jm, jp, model, params


def _layer(param_dtype="f32"):
    """Layer 0's params on both sides, and the config."""
    jm, jp, model, params = _pair(param_dtype)
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["ssm"])
    return jm.cfg, jl, model.cfg, params["layers"][0]["ssm"]


# -- configs ------------------------------------------------------------------
def test_config_and_reduced_equal_jax_field_by_field():
    assert sorted(SSM_MODELS) == [ARCH]
    cfg, jcfg = get_config(ARCH), jget(ARCH)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    red, jred = reduced(cfg), jreduced(jcfg)
    for f in dataclasses.fields(red):
        assert getattr(red, f.name) == getattr(jred, f.name), f.name
    assert (cfg.d_inner, cfg.ssm_heads, cfg.padded_vocab) == (5120, 80, 50432)
    assert (red.d_inner, red.ssm_heads, red.ssm_state) == (256, 8, 16)
    assert cfg.is_recurrent and not get_config("llama3.2-1b").is_recurrent


# -- plain versions against the JAX functions ---------------------------------
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("S", [1, 2, 5])
def test_causal_conv_matches_jax(S, dtype):
    """y and the new state with a carried state, and y from zeros; under
    bf16 y within one bf16 step of its scale and the state (a copy)
    bit-equal. The kernel's plain version writes the state in place only
    for advancing rows."""
    jcfg, jl, cfg, tl = _layer(dtype)
    C = cfg.d_inner + 2 * cfg.ssm_state
    rng = np.random.default_rng(S)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    x = jnp.asarray(rng.standard_normal((3, S, C)), jdt)
    st = jnp.asarray(rng.standard_normal((3, 3, C)), jdt)
    jy, jst = jssm._causal_conv(x, jl["conv_w"], jl["conv_b"], st)
    ty, tst = tssm._causal_conv(_t(x.astype(jnp.float32)).to(
        torch.float32 if dtype == "f32" else torch.bfloat16),
        tl["conv_w"], tl["conv_b"], _t(st.astype(jnp.float32)).to(
            tl["conv_w"].dtype))
    tol = F32_TOL if dtype == "f32" else BF16_STEP
    assert _err(ty, jy.astype(jnp.float32)) <= tol
    assert _err(tst, jst.astype(jnp.float32)) == 0.0
    jy0, _ = jssm._causal_conv(x, jl["conv_w"], jl["conv_b"])
    state = _t(st.astype(jnp.float32)).to(ty.dtype)
    before = state.clone()
    adv = torch.tensor([True, False, True])
    y0 = kssm.ssm_conv(ty.new_tensor(np.asarray(x.astype(jnp.float32))),
                       tl["conv_w"], tl["conv_b"], state, adv, carry=False)
    assert _err(y0, jy0.astype(jnp.float32)) <= tol
    assert torch.equal(state[1], before[1])
    if S >= 3:
        assert torch.equal(state[0], y0.new_tensor(
            np.asarray(x[0, -3:].astype(jnp.float32))))


def _scan_inputs(S, seed=0, H=3, P=8, N=16, B=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(0.5 * rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    s0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return x, dt, A, Bm, Cm, s0


def scan_tiles(x, dt, A, Bm, Cm, s0, Q=kssm.SCAN_CHUNK):
    """The scan kernel's algorithm in plain PyTorch: fixed chunks of Q,
    the last one padded with dt 0 and x, B, C 0; L a chunk's running sum;
    M = exp(L_q - L_k) C_q.B_k dt_k for k <= q; y = M x + exp(L_q) C s;
    s <- s exp(L_last) + sum_k exp(L_last - L_k) dt_k x_k B_k."""
    Bb, S, H, P = x.shape
    pad = -S % Q
    padded = [torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
              for t in (x, dt, Bm, Cm)]
    x, dt, Bm, Cm = padded
    s = s0.clone()
    ys = []
    for c0 in range(0, S + pad, Q):
        xc, dc, bc, cc = (t[:, c0:c0 + Q] for t in (x, dt, Bm, Cm))
        L = torch.cumsum(dc * A, dim=1)                         # (B, Q, H)
        cb = torch.einsum("bqn,bkn->bqk", cc, bc)
        tril = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
        M = torch.where(tril[None, :, :, None],
                        torch.exp(L[:, :, None] - L[:, None]), 0.0)
        M = M * cb[..., None] * dc[:, None]
        y = torch.einsum("bqkh,bkhp->bqhp", M, xc)
        y = y + torch.einsum("bqn,bhpn->bqhp", cc, s) * torch.exp(L)[..., None]
        w = torch.exp(L[:, -1:] - L) * dc
        s = s * torch.exp(L[:, -1])[..., None, None] + torch.einsum(
            "bqh,bqn,bqhp->bhpn", w, bc, xc)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S], s


@pytest.mark.parametrize("S", [37, 64, 100])
def test_ssd_chunked_and_the_kernels_tiles_match_jax(S):
    """The port's ssd_chunked (chunk 64, halved to 1 at S 37) against the
    JAX one and the sequential oracle, from an initial state; the scan
    kernel's fixed masked chunks against the oracle."""
    x, dt, A, Bm, Cm, s0 = _scan_inputs(S, seed=S)
    jy, js = jssm.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                              64, init_state=jnp.asarray(s0))
    ry, rs = ssd_scan_ref(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                          init_state=jnp.asarray(s0))
    ty, ts = kssm.ssd_chunked(*(torch.from_numpy(a)
                                for a in (x, dt, A, Bm, Cm)), 64,
                              init_state=torch.from_numpy(s0))
    for t, j in ((ty, jy), (ts, js), (ty, ry), (ts, rs)):
        assert _err(t, j) <= F32_TOL
    ky, ks = scan_tiles(*(torch.from_numpy(a)
                          for a in (x, dt, A, Bm, Cm, s0)))
    assert _err(ky, ry) <= F32_TOL and _err(ks, rs) <= F32_TOL
    # from zeros, without a state
    zy, _ = kssm.ssd_chunked(*(torch.from_numpy(a)
                               for a in (x, dt, A, Bm, Cm)), 64)
    ry0, _ = ssd_scan_ref(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)))
    assert _err(zy, ry0) <= F32_TOL


def test_ssm_decode_matches_jax_with_frozen_rows():
    """Three tokens through layer 0 from a random state; row 1 frozen in
    the second (its conv and SSD states bit-equal to before)."""
    jcfg, jl, cfg, tl = _layer("f32")
    rng = np.random.default_rng(4)
    C = cfg.d_inner + 2 * cfg.ssm_state
    jc = {"conv": jnp.asarray(rng.standard_normal((2, 3, C)), jnp.float32),
          "state": jnp.asarray(rng.standard_normal(
              (2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)),
              jnp.float32),
          "lens": jnp.zeros((2,), jnp.int32)}
    tc = {k: _t(v).clone() for k, v in jc.items() if k != "lens"}
    for step in range(3):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        mask = np.array([True, step != 1])
        jy, jn = jssm.ssm_decode(jl, jcfg, jnp.asarray(x), jc)
        jc = _freeze_rows(jn, jc, jnp.asarray(mask))
        before = {k: v.clone() for k, v in tc.items()}
        ty = tssm.ssm_decode(tl, cfg, torch.from_numpy(x), tc,
                             torch.from_numpy(mask))
        assert _err(ty, jy) <= F32_TOL
        for k in ("conv", "state"):
            assert _err(tc[k], jc[k]) <= F32_TOL
            if step == 1:
                assert torch.equal(tc[k][1], before[k][1])


@pytest.mark.parametrize("carry", [False, True])
def test_ssm_forward_returns_the_jax_states(carry):
    """ssm_forward(return_state=True) at S 37 (the JAX chunk rule halves
    64 to 1), from zeros and from given states, which it leaves alone."""
    jcfg, jl, cfg, tl = _layer("f32")
    rng = np.random.default_rng(5)
    C = cfg.d_inner + 2 * cfg.ssm_state
    x = rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((2, 3, C)).astype(np.float32) if carry \
        else None
    st = rng.standard_normal((2, cfg.ssm_heads, cfg.ssm_head_dim,
                              cfg.ssm_state)).astype(np.float32) \
        if carry else None
    jy, (jconv, jst) = jssm.ssm_forward(
        jl, jcfg, jnp.asarray(x),
        conv_state=None if conv is None else jnp.asarray(conv),
        ssd_state=None if st is None else jnp.asarray(st), return_state=True)
    tconv = None if conv is None else torch.from_numpy(conv)
    tst = None if st is None else torch.from_numpy(st)
    ty, (nconv, nst) = tssm.ssm_forward(tl, cfg, torch.from_numpy(x),
                                        conv_state=tconv, ssd_state=tst,
                                        return_state=True)
    assert _err(ty, jy) <= F32_TOL
    assert _err(nconv, jconv) <= F32_TOL and _err(nst, jst) <= F32_TOL
    if carry:
        assert torch.equal(tconv, torch.from_numpy(conv))


# -- the model ----------------------------------------------------------------
@pytest.mark.parametrize("param_dtype", ["f32", "bf16"])
def test_model_prefill_and_decode_match_jax(param_dtype):
    """A 2 x 37 prefill, then three decode steps (row 1 frozen in the
    second), logits and final states; the JAX cache carried over by
    from_jax gives the port's layout, one lens."""
    jm, jp, model, params = _pair(param_dtype)
    tol = F32_TOL if param_dtype == "f32" else BF16_LOGIT_TOL
    rng = np.random.default_rng(6)
    toks = rng.integers(1, 512, (2, 37)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                        jm.init_cache(2, MAX_LEN))
    tc = model.init_cache(2, MAX_LEN)
    tl = model.prefill(params, torch.from_numpy(toks).long(), tc)
    assert _err(tl, jl) <= tol
    bridged = from_jax(jax.tree_util.tree_map(np.asarray, jc), device="cpu")
    assert bridged["lens"].tolist() == tc["lens"].tolist() == [37, 37]
    for a, b in zip(bridged["layers"], tc["layers"]):
        assert a.keys() == b.keys() == {"conv", "state"}
        assert _err(b["state"], a["state"].numpy()) <= max(tol, F32_TOL)
    for step in range(3):
        t = rng.integers(1, 512, (2, 1)).astype(np.int32)
        mask = np.array([True, step != 1])
        jl, jc = jm.decode_step(jp, jnp.asarray(t), jc,
                                advance_mask=jnp.asarray(mask))
        tl = model.decode_step(params, torch.from_numpy(t).long(), tc,
                               advance_mask=torch.from_numpy(mask))
        assert _err(tl, jl) <= tol
    assert tc["lens"].tolist() == [40, 39]


def test_kv_quant_and_paging_are_no_ops():
    cfg = dataclasses.replace(reduced(get_config(ARCH)), kv_quant="q8_0")
    m = Model(cfg, device="cpu")
    assert m.kv_quant_effective() == "bf16"
    assert m.paging_effective(64, 16) == 0
    cache = m.init_cache(2, 64, page_size=16)
    assert "block_table" not in cache
    assert {k for layer in cache["layers"] for k in layer} == {"conv",
                                                              "state"}


@pytest.mark.parametrize("layers", [2, 32])
def test_quantize_tree_picks_in_and_out_proj(layers):
    """The port quantizes exactly in_proj and out_proj at any depth; the
    JAX package picks the same at 2 layers, and at 32 also the stacked
    (32, H) / (32, C) vectors (its axis -2 is the depth then)."""
    jm, jp, model, params = _pair("bf16", layers=layers)

    def picked(tree, cls):
        out = set()
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda n: isinstance(n, cls))[0]:
            if isinstance(leaf, cls):
                out.add(path[-1].key if hasattr(path[-1], "key")
                        else str(path[-1]))
        return out
    jq = picked(jquantize_tree(jp, "q8_0"), JQuantizedTensor)
    tq = quantize_tree(params, "q8_0")
    port = {k for k in tq["layers"][0]["ssm"]
            if isinstance(tq["layers"][0]["ssm"][k], QuantizedTensor)}
    port |= {k + "/w" for k in ("in_proj", "out_proj")
             if isinstance(tq["layers"][0]["ssm"][k]["w"], QuantizedTensor)}
    assert port == {"in_proj/w", "out_proj/w"}
    assert all(isinstance(p_l["ssm"][k]["w"], QuantizedTensor)
               for p_l in tq["layers"] for k in ("in_proj", "out_proj"))
    want = {"w"} | ({"A_log", "D_skip", "conv_b", "dt_bias"}
                    if layers == 32 else set())
    assert jq == want


# -- the engine ---------------------------------------------------------------
_ENGINES = {}
MODES = {"chunked": {}, "stall": dict(admission="stall")}


def _engines(weights, mode):
    """(JAX engine, port engine), reset. The JAX engine's model allocates
    its cache in f32: the JAX ``init_ssm_cache`` makes the conv state bf16,
    which its megastep's scan refuses to carry once an f32 activation is
    written into it (the port allocates the activation dtype)."""
    key = (weights, mode)
    if key not in _ENGINES:
        jm, jp, model, params = _pair("f32", weights)
        jm = JModel(jm.cfg)
        jm.init_cache = functools.partial(JModel.init_cache, jm,
                                          dtype=jnp.float32)
        kw = dict(slots=3, max_len=MAX_LEN, **MODES[mode])
        _ENGINES[key] = (JEngine(jm, jp, **kw),
                         ServingEngine(model, params, **kw))
    for e in _ENGINES[key]:
        e.reset()
    return _ENGINES[key]


def _requests(cls, n=4, seed=7, lens=(3, 5, 9, 5), max_new=6):
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
@pytest.mark.parametrize("weights", ["bf16", "q8_0"])
def test_engine_streams_match_jax_engine(weights, mode):
    """Four requests on three slots (a refill), token for token; under
    stall admission every bucket is a prompt's exact length."""
    jeng, teng = _engines(weights, mode)
    assert teng.kv_quant == jeng.kv_quant == "bf16"
    assert [teng._bucket_len(n) for n in (3, 5, 9)] == [3, 5, 9]
    assert _serve(teng, _requests(Request)) == _serve(jeng,
                                                       _requests(JRequest))
    if mode == "stall":
        assert teng.stats.prefill_batches == jeng.stats.prefill_batches


def test_engine_prompt_past_max_len_and_no_op_paging():
    """A prompt longer than max_len is served under both admissions (the
    JAX submit takes it; a dense attention cache would refuse it); a
    paged, q8_0-cache, prefix-cache engine is the dense bf16 one, with the
    JAX warning."""
    for mode in MODES:
        jeng, teng = _engines("bf16", mode)
        got = _serve(teng, _requests(Request, n=1, lens=(MAX_LEN + 9,)))
        assert got == _serve(jeng, _requests(JRequest, n=1,
                                             lens=(MAX_LEN + 9,)))
        assert len(got[0]) == 6
    jm, jp, model, params = _pair("f32")
    with pytest.warns(RuntimeWarning, match="prefix_cache requires"):
        peng = ServingEngine(model, params, slots=3, max_len=MAX_LEN,
                             page_size=8, prefix_cache=True, kv_quant="q8_0")
    assert (peng.paged, peng.prefix_cache, peng.kv_quant) == (False, False,
                                                              "bf16")
    _, dense = _engines("bf16", "chunked")
    assert _serve(peng, _requests(Request)) == _serve(dense,
                                                      _requests(Request))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_resume_after_preemption(mode):
    """A request preempted after its first megastep resumes from its
    prompt and tokens: under chunked admission its stream is the
    uninterrupted one; under stall admission its tokens after the resume
    are the fused reference of prompt + tokens so far (the resume
    re-prefills them at their exact length)."""
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
    ref = model.reference_decode(params, req.prompt, 12, max_len=MAX_LEN,
                                 stepwise_prefill=stepwise)
    if stepwise:
        assert req.output == ref
    else:
        resumed = np.concatenate([req.prompt, np.asarray(head, np.int32)])
        assert req.output[len(head):] == model.reference_decode(
            params, resumed, 12 - len(head), max_len=MAX_LEN,
            stepwise_prefill=False)


def test_decode_step_launch_sequence():
    """One SSM decode step is, a layer, in_proj, the conv and the state
    update in one call (``ssm_decode_step``), the gated norm, out_proj and
    the residual add + norm; a prefill runs the conv and the scan apart:
    the wrappers' calls (their plain versions on the CPU) once each a
    layer."""
    jm, jp, model, params = _pair("f32")
    calls = []
    names = ("ssm_conv", "ssm_decode_step", "gated_rmsnorm", "ssd_prefill",
             "add_rmsnorm", "rmsnorm")
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
        L = model.cfg.num_layers
        assert calls == ["rmsnorm"] + ["ssm_decode_step", "gated_rmsnorm",
                                       "add_rmsnorm"] * L
        calls.clear()
        model.prefill(params, torch.ones((2, 5), dtype=torch.long), cache)
        assert calls == ["rmsnorm"] + ["ssm_conv", "ssd_prefill",
                                       "gated_rmsnorm", "add_rmsnorm"] * L
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


def test_serve_cli_serves_mamba2_reduced_on_cpu(capsys):
    """The CLI serves mamba2 under q4_0 weights, stall admission, with
    --page-size and --kv-quant as no-ops, and its floor counts the
    state read and written at its slot count."""
    with pytest.warns(RuntimeWarning, match="prefix_cache requires"):
        res = serve.main(["--arch", ARCH, "--device", "cpu", "--precision",
                          "q4_0", "--requests", "3", "--max-new", "4",
                          "--temperature", "0", "--max-len", "16",
                          "--page-size", "8", "--prefix-cache", "--kv-quant",
                          "q8_0", "--slots", "2"])
    out = capsys.readouterr().out
    assert "kv_quant=bf16" in out and "page_size=0 (asked 8)" in out
    cfg = res.engine.cfg
    per_slot = cfg.num_layers * (
        cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
        + (cfg.ssm_conv - 1) * (cfg.d_inner + 2 * cfg.ssm_state) * 2)
    assert res.floor["state_bytes"] == 2 * 2 * per_slot
    assert res.floor["bytes"] == res.floor["weight_bytes"] + \
        res.floor["state_bytes"]
    assert "of state (2 slots)" in out
    for r in res.requests:
        assert r.output == res.engine.model.reference_decode(
            res.engine.params, r.prompt, 4, max_len=16)
