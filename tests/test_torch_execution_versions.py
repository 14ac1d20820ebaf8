"""The paper's unfused V0 execution version and the engine's
``prefill_chunk`` in the port against the JAX package on the CPU.

- V0 (``get_config(name, scheduler_version="v0")``: separate ``wq`` /
  ``wk`` / ``wv`` and ``w_gate`` / ``w_up``) against the JAX V0 ``Model``
  with its parameters carried over by ``repro_torch.bridge``: reduced
  llama3.2-1b under f32 and bf16 params and q8_0 weights, reduced
  qwen2-0.5b with three seeded random biases, reduced phi3.5-moe (V0
  attention, its experts as they are): prefill and decode logits and
  greedy streams;
- V0 against V1 in the port: a V0 model whose weights are the column
  split of a V1 model's gives V1's logits (a quantized weight's split is
  exact: its groups run along K);
- the port's ``ServingEngine(prefill_chunk=)`` at 4 (below K 8: slots
  starve and wait for the host's refill) and 32 against the JAX engine
  on the tiny pair of ``tests/_torch_serving.py``: greedy streams and
  ``chunk_refills`` equal.

Tolerances: f32 params, logits within 1e-4 absolute and greedy streams
equal; bf16 params, logits within 2.5% of their largest magnitude (as
test_torch_paper_models.py).
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_serving import engines, random_requests
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models import Model as JModel
from repro.quant.quantize import quantize_tree as jquantize_tree
from repro.serving import Request as JRequest
from repro_torch.bridge import from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve
from repro_torch.models import Model
from repro_torch.models import attention as attn_mod
from repro_torch.quant import QuantizedTensor, quantize_tree
from repro_torch.serving import Request

MAX_LEN = 32
PROMPT = np.random.default_rng(30).integers(1, 512, 13).astype(np.int32)
# (arch, param dtype, weight format): the V0 cases held to the JAX V0
CASES = [("llama3.2-1b", "f32", "q8_0"), ("llama3.2-1b", "bf16", "bf16"),
         ("qwen2-0.5b", "f32", "bf16"), ("phi3.5-moe-42b-a6.6b", "f32",
                                         "bf16")]


@functools.lru_cache(maxsize=None)
def _v0_pair(name, param_dtype, fmt):
    over = dict(param_dtype=param_dtype, scheduler_version="v0")
    jm = JModel(jreduced(jget(name), **over))
    jp = jm.init(jax.random.PRNGKey(1), quantize=False)
    if jm.cfg.qkv_bias:
        rng = np.random.default_rng(12)
        for n in ("wq", "wk", "wv"):
            b = jp["layers"]["attn"][n]["b"]
            jp["layers"]["attn"][n]["b"] = jnp.asarray(
                0.5 * rng.standard_normal(b.shape), b.dtype)
    if fmt != "bf16":
        jp = jquantize_tree(jp, fmt)
    model = Model(reduced(get_config(name), **over), device="cpu")
    params = from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    jm._ref_jits = (jax.jit(jm.prefill), jax.jit(jm.decode_step))
    return jm, jp, model, params


def _close(got, want, param_dtype):
    want = np.asarray(want)
    atol = 1e-4 if param_dtype == "f32" else 0.025 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("name,param_dtype,fmt", CASES)
def test_v0_matches_the_jax_v0_model(name, param_dtype, fmt):
    jm, jp, model, params = _v0_pair(name, param_dtype, fmt)
    p0 = params["layers"][0]
    assert set(p0["attn"]) == {"wq", "wk", "wv", "wo"}
    if not model.cfg.is_moe:
        assert set(p0["mlp"]) == {"w_gate", "w_up", "w_down"}
        assert isinstance(p0["mlp"]["w_up"]["w"], QuantizedTensor) == (
            fmt != "bf16")
    assert ("b" in p0["attn"]["wk"]) == model.cfg.qkv_bias
    pre, dec = jm._ref_jits
    jc = jm.init_cache(1, MAX_LEN)
    tc = model.init_cache(1, MAX_LEN)
    jl, jc = pre(jp, {"tokens": jnp.asarray(PROMPT[None])}, jc)
    tl = model.prefill(params, torch.from_numpy(PROMPT[None]).long(), tc)
    _close(tl, jl, param_dtype)
    for tok in (9, 200):
        toks = np.array([[tok]], np.int32)
        tc = from_jax(jax.tree_util.tree_map(np.asarray, jc), device="cpu")
        jl, jc = dec(jp, jnp.asarray(toks), jc)
        tl = model.decode_step(params, torch.from_numpy(toks).long(), tc)
        _close(tl, jl, param_dtype)
    if param_dtype == "f32":
        assert model.reference_decode(params, PROMPT[:6], 8,
                                      max_len=MAX_LEN) == \
            jm.reference_decode(jp, PROMPT[:6], 8, max_len=MAX_LEN)


def _split_cols(w, widths):
    """The column blocks of a (K, N) weight, quantized or not."""
    out, at = [], 0
    for n in widths:
        if isinstance(w, QuantizedTensor):
            out.append(QuantizedTensor(w.data[:, at:at + n].contiguous(),
                                       w.scales[:, at:at + n].contiguous(),
                                       w.fmt, w.group))
        else:
            out.append(w[:, at:at + n].contiguous())
        at += n
    return out


def _as_v0(params, cfg):
    """A V1 tree with each fused weight (and the fused bias) cut into the
    V0 projections, the biases as slices of one buffer (``Model.init``'s
    layout)."""
    widths = (cfg.q_dim, cfg.kv_dim, cfg.kv_dim)
    layers = []
    for p_l in params["layers"]:
        a = dict(p_l["attn"])
        fused = a.pop("wqkv")
        for n, w in zip(attn_mod.QKV, _split_cols(fused["w"], widths)):
            a[n] = {"w": w}
        if "b" in fused:
            at = 0
            for n, width in zip(attn_mod.QKV, widths):
                a[n]["b"] = fused["b"][at:at + width]
                at += width
        m = dict(p_l["mlp"])
        g, u = _split_cols(m.pop("w_gate_up")["w"], (cfg.d_ff, cfg.d_ff))
        m.update(w_gate={"w": g}, w_up={"w": u})
        layers.append({**p_l, "attn": a, "mlp": m})
    return {**params, "layers": layers}


@pytest.mark.parametrize("name,fmt", [("llama3.2-1b", "q8_0"),
                                      ("llama3.2-1b", "q4_0"),
                                      ("qwen2-0.5b", "bf16")])
def test_v0_with_split_weights_gives_v1s_logits(name, fmt):
    """V1's fused weights cut into V0's projections: the same prefill and
    decode logits (f32 params), and the bias reaches the RoPE as one view
    of the layer's buffer."""
    cfg = dataclasses.replace(reduced(get_config(name)), param_dtype="f32")
    v1 = Model(cfg, device="cpu")
    params = v1.init(torch.Generator().manual_seed(5), quantize=False)
    if cfg.qkv_bias:
        g = torch.Generator().manual_seed(6)
        for p_l in params["layers"]:
            b = p_l["attn"]["wqkv"]["b"]
            b.copy_(0.5 * torch.randn(b.shape, generator=g))
    params = quantize_tree(params, fmt)
    v0 = Model(dataclasses.replace(cfg, scheduler_version="v0"), device="cpu")
    p0 = _as_v0(params, cfg)
    if cfg.qkv_bias:
        fused = p0["layers"][0]["attn"]
        joined = attn_mod._qkv_bias(fused)
        assert joined.data_ptr() == fused["wq"]["b"].data_ptr()
        assert torch.equal(joined, params["layers"][0]["attn"]["wqkv"]["b"])
    tok = torch.from_numpy(PROMPT[None]).long()
    c1, c0 = v1.init_cache(1, MAX_LEN), v0.init_cache(1, MAX_LEN)
    torch.testing.assert_close(v0.prefill(p0, tok, c0),
                               v1.prefill(params, tok, c1), rtol=0, atol=1e-4)
    for t in (3, 77):
        step = torch.tensor([[t]])
        torch.testing.assert_close(v0.decode_step(p0, step, c0),
                                   v1.decode_step(params, step, c1),
                                   rtol=0, atol=1e-4)


def test_v0_init_joins_the_three_biases():
    cfg = reduced(get_config("qwen2-0.5b"), scheduler_version="v0")
    p = Model(dataclasses.replace(cfg, quant_policy="q4_0"),
              device="cpu").init(torch.Generator().manual_seed(0))
    a = p["layers"][1]["attn"]
    assert isinstance(a["wv"]["w"], QuantizedTensor)
    bq, bk, bv = (a[n]["b"] for n in attn_mod.QKV)
    assert bq.shape == (cfg.q_dim,) and bv.shape == (cfg.kv_dim,)
    assert bk.data_ptr() == bq.data_ptr() + bq.numel() * bq.element_size()
    assert attn_mod._qkv_bias(a).data_ptr() == bq.data_ptr()


@pytest.mark.parametrize("chunk", [4, 32])
def test_prefill_chunk_matches_the_jax_engine(chunk):
    """Prompts of 2-39 tokens: at chunk 4 (under K 8) a prefilling slot
    runs dry mid-megastep and waits for the refill; at 32 most prompts
    fit one chunk. Streams and ``chunk_refills`` as the JAX engine's, and
    as the prompts predict."""
    jeng, teng = engines(prefill_chunk=chunk, megastep_k=8)
    assert teng.prefill_chunk == jeng.prefill_chunk == chunk
    outs = []
    for eng, cls in ((jeng, JRequest), (teng, Request)):
        reqs = random_requests(cls, 31, 5, max_prompt=40, max_new=10)
        for r in reqs:
            eng.submit(r)
        eng.run()
        outs.append(([r.output for r in reqs], eng.stats.chunk_refills))
    assert outs[0] == outs[1]
    # a prefilling slot takes min(chunk, K) prompt tokens a megastep, and
    # each megastep after its first refills it
    per = min(chunk, 8)
    refills = sum(-(-len(r.prompt) // per) - 1 for r in reqs)
    assert outs[1][1] == refills > 0


def test_serve_cli_takes_prefill_chunk(capsys):
    res = serve.main(["--arch", "llama3.2-1b", "--device", "cpu",
                      "--requests", "2", "--max-new", "3", "--temperature",
                      "0", "--max-len", "64", "--megastep-k", "4",
                      "--prefill-chunk", "2"])
    assert res.engine.prefill_chunk == 2
    assert "chunk refills" in capsys.readouterr().out
    for r in res.requests:
        assert r.output == res.engine.model.reference_decode(
            res.engine.params, r.prompt, 3, max_len=64)
