"""The port's fused prefill and stall admission against the JAX package,
on reduced llama3.2-1b and deepseek-7b (JAX parameters carried over by
``repro_torch.bridge``, the same numpy-seeded tokens on both sides).

Tolerances:
- f32 params: logits within 1e-4 absolute, greedy streams equal.
- bf16 params: logits within 2.5% of their largest magnitude, as for the
  decode step (``test_torch_model.py``): XLA's bf16 ``logistic`` inside
  ``silu`` rounds a third of the SwiGLU elements one ulp away from
  PyTorch's f32-then-round ``silu``, and the difference grows through
  the layers.
- Cache rows below ``seq_lens``, compared dequantized: within 2e-2
  under f32 params (a bf16 rounding step), within 2.5% of the rows'
  largest magnitude under bf16 params (the same silu reason), plus one
  quantization step (the leaf's largest scale) for a quantized cache,
  where a value that moved by a rounding step may cross a quantization
  boundary. Rows at or past
  ``seq_lens`` are the padding's junk: neither package defines them,
  decode never reads them before overwriting them, so they are left out.
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
from repro.models import Model as JModel
from repro.models.attention import kv_cache_read as jread
from repro.quant.quantize import quantize_tree as jquantize_tree
from repro_torch.bridge import from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve
from repro_torch.models import Model
from repro_torch.models.attention import kv_cache_read
from repro_torch.serving import Request, ServingEngine


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


# every param dtype, weight format and cache format, across both archs
PREFILL_CASES = [
    ("llama3.2-1b", "f32", "bf16", "bf16"),
    ("llama3.2-1b", "f32", "q8_0", "q4_0"),
    ("llama3.2-1b", "bf16", "q4_0", "q8_0"),
    ("llama3.2-1b", "bf16", "q8_0", "bf16"),
    ("deepseek-7b", "f32", "q4_0", "q8_0"),
    ("deepseek-7b", "f32", "q8_0", "bf16"),
    ("deepseek-7b", "bf16", "bf16", "q4_0"),
    ("deepseek-7b", "bf16", "q4_0", "bf16"),
]


@pytest.mark.parametrize("arch,pdt,wq,kvq", PREFILL_CASES, ids=str)
def test_prefill_matches_jax(arch, pdt, wq, kvq):
    """A right-padded batch with ragged ``seq_lens``: last-real-position
    logits, ``lens`` and the cache rows below ``seq_lens``."""
    jm, jp, model, params = _pair(arch, wq, kvq, pdt)
    rng = np.random.default_rng(0)
    toks = rng.integers(1, model.cfg.vocab_size, (3, 16)).astype(np.int32)
    seq_lens = np.array([16, 9, 3], np.int32)
    jc = jm.init_cache(3, 24)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks),
                                      "seq_lens": jnp.asarray(seq_lens)}, jc)
    tc = model.init_cache(3, 24)
    tl = model.prefill(params, torch.from_numpy(toks).long(), tc,
                       seq_lens=torch.from_numpy(seq_lens))
    jl = np.asarray(jl)
    assert tl.shape == jl.shape == (3, model.cfg.vocab_size)
    assert tl.dtype == torch.float32
    logit_tol = 1e-4 if pdt == "f32" else 0.025 * np.abs(jl).max()
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=logit_tol)
    assert tc["lens"].tolist() == seq_lens.tolist()
    assert (np.asarray(jc["layers"]["lens"]) == seq_lens[None]).all()
    for i, layer in enumerate(tc["layers"]):
        jleaves = {n: a[i] for n, a in jc["layers"].items()}
        for name, jrow, trow in zip("kv", jread(jleaves, kv_quant=kvq),
                                    kv_cache_read(layer, kv_quant=kvq)):
            jrow = np.asarray(jnp.asarray(jrow, jnp.float32))
            trow = trow.float().numpy()
            tol = 0.02 if pdt == "f32" else 0.025 * np.abs(jrow).max()
            if kvq != "bf16":
                tol += float(layer[f"{name}_scale"].float().max())
            for b, n in enumerate(seq_lens):
                np.testing.assert_allclose(trow[b, :, :n], jrow[b, :, :n],
                                           rtol=0, atol=tol)


def test_prefill_without_seq_lens_takes_the_last_position():
    jm, jp, model, params = _pair("deepseek-7b", "q8_0", "bf16", "f32")
    toks = np.random.default_rng(1).integers(1, 512, (2, 7)).astype(np.int32)
    jl, _ = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)},
                                jm.init_cache(2, 16))
    tc = model.init_cache(2, 16)
    tl = model.prefill(params, torch.from_numpy(toks).long(), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-4)
    assert tc["lens"].tolist() == [7, 7]


def test_prefill_rejects_the_ring_branch_and_other_cache_formats():
    """A prompt longer than the cache takes the ring branch (it used to be
    refused): the logits of a cache long enough, ``lens`` advanced by the
    whole prompt, and the last 8 positions' rows at their ring slots. A
    cache in another format than the config's is refused."""
    model = Model(reduced(get_config("llama3.2-1b")), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        1, 512, (1, 12))).long()
    ring, full = model.init_cache(1, 8), model.init_cache(1, 16)
    torch.testing.assert_close(model.prefill(params, toks, ring),
                               model.prefill(params, toks, full),
                               rtol=0, atol=0)
    assert ring["lens"].tolist() == [12]
    for r_l, f_l in zip(ring["layers"], full["layers"]):
        for name in ("k", "v"):
            assert torch.equal(r_l[name],
                               torch.roll(f_l[name][:, :, 4:12], 12 % 8, 2))
    other = Model(dataclasses.replace(model.cfg, kv_quant="q8_0"),
                  device="cpu")
    with pytest.raises(ValueError, match="cache"):
        model.prefill(params, toks, other.init_cache(1, 16))


@pytest.mark.parametrize("arch,wq,kvq", [("llama3.2-1b", "q8_0", "bf16"),
                                         ("deepseek-7b", "q4_0", "q8_0")])
def test_reference_decode_fused_prefill_equals_jax(arch, wq, kvq):
    jm, jp, model, params = _pair(arch, wq, kvq, "f32")
    prompt = [3, 17, 101, 9, 44, 250, 7]
    want = jm.reference_decode(jp, prompt, 12, max_len=32,
                               stepwise_prefill=False)
    got = model.reference_decode(params, prompt, 12, max_len=32,
                                 stepwise_prefill=False)
    assert got == want
    # under f32 params the fused and the stepwise prefill agree too
    assert model.reference_decode(params, prompt, 12, max_len=32) == want


def _random_requests(vocab, rng, n, max_prompt=20):
    reqs = []
    for i in range(n):
        plen = int(rng.integers(1, max_prompt + 1))
        reqs.append(Request(
            uid=i, prompt=rng.integers(1, vocab, plen).astype(np.int32),
            max_new_tokens=int(rng.integers(1, 10))))
    return reqs


@pytest.fixture(scope="module")
def small_f32():
    cfg = dataclasses.replace(reduced(get_config("deepseek-7b")),
                              param_dtype="f32")
    model = Model(cfg, device="cpu")
    return model, model.init(torch.Generator().manual_seed(0))


def _logits_after(model, params, prompt, prefix, fused):
    """Greedy logits after ``prompt`` then ``prefix``, the prompt fed
    through the fused prefill or one token at a time."""
    cache = model.init_cache(1, 48)
    if fused:
        logits = model.prefill(params, torch.as_tensor(
            np.asarray(prompt, np.int64))[None], cache)
        feed = prefix
    else:
        feed = list(prompt) + list(prefix)
    for t in feed:
        logits = model.decode_step(params, torch.tensor([[int(t)]]), cache)
    return logits[0]


@pytest.mark.parametrize("seed,k", [(0, 1), (1, 4), (2, 8)])
def test_stall_engine_matches_reference_and_chunked(small_f32, seed, k):
    """Several prompts per bucket (lengths 1..20 fall into the 8, 16 and
    32 buckets), more requests than slots, budgets of 1 (the first token
    ends the request) and an EOS stop: the stall engine's streams equal
    ``reference_decode(stepwise_prefill=False)`` token for token.

    Against the chunked engine, under f32 params: the fused prefill
    attends over the prompt's f32 K/V, while chunked admission attends
    over the bf16 cache it has just written (the JAX package's cache is
    bf16 under f32 params too), so the two paths' logits differ by that
    rounding and a near tie may flip (seed 0 has one). The streams must be equal up to the first token where they
    part, and there the chunked path's top-2 margin must be within twice
    the two paths' logit difference."""
    model, params = small_f32
    outs = {}
    for mode in ("chunked", "stall"):
        rng = np.random.default_rng(seed)
        reqs = _random_requests(model.cfg.vocab_size, rng, 7)
        probe = model.reference_decode(params, reqs[2].prompt, 9,
                                       max_len=48, stepwise_prefill=False)
        reqs[2].max_new_tokens, reqs[2].eos_id = 9, probe[3]
        eng = ServingEngine(model, params, slots=3, max_len=48,
                            megastep_k=k, admission=mode)
        for r in reqs:
            eng.submit(r)
        eng.run()
        assert all(r.done and r.error is None for r in reqs)
        assert eng.stats.tokens_generated == sum(len(r.output) for r in reqs)
        outs[mode] = [r.output for r in reqs]
        if mode == "stall":
            for r in reqs:
                assert r.output == model.reference_decode(
                    params, r.prompt, r.max_new_tokens, eos_id=r.eos_id,
                    max_len=48, stepwise_prefill=False), r.uid
            assert reqs[2].output == probe[:probe.index(probe[3]) + 1]
            assert eng.stats.prefills == 7
            assert eng.stats.chunk_refills == 0
    for r, chunked, stall in zip(reqs, outs["chunked"], outs["stall"]):
        if chunked == stall:
            continue
        i = next(j for j, (a, b) in enumerate(zip(chunked, stall)) if a != b)
        lc = _logits_after(model, params, r.prompt, chunked[:i], False)
        lf = _logits_after(model, params, r.prompt, chunked[:i], True)
        top2 = lc.topk(2).values
        assert float(top2[0] - top2[1]) <= 2 * float((lc - lf).abs().max())


def test_stall_engine_bf16_params_match_fused_reference():
    """Under bf16 params the stall engine still equals the fused-prefill
    reference token for token: each batch row is computed on its own, so
    a padded bucket's real rows equal the prompt prefilled alone."""
    model = Model(reduced(get_config("llama3.2-1b")), device="cpu")
    params = model.init(torch.Generator().manual_seed(3))
    rng = np.random.default_rng(5)
    reqs = _random_requests(model.cfg.vocab_size, rng, 6, max_prompt=30)
    eng = ServingEngine(model, params, slots=4, max_len=64, megastep_k=4,
                        admission="stall", quant_policy="q8_0",
                        kv_quant="q8_0")
    for r in reqs:
        eng.submit(r)
    eng.run()
    for r in reqs:
        assert r.output == eng.model.reference_decode(
            eng.params, r.prompt, r.max_new_tokens, max_len=64,
            stepwise_prefill=False), r.uid


def test_batched_prefill_one_call_per_bucket(small_f32):
    """Prompts landing in the same length bucket prefill in one call
    (prefill_batches < prefills); the lengths 5..8 all pad to 8."""
    model, params = small_f32
    eng = ServingEngine(model, params, slots=4, max_len=48,
                        admission="stall")
    for i in range(4):
        eng.submit(Request(uid=i, prompt=np.arange(5 + i, dtype=np.int32)
                           + 1, max_new_tokens=4))
    eng.run()
    assert eng.stats.prefills == 4
    assert eng.stats.prefill_batches == 1
    assert eng._bucket_len(1) == 8 and eng._bucket_len(9) == 16
    assert eng._bucket_len(40) == 48      # capped at max_len


@pytest.mark.parametrize("bad", ["", "Stall", "paged", None])
def test_bad_admission_raises(small_f32, bad):
    model, params = small_f32
    with pytest.raises(ValueError, match="admission"):
        ServingEngine(model, params, admission=bad)


def test_serve_cli_stall_admission_on_cpu(capsys):
    res = serve.main(["--device", "cpu", "--admission", "stall",
                      "--requests", "5", "--max-new", "6", "--slots", "2",
                      "--megastep-k", "4", "--precision", "q8_0",
                      "--kv-quant", "q8_0", "--temperature", "0",
                      "--max-len", "32"])
    out = capsys.readouterr().out
    assert "stall" in out and "prefill batches" in out
    eng = res.engine
    assert eng.admission == "stall"
    assert 0 < eng.stats.prefill_batches <= eng.stats.prefills == 5
    for r in res.requests:
        assert r.done and len(r.output) == 6
        assert r.output == eng.model.reference_decode(
            eng.params, r.prompt, 6, max_len=32, stepwise_prefill=False)
