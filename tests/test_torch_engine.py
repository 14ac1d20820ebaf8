"""The port's serving engine against the port's ``reference_decode`` and
against the JAX engine's greedy token streams (reduced configs, CPU).

Engine vs the port's own reference: exact token equality, since both run
the same ``decode_step`` on the same rows (each batch row is computed
independently). Engine vs the JAX engine: f32 params, where the two
models' logits agree to ~1e-6 (see test_torch_model.py), so greedy
streams are equal.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models import Model as JModel
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch.bridge import from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.models import Model
from repro_torch.serving import (PromptTooLong, Request, SamplingConfig,
                                 ServingEngine, sample, sample_batched)


@pytest.fixture(scope="module")
def small():
    cfg = reduced(get_config("deepseek-7b"))
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    return model, params


def _prompts(n, seed=0, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=3 + (5 * i) % 11).astype(np.int32)
            for i in range(n)]


@pytest.mark.parametrize("k", [1, 4, 8])
def test_engine_matches_reference_decode(small, k):
    """More requests than slots, prompts longer than a megastep (chunk
    refills), budgets that end mid-megastep, and one EOS stop."""
    model, params = small
    eng = ServingEngine(model, params, slots=3, max_len=64, megastep_k=k)
    prompts = _prompts(7)
    budgets = [5, 9, 1, 12, 7, 3, 10]
    probe = model.reference_decode(params, prompts[3], 12, max_len=64)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=b)
            for i, (p, b) in enumerate(zip(prompts, budgets))]
    reqs[3].eos_id = probe[4]
    for r in reqs:
        eng.submit(r)
    eng.run()
    for r in reqs:
        want = model.reference_decode(params, r.prompt, r.max_new_tokens,
                                      eos_id=r.eos_id, max_len=64)
        assert r.done and r.error is None
        assert r.output == want, r.uid
    assert reqs[3].output[-1] == reqs[3].eos_id and len(reqs[3].output) == 5
    st = eng.stats
    assert st.prefills == 7 and st.steps == k * st.megasteps
    assert st.tokens_generated == sum(len(r.output) for r in reqs)


def test_engine_matches_jax_engine_greedy_streams():
    jcfg = dataclasses.replace(jreduced(jget("deepseek-7b")),
                               param_dtype="f32")
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(1), quantize=False)
    cfg = dataclasses.replace(reduced(get_config("deepseek-7b")),
                              param_dtype="f32")
    model = Model(cfg, device="cpu")
    params = from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    prompts = _prompts(5, seed=1)
    jeng = JEngine(jm, jp, slots=2, max_len=48, megastep_k=4,
                   quant_policy="q8_0", kv_quant="q8_0")
    teng = ServingEngine(model, params, slots=2, max_len=48, megastep_k=4,
                         quant_policy="q8_0", kv_quant="q8_0")
    jreqs = [JRequest(uid=i, prompt=p, max_new_tokens=6)
             for i, p in enumerate(prompts)]
    treqs = [Request(uid=i, prompt=p, max_new_tokens=6)
             for i, p in enumerate(prompts)]
    for jr, tr in zip(jreqs, treqs):
        jeng.submit(jr)
        teng.submit(tr)
    jeng.run()
    teng.run()
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert teng.stats.steps == jeng.stats.steps


def test_retired_slot_stays_frozen(small):
    """A slot that finished keeps its cache rows and lens untouched while
    its neighbours go on decoding, until a new request is admitted."""
    model, params = small
    eng = ServingEngine(model, params, slots=2, max_len=32, megastep_k=4)
    short = Request(uid=0, prompt=np.array([5, 6, 7], np.int32),
                    max_new_tokens=2)
    long = Request(uid=1, prompt=np.array([8, 9], np.int32),
                   max_new_tokens=14)
    eng.submit(short)
    eng.submit(long)
    eng.step()
    assert short.done and eng.active[0] is None
    lens0 = int(eng.cache["lens"][0])
    rows0 = [{k: v[0].clone() for k, v in layer.items()}
             for layer in eng.cache["layers"]]
    while not long.done:
        eng.step()
    assert int(eng.cache["lens"][0]) == lens0 == 3 + 2 - 1
    for layer, saved in zip(eng.cache["layers"], rows0):
        for name, leaf in layer.items():
            assert torch.equal(leaf[0], saved[name]), name
    assert long.output == model.reference_decode(params, long.prompt, 14,
                                                 max_len=32)


def test_nonfinite_logits_retire_only_that_slot(small, monkeypatch):
    model, params = small
    eng = ServingEngine(model, params, slots=2, max_len=32, megastep_k=4)
    want = model.reference_decode(params, [3, 4], 6, max_len=32)
    real = eng.model.decode_step

    def poisoned(p, tokens, cache, advance_mask=None):
        logits = real(p, tokens, cache, advance_mask)
        logits[1] = float("nan")
        return logits

    monkeypatch.setattr(eng.model, "decode_step", poisoned)
    ok = Request(uid=0, prompt=np.array([3, 4], np.int32), max_new_tokens=6)
    bad = Request(uid=1, prompt=np.array([5, 6], np.int32), max_new_tokens=6)
    eng.submit(ok)
    eng.submit(bad)
    eng.run()
    assert bad.done and bad.error == "nonfinite-logits" and bad.output == []
    assert ok.error is None and ok.output == want
    assert eng.stats.poisoned == 1


def test_submit_edge_cases(small):
    model, params = small
    eng = ServingEngine(model, params, slots=2, max_len=8)
    with pytest.raises(ValueError):
        eng.submit(Request(uid=0, prompt=np.array([], np.int32)))
    with pytest.raises(ValueError):
        eng.submit(Request(uid=1, prompt=np.array([1], np.int32),
                           max_new_tokens=-1))
    with pytest.raises(PromptTooLong):
        eng.submit(Request(uid=2, prompt=np.arange(1, 10, dtype=np.int32)))
    zero = Request(uid=3, prompt=np.array([1, 2], np.int32),
                   max_new_tokens=0)
    eng.submit(zero)
    assert zero.done and zero.output == [] and not eng.has_work()
    with pytest.raises(ValueError):
        ServingEngine(model, params, megastep_k=0)
    with pytest.raises(ValueError):
        ServingEngine(model, params, kv_quant="q5_0")


def test_quant_policy_and_kv_quant_on_entry(small):
    model, params = small
    eng = ServingEngine(model, params, slots=2, max_len=16,
                        quant_policy="q4_0", kv_quant="q8_0")
    assert eng.kv_quant == "q8_0" and eng.model.cfg.kv_quant == "q8_0"
    wqkv = eng.params["layers"][0]["attn"]["wqkv"]["w"]
    assert wqkv.fmt == "q4_0"
    layer = eng.cache["layers"][0]
    assert layer["k"].dtype == torch.int8 and layer["k"].shape[-1] == 32
    assert layer["k_scale"].shape == (2, 2, 16, 1)
    with pytest.raises(ValueError):      # no re-quantizing int weights
        ServingEngine(model, eng.params, quant_policy="q8_0")
    r = Request(uid=0, prompt=np.array([1, 2, 3], np.int32),
                max_new_tokens=4)
    eng.submit(r)
    eng.run()
    assert r.output == eng.model.reference_decode(eng.params, r.prompt, 4,
                                                  max_len=16)


def test_stochastic_rows_sample_within_filters_and_greedy_rows_stay_exact(
        small):
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(4, 64, generator=g)
    temp = torch.tensor([0.0, 1.0, 1.0, 0.7])
    top_k = torch.tensor([0, 1, 5, 0], dtype=torch.int32)
    top_p = torch.tensor([1.0, 1.0, 1.0, 0.5])
    draws = torch.stack([sample_batched(logits, g, temp, top_k, top_p)
                         for _ in range(300)])
    argmax = logits.argmax(-1)
    assert (draws[:, 0] == argmax[0]).all()          # greedy row
    assert (draws[:, 1] == argmax[1]).all()          # top-k 1
    top5 = set(logits[2].topk(5).indices.tolist())
    assert set(draws[:, 2].tolist()) <= top5 and len(set(
        draws[:, 2].tolist())) > 1
    # top-p 0.5: only the smallest prefix of the sorted probabilities
    # whose mass reaches 0.5
    p = torch.softmax(logits[3] / 0.7, -1)
    order = p.argsort(descending=True)
    keep = int((p[order].cumsum(0) < 0.5).sum()) + 1
    assert set(draws[:, 3].tolist()) <= set(order[:keep].tolist())
    assert torch.equal(sample(logits, g, SamplingConfig()), argmax.int())
    # in distribution: row 2's draw frequencies track its top-5 softmax
    probs = torch.softmax(logits[2], -1)[list(top5)]
    probs = probs / probs.sum()
    freq = torch.tensor([(draws[:, 2] == i).float().mean() for i in top5])
    assert (freq - probs).abs().max() < 0.12


def test_engine_serves_stochastic_requests(small):
    model, params = small
    eng = ServingEngine(model, params, slots=2, max_len=32, megastep_k=4,
                        sampling=SamplingConfig(temperature=0.8, top_k=40))
    greedy = Request(uid=0, prompt=np.array([3, 4, 5], np.int32),
                     max_new_tokens=6, temperature=0.0)
    hot = Request(uid=1, prompt=np.array([7, 8], np.int32),
                  max_new_tokens=6)
    eng.submit(greedy)
    eng.submit(hot)
    eng.run()
    assert len(hot.output) == 6 and all(0 <= t < 512 for t in hot.output)
    assert greedy.output == model.reference_decode(params, greedy.prompt, 6,
                                                   max_len=32)
