"""The serving engine's megastep as one device program (reduced configs,
CPU): the body that the card captures as a CUDA graph reads nothing back
to the host, every buffer the graph holds keeps its address across
``reset()``, the warmup before a capture leaves the state as it was, and
the admission merge inside the body gives the JAX engine's greedy
streams when slots are freed and refilled mid-run.

Streams are compared exactly: the JAX engine and the port run f32
params here, where the two models' logits agree to ~1e-6
(test_torch_model.py), so greedy streams are equal.
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
from repro_torch.serving import Request, SamplingConfig, ServingEngine


@pytest.fixture(scope="module")
def small():
    cfg = reduced(get_config("llama3.2-1b"))
    model = Model(cfg, device="cpu")
    return model, model.init(torch.Generator().manual_seed(0))


def _prompts(n, seed=0, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=3 + (5 * i) % 11).astype(np.int32)
            for i in range(n)]


def _engine(small, kv, admission, stochastic, **kw):
    model, params = small
    sampling = SamplingConfig(temperature=0.8 if stochastic else 0.0,
                              top_k=40 if stochastic else 0)
    return ServingEngine(model, params, slots=3, max_len=48, megastep_k=4,
                         kv_quant=kv, admission=admission,
                         sampling=sampling, **kw)


def _device_state(eng):
    leaves = {f"cache.{i}.{n}": t for i, layer in
              enumerate(eng.cache["layers"]) for n, t in layer.items()}
    leaves["cache.lens"] = eng.cache["lens"]
    for f in dataclasses.fields(eng.state):
        leaves[f"state.{f.name}"] = getattr(eng.state, f.name)
    return leaves


HOST_READS = ("item", "cpu", "tolist", "numpy", "__bool__", "nonzero",
              "__int__", "__float__")


@pytest.mark.parametrize("kv", ["bf16", "q8_0", "q4_0"])
@pytest.mark.parametrize("admission", ["chunked", "stall"])
@pytest.mark.parametrize("stochastic", [False, True])
def test_megastep_body_reads_nothing_back(small, monkeypatch, kv, admission,
                                          stochastic):
    eng = _engine(small, kv, admission, stochastic)
    for i, p in enumerate(_prompts(5)):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=6))
    eng.step()                       # mid-run: decoding and waiting slots
    eng._fill_slots()                # host side: refills and admissions
    eng._admit_dev.copy_(eng._admit_host)
    lens = eng.cache["lens"].clone()

    def refuse(*a, **k):
        raise AssertionError("host read inside the megastep body")

    with monkeypatch.context() as m:
        for name in HOST_READS:
            m.setattr(torch.Tensor, name, refuse)
        m.setattr(torch, "nonzero", refuse)
        eng._megastep_body(not eng._stochastic_slots, eng.generator)
    assert not torch.equal(lens, eng.cache["lens"])
    assert any(int(v) for v in eng._block[1].flatten())   # tokens emitted


@pytest.mark.parametrize("kv", ["bf16", "q8_0", "q4_0"])
def test_reset_keeps_every_address(small, kv):
    eng = _engine(small, kv, "chunked", True)
    bufs = dict(_device_state(eng), admit_host=eng._admit_host,
                admit_dev=eng._admit_dev, block=eng._block,
                block_host=eng._block_host)
    ptrs = {n: t.data_ptr() for n, t in bufs.items()}
    gen = eng.generator
    first = [Request(uid=i, prompt=p, max_new_tokens=5)
             for i, p in enumerate(_prompts(4))]
    for r in first:
        eng.submit(r)
    eng.run()
    eng.reset()
    assert eng.generator is gen
    now = dict(_device_state(eng), admit_host=eng._admit_host,
               admit_dev=eng._admit_dev, block=eng._block,
               block_host=eng._block_host)
    assert {n: t.data_ptr() for n, t in now.items()} == ptrs
    for i, layer in enumerate(eng.cache["layers"]):
        for n, leaf in layer.items():
            assert not leaf.any(), (i, n)
    assert not eng.cache["lens"].any()
    assert int(eng.state.eos_id.min()) == -1 and not eng.state.phase.any()
    # reseeded in place: the same requests give the same tokens again
    again = [Request(uid=i, prompt=p, max_new_tokens=5)
             for i, p in enumerate(_prompts(4))]
    for r in again:
        eng.submit(r)
    eng.run()
    assert [r.output for r in again] == [r.output for r in first]


@pytest.mark.parametrize("kv", ["bf16", "q4_0"])
@pytest.mark.parametrize("stochastic", [False, True])
def test_warmup_before_a_capture_leaves_the_state(small, kv, stochastic):
    """The eager run before a capture (every slot idle, nothing
    admitted) writes no cache row and moves no slot state or generator,
    whatever the engine was doing."""
    eng = _engine(small, kv, "chunked", stochastic)
    for i, p in enumerate(_prompts(5, seed=3)):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=8))
    eng.step()
    before = {n: t.clone() for n, t in _device_state(eng).items()}
    gen = eng.generator.get_state()
    eng._warm_up(not eng._stochastic_slots)
    for n, t in _device_state(eng).items():
        assert torch.equal(t, before[n]), n
    assert torch.equal(eng.generator.get_state(), gen)


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jreduced(jget("deepseek-7b")),
                               param_dtype="f32")
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(2), quantize=False)
    cfg = dataclasses.replace(reduced(get_config("deepseek-7b")),
                              param_dtype="f32")
    model = Model(cfg, device="cpu")
    params = from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jm, jp, model, params


@pytest.mark.parametrize("case", ["refill", "eos_and_budget", "nonfinite"])
def test_in_program_merge_gives_the_jax_streams(pair, monkeypatch, case):
    """Two slots, six requests: slots are freed and refilled mid-run;
    with EOS and budgets that end mid-megastep; with one request's
    logits poisoned (NaN) so that it retires alone."""
    jm, jp, model, params = pair
    prompts = _prompts(6, seed=4)
    budgets = [6, 3, 9, 2, 7, 5] if case != "refill" else [6] * 6
    eos = [-1] * 6
    if case == "eos_and_budget":
        probe = model.reference_decode(params, prompts[2], 9, max_len=48)
        eos[2] = probe[3]
    kw = dict(slots=2, max_len=48, megastep_k=4)
    jeng = JEngine(jm, jp, **kw)
    teng = ServingEngine(model, params, **kw)
    jreqs = [JRequest(uid=i, prompt=p, max_new_tokens=b, eos_id=e)
             for i, (p, b, e) in enumerate(zip(prompts, budgets, eos))]
    treqs = [Request(uid=i, prompt=p, max_new_tokens=b, eos_id=e)
             for i, (p, b, e) in enumerate(zip(prompts, budgets, eos))]
    if case == "nonfinite":
        jeng.inject_logit_poison(jreqs[1])
        real = teng.model.decode_step

        def poisoned(p, tokens, cache, advance_mask=None):
            logits = real(p, tokens, cache, advance_mask)
            rows = torch.tensor([r is not None and r.uid == 1
                                 for r in teng.active])
            return torch.where(rows[:, None], float("nan"), logits)

        monkeypatch.setattr(teng.model, "decode_step", poisoned)
    for jr, tr in zip(jreqs, treqs):
        jeng.submit(jr)
        teng.submit(tr)
    jeng.run()
    teng.run()
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert [r.error for r in treqs] == [r.error for r in jreqs]
    assert teng.stats.steps == jeng.stats.steps
    if case == "eos_and_budget":
        assert treqs[2].output[-1] == eos[2] and len(treqs[2].output) == 4
    if case == "nonfinite":
        assert treqs[1].error == "nonfinite-logits"
        assert teng.stats.poisoned == 1
