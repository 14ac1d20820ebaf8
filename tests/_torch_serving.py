"""Shared set-up of the port's serving tests under load
(test_torch_pipeline.py, test_torch_overload.py, test_torch_frontend.py):
the tiny deepseek-7b of the JAX package's own serving suites (d_model 64,
two heads, one KV head, vocabulary 256) with f32 params, drawn by JAX and
carried into the port by ``bridge.from_jax``. Under f32 params the two
models' logits agree to ~1e-6 (test_torch_model.py), so greedy streams
are compared exactly.

Engines are cached per configuration and ``reset()`` on every use, as
the JAX suites do: a JAX engine keeps its compiled megastep across a
reset, which is most of its cost here.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import jax
import numpy as np

from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models import Model as JModel
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch.bridge import from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.models import Model
from repro_torch.serving import Request, ServingEngine

MAX_LEN = 64
TINY = dict(d_model=64, d_ff=128, vocab_size=256, num_heads=2,
            num_kv_heads=1)

_MODELS = {}
_ENGINES = {}


def pair():
    """(JAX model, JAX params, port model, port params), the same f32
    weights on both sides."""
    if "pair" not in _MODELS:
        jcfg = dataclasses.replace(jreduced(jget("deepseek-7b"), **TINY),
                                   param_dtype="f32")
        jm = JModel(jcfg)
        jp = jm.init(jax.random.PRNGKey(0), quantize=False)
        cfg = dataclasses.replace(reduced(get_config("deepseek-7b"), **TINY),
                                  param_dtype="f32")
        model = Model(cfg, device="cpu")
        params = from_jax(jax.tree_util.tree_map(np.asarray, jp),
                          device="cpu")
        _MODELS["pair"] = (jm, jp, model, params)
    return _MODELS["pair"]


def engines(depth=1, **kw):
    """(JAX engine, port engine) of one configuration, reset, both at
    ``pipeline_depth`` ``depth``. The JAX engine is built with its
    default donation (at depth 1), which depth 2 only slows on its CPU
    backend."""
    key = tuple(sorted(kw.items()))
    if key not in _ENGINES:
        jm, jp, model, params = pair()
        kw = dict(dict(slots=2, max_len=MAX_LEN), **kw)
        _ENGINES[key] = (JEngine(jm, jp, **kw),
                         ServingEngine(model, params, **kw))
    jeng, teng = _ENGINES[key]
    for e in (jeng, teng):
        e.reset()
        e.pipeline_depth = depth
        e.audit_every_step = False
    return jeng, teng


def on_both(scenario, depth=1, **kw):
    """``scenario(engine, request_class)`` run on the JAX engine and on
    the port's of one configuration; returns (JAX result, port result)."""
    jeng, teng = engines(depth, **kw)
    return scenario(jeng, JRequest), scenario(teng, Request)


def random_requests(req_cls, seed, n, max_prompt=14, max_new=12):
    """n requests of 2..max_prompt-1 seeded prompt tokens and budgets of
    1..max_new-1 (the JAX chaos suite's draw)."""
    rng = np.random.default_rng(seed)
    return [req_cls(uid=i, prompt=rng.integers(
        1, TINY["vocab_size"], size=int(rng.integers(2, max_prompt))
    ).astype(np.int32), max_new_tokens=int(rng.integers(1, max_new)))
        for i in range(n)]


def reference(prompt, max_new):
    """The port's ``Model.reference_decode`` (one request alone)."""
    _, _, model, params = pair()
    return model.reference_decode(params, prompt, max_new, max_len=MAX_LEN)


def prompt(n=6, seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    return rng.integers(1, vocab, size=n).astype(np.int32)
