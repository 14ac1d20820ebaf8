"""The port's paged KV cache and prefix cache against the JAX package on
the CPU (reduced llama3.2-1b, max_len 64): ``paged_gather``, the paged
RoPE + cache write, a decode step on a paged cache, the paged engine's
streams against the dense engine's, the prefix-cache engine and FIFO
blocking on a short pool against the JAX engine, and the allocator's
invariants (``audit``).

Tolerances:
- Pools and views: bit-equal. The plain write of a frozen row goes to
  the garbage block 0 on both sides (the CUDA kernel writes nothing for
  it), so every block but 0 is compared.
- bf16 K rows: one bf16 ulp at the row's scale (XLA's cos/sin may land
  an f32 ulp from PyTorch's, as in test_torch_fused_ops.py); V rows and
  quantized scales bit-equal; quantized payloads one step on exact .5
  ties (test_torch_quant.py).
- A decode step with f32 params: bit-equal to the port's own dense
  step, and within 2e-5 of the logit scale of the JAX step. Most steps
  read under 1e-6; the dense port against the dense JAX step reads
  1.34e-5 at step 9 of this sequence with a bf16 cache, where one cached
  K element rounds one bf16 ulp apart (XLA's cos/sin lands an f32 ulp
  from PyTorch's), and the paged step has the dense step's bits.
- Engine streams: equal (greedy, f32 params against the JAX engine).
  Every request keeps prompt + max_new within max_len.
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
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.quant.quantize import quantize_rows as jquantize_rows
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch.bridge import from_jax, to_tensor
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import fused_ops, ops
from repro_torch.kernels.decode_attention import (decode_attention_plain,
                                                  paged_gather)
from repro_torch.kernels.decode_attention_quant import (
    decode_attention_quant_plain)
from repro_torch.models import Model
from repro_torch.models.attention import kv_cache_read
from repro_torch.serving import (EngineAuditError, PromptTooLong, Request,
                                 SamplingConfig, ServingEngine)

CPU = torch.device("cpu")
FMTS = ["bf16", "q8_0", "q4_0"]
MAX_LEN = 64


def t(a) -> torch.Tensor:
    return to_tensor(np.asarray(a), CPU)


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _pool(rng, n_blocks, Hkv, P, D, fmt):
    """A pool already holding junk in every block (as a served pool does),
    as JAX arrays."""
    old = jnp.asarray(rng.standard_normal((n_blocks, Hkv, P, D)),
                      jnp.bfloat16)
    if fmt == "bf16":
        return {"k": old, "v": old * 0.5}
    kq, ks = jquantize_rows(old, fmt)
    vq, vs = jquantize_rows(old * 0.5, fmt)
    return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}


def _table(rng, B, max_pages, n_blocks, mapped):
    """A shuffled block table: row b maps its first ``mapped[b]`` pages
    to distinct blocks >= 1, the rest to the garbage block 0."""
    blocks = rng.permutation(np.arange(1, n_blocks))
    table = np.zeros((B, max_pages), np.int32)
    at = 0
    for b, n in enumerate(mapped):
        table[b, :n] = blocks[at:at + n]
        at += n
    return table


# -- paged_gather and the paged cache read -------------------------------------
@pytest.mark.parametrize("fmt", FMTS)
def test_paged_gather_and_read_match_jax(fmt):
    rng = np.random.default_rng(1)
    B, Hkv, P, D, max_pages, n_blocks = 3, 2, 8, 32, 4, 11
    pool = _pool(rng, n_blocks, Hkv, P, D, fmt)
    table = _table(rng, B, max_pages, n_blocks, [4, 1, 3])
    for name, leaf in pool.items():
        want = jattn.paged_gather(leaf, jnp.asarray(table))
        calls = paged_gather.calls
        got = paged_gather(t(leaf), t(table))
        assert paged_gather.calls == calls + 1
        assert got.shape == (B, Hkv, max_pages * P, leaf.shape[-1])
        np.testing.assert_array_equal(f32(got), f32(want))
    jcache = dict(pool, block_table=jnp.asarray(table))
    jk, jv = jattn.kv_cache_read(jcache, kv_quant=fmt)
    tk, tv = kv_cache_read({n: t(a) for n, a in pool.items()},
                           kv_quant=fmt, block_table=t(table))
    np.testing.assert_array_equal(f32(tk), f32(jk))
    np.testing.assert_array_equal(f32(tv), f32(jv))


# -- the paged RoPE + cache write ----------------------------------------------
# (B, Hq, Hkv, P, max_pages, D, lens, advance)
WRITE_CASES = [
    (4, 8, 2, 8, 4, 32, [0, 7, 8, 31], [True, True, True, True]),
    (3, 4, 2, 16, 2, 32, [16, 5, 31], [True, False, True]),
    (2, 4, 4, 32, 2, 64, [33, 70], [False, True]),     # 70 rings to 6
]


def _write_inputs(case, fmt, seed):
    B, Hq, Hkv, P, max_pages, D, lens, advance = case
    rng = np.random.default_rng(seed)
    n_blocks = B * max_pages + 3
    qkv = jnp.asarray(rng.standard_normal((B, (Hq + 2 * Hkv) * D)),
                      jnp.bfloat16)
    pool = _pool(rng, n_blocks, Hkv, P, D, fmt)
    table = _table(rng, B, max_pages, n_blocks, [max_pages] * B)
    return qkv, pool, table


def _unpack(payload: torch.Tensor, fmt: str) -> np.ndarray:
    if fmt == "q8_0":
        return payload.numpy().astype(np.int32)
    lo = (payload.to(torch.int32) << 28) >> 28
    hi = payload.to(torch.int32) >> 4
    return torch.stack([lo, hi], -1).flatten(-2).numpy()


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("case", WRITE_CASES)
def test_paged_rope_cache_write_matches_jax(case, fmt):
    """The port's paged write against JAX ``apply_rope`` + the paged
    branch of ``kv_cache_write`` with its write mask: q within one bf16
    ulp, every block but the garbage block as the JAX pool."""
    B, Hq, Hkv, P, max_pages, D, lens, advance = case
    qkv, pool, table = _write_inputs(case, fmt, seed=P * D + B)
    S = P * max_pages
    pos = jnp.asarray(lens, jnp.int32)
    jq = jlayers.apply_rope(qkv[:, :Hq * D].reshape(B, Hq, D), pos, 1e4)
    jk = jlayers.apply_rope(qkv[:, Hq * D:(Hq + Hkv) * D].reshape(
        B, Hkv, D), pos, 1e4)
    jv = qkv[:, (Hq + Hkv) * D:].reshape(B, Hkv, D)
    want = jattn.kv_cache_write(
        dict(pool, block_table=jnp.asarray(table)), jk, jv, pos % S,
        kv_quant=fmt, group=32, write_mask=jnp.asarray(advance))
    cache = {n: t(a) for n, a in pool.items()}
    before = {n: x.clone() for n, x in cache.items()}
    q = ops.rope_cache_write(t(qkv), cache,
                             torch.tensor(lens, dtype=torch.int32),
                             torch.tensor(advance), 1e4, fmt, t(table))
    tol = 2.0 ** -7 * float(np.abs(f32(jq)).max())
    np.testing.assert_allclose(f32(q), f32(jq), rtol=0, atol=tol)
    written = {(int(table[b, (p % S) // P]), (p % S) % P)
               for b, (p, a) in enumerate(zip(lens, advance)) if a}
    for n, leaf in cache.items():
        for blk in range(1, leaf.shape[0]):
            for row in range(P):
                if (blk, row) not in written:
                    assert torch.equal(leaf[blk, :, row],
                                       before[n][blk, :, row]), (n, blk, row)
    for blk, row in written:
        if fmt == "bf16":
            kr = f32(cache["k"][blk, :, row])
            np.testing.assert_allclose(
                kr, f32(want["k"][blk, :, row]), rtol=0,
                atol=2.0 ** -7 * float(np.abs(kr).max()))
            np.testing.assert_array_equal(f32(cache["v"][blk, :, row]),
                                          f32(want["v"][blk, :, row]))
            continue
        for n in ("k", "v"):
            np.testing.assert_array_equal(
                f32(cache[f"{n}_scale"][blk, :, row]),
                f32(want[f"{n}_scale"][blk, :, row]))
            diff = np.abs(_unpack(cache[n][blk, :, row], fmt)
                          - _unpack(t(want[n][blk, :, row]), fmt))
            assert diff.max() <= 1


@pytest.mark.parametrize("fmt", FMTS)
def test_paged_write_lands_where_the_dense_write_does(fmt):
    """Through the table, the paged write gives the gathered view the
    dense write gives a dense cache holding that view: bit for bit."""
    case = WRITE_CASES[1]
    B, Hq, Hkv, P, max_pages, D, lens, advance = case
    qkv, pool, table = _write_inputs(case, fmt, seed=7)
    paged = {n: t(a) for n, a in pool.items()}
    dense = {n: paged_gather(x, t(table)).contiguous()
             for n, x in paged.items()}
    args = (t(qkv), torch.tensor(lens, dtype=torch.int32),
            torch.tensor(advance), 1e4, fmt)
    qd = fused_ops.rope_cache_write_plain(args[0], dense, *args[1:])
    qp = fused_ops.rope_cache_write_plain(args[0], paged, *args[1:],
                                          block_table=t(table))
    assert torch.equal(qd, qp)
    for n in paged:
        assert torch.equal(paged_gather(paged[n], t(table)), dense[n]), n


@pytest.mark.parametrize("fmt", FMTS)
def test_paged_attention_plain_is_dense_over_the_gather(fmt):
    rng = np.random.default_rng(3)
    B, Hq, Hkv, P, max_pages, D = 3, 4, 2, 8, 4, 32
    pool = {n: t(a) for n, a in
            _pool(rng, 13, Hkv, P, D, fmt).items()}
    table = t(_table(rng, B, max_pages, 13, [4, 2, 3]))
    q = torch.randn(B, Hq, D, generator=torch.Generator().manual_seed(0)
                    ).bfloat16()
    kv_len = torch.tensor([32, 9, 17], dtype=torch.int32)
    view = {n: paged_gather(x, table) for n, x in pool.items()}
    if fmt == "bf16":
        got = ops.decode_attention(q, pool["k"], pool["v"], kv_len,
                                   block_table=table)
        want = decode_attention_plain(q, view["k"], view["v"], kv_len)
    else:
        got = ops.decode_attention_quant(
            q, pool["k"], pool["k_scale"], pool["v"], pool["v_scale"],
            kv_len, fmt=fmt, block_table=table)
        want = decode_attention_quant_plain(
            q, view["k"], view["k_scale"], view["v"], view["v_scale"],
            kv_len, fmt=fmt)
    assert torch.equal(got, want)


def test_paged_wrappers_reject_what_the_kernels_do_not_take():
    """No fallback off the CPU: on another device the paged wrappers
    raise before any launch, and a window or a misaligned page size is
    refused."""
    meta = torch.device("meta")
    q = torch.empty(2, 4, 32, dtype=torch.bfloat16, device=meta)
    pool = torch.empty(9, 2, 8, 32, dtype=torch.bfloat16, device=meta)
    table = torch.zeros(2, 4, dtype=torch.int32, device=meta)
    lens = torch.ones(2, dtype=torch.int32, device=meta)
    launches = ops.decode_attention.launches
    with pytest.raises(ValueError):
        ops.decode_attention(q, pool, pool, lens, block_table=table)
    with pytest.raises(ValueError, match="window"):
        ops.decode_attention(q, pool, pool, lens, window=4,
                             block_table=table)
    pq = torch.empty(9, 2, 4, 32, dtype=torch.int8, device=meta)
    ps = torch.empty(9, 2, 4, 1, dtype=torch.bfloat16, device=meta)
    with pytest.raises(ValueError, match="page size 4"):
        ops.decode_attention_quant(q, pq, ps, pq, ps, lens, fmt="q8_0",
                                   block_table=table)
    assert ops.decode_attention.launches == launches
    qkv = torch.empty(2, 8 * 32, dtype=torch.bfloat16, device=meta)
    rope = ops.rope_cache_write.launches
    with pytest.raises(ValueError):
        ops.rope_cache_write(qkv, {"k": pool, "v": pool}, lens, None, 1e4,
                             "bf16", table)
    with pytest.raises(ValueError):      # a dense-shaped table
        ops.rope_cache_write(qkv, {"k": pool, "v": pool}, lens, None, 1e4,
                             "bf16", table.long())
    assert ops.rope_cache_write.launches == rope


# -- the model on a paged cache -------------------------------------------------
def _pair(kvq, arch="llama3.2-1b"):
    jcfg = dataclasses.replace(jreduced(jget(arch)), kv_quant=kvq,
                               param_dtype="f32")
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(2), quantize=False)
    cfg = dataclasses.replace(reduced(get_config(arch)), kv_quant=kvq,
                              param_dtype="f32")
    model = Model(cfg, device="cpu")
    params = from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jm, jp, model, params


@pytest.mark.parametrize("kvq", FMTS)
def test_decode_step_on_a_paged_cache_matches_jax(kvq):
    """Ten steps with a frozen row now and then, P 8 over max_len 32 and
    a shuffled table: logits bit-equal to the port's own dense step and
    within 2e-5 of the JAX step's scale."""
    jm, jp, model, params = _pair(kvq)
    B, S, P = 2, 32, 8
    jc = jm.init_cache(B, S, page_size=P)
    table = _table(np.random.default_rng(5), B, S // P, B * S // P + 1,
                   [S // P] * B)
    jc["layers"]["block_table"] = jnp.broadcast_to(
        jnp.asarray(table), jc["layers"]["block_table"].shape)
    tc = model.init_cache(B, S, page_size=P)
    assert tc["layers"][0]["k"].shape[:3] == (B * S // P + 1,
                                              model.cfg.num_kv_heads, P)
    tc["block_table"].copy_(t(table))
    dc = model.init_cache(B, S)
    dec = jax.jit(jm.decode_step)
    rng = np.random.default_rng(0)
    for step in range(10):
        toks = rng.integers(1, 512, size=(B, 1)).astype(np.int32)
        adv = np.array([True, step % 3 != 1])
        jl, jc = dec(jp, jnp.asarray(toks), jc, jnp.asarray(adv))
        tt, ta = torch.from_numpy(toks).long(), torch.from_numpy(adv)
        tl = model.decode_step(params, tt, tc, ta)
        dl = model.decode_step(params, tt, dc, ta)
        jl = np.asarray(jl)
        assert torch.equal(tl, dl)
        np.testing.assert_allclose(tl.numpy()[adv], jl[adv], rtol=0,
                                   atol=2e-5 * np.abs(jl[adv]).max())
    assert tc["lens"].tolist() == dc["lens"].tolist() == [10, 7]
    for pl, dl_ in zip(tc["layers"], dc["layers"]):
        for n in dl_:
            view = paged_gather(pl[n], tc["block_table"])
            for b, n_len in enumerate(dc["lens"].tolist()):
                assert torch.equal(view[b, :, :n_len], dl_[n][b, :, :n_len])


def test_prefill_refuses_a_paged_cache():
    model = Model(reduced(get_config("llama3.2-1b")), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="dense"):
        model.prefill(params, torch.ones((1, 4), dtype=torch.long),
                      model.init_cache(1, 16, page_size=8))


# -- the paged engine ------------------------------------------------------------
@pytest.fixture(scope="module")
def small():
    cfg = reduced(get_config("llama3.2-1b"))
    model = Model(cfg, device="cpu")
    return model, model.init(torch.Generator().manual_seed(0))


def _prompts(n, seed=0, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=3 + (7 * i) % 19).astype(np.int32)
            for i in range(n)]


def _serve(engine_cls, request_cls, eng_args, prompts, max_new, *,
           first_alone=False, audit=False):
    """Serve requests of these prompts; with ``first_alone`` the first
    runs to completion before the others are submitted (its pages are
    then registered). Returns (requests, engine)."""
    eng = engine_cls(*eng_args[0], **eng_args[1])
    if audit:
        eng.audit_every_step = True
    reqs = [request_cls(uid=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(zip(prompts, max_new))]
    rest = reqs
    if first_alone:
        eng.submit(reqs[0])
        eng.run()
        rest = reqs[1:]
    for r in rest:
        eng.submit(r)
    eng.run()
    return reqs, eng


_DENSE = {}


@pytest.mark.parametrize("kv", FMTS)
@pytest.mark.parametrize("admission", ["chunked", "stall"])
@pytest.mark.parametrize("K", [1, 4, 8])
@pytest.mark.parametrize("P", [8, 16, 32])
def test_paged_engine_streams_equal_the_dense_engine(small, P, K, admission,
                                                     kv):
    """Seven requests of 3-21 prompt tokens on three slots, budgets 5-12
    (slots freed and refilled mid-run): the paged engine's greedy
    streams are the dense engine's, and once drained it holds no block."""
    model, params = small
    prompts = _prompts(7)
    max_new = [5 + (3 * i) % 8 for i in range(7)]
    kw = dict(slots=3, max_len=MAX_LEN, megastep_k=K, kv_quant=kv,
              admission=admission)
    key = (K, admission, kv)
    if key not in _DENSE:
        _DENSE[key] = [r.output for r in _serve(
            ServingEngine, Request, ((model, params), kw), prompts,
            max_new)[0]]
    reqs, eng = _serve(ServingEngine, Request,
                       ((model, params), dict(kw, page_size=P)), prompts,
                       max_new, audit=True)
    assert [r.output for r in reqs] == _DENSE[key]
    assert eng.paged and eng.max_pages == MAX_LEN // P
    assert eng.blocks_in_use == 0
    assert eng.stats.blocks_recycled == sum(
        -(-min(len(p) + m, MAX_LEN) // P) for p, m in zip(prompts, max_new))


def _system_prompt_traffic(seed=3, n_tail=6, system=20):
    """A system prompt shared by all but the last request, tails of 1-11
    tokens, and an unrelated prompt; prefix + tail + max_new <= 64."""
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(1, 512, system).astype(np.int32)
    prompts = [np.concatenate([sys_p, rng.integers(
        1, 512, 1 + (5 * i) % 11).astype(np.int32)]) for i in range(n_tail)]
    prompts.append(rng.integers(1, 512, 6).astype(np.int32))
    return prompts


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("P", [8, 16])
def test_prefix_cache_engine_matches_jax(P, K):
    """The first request runs alone and registers its pages; the others
    hit. Streams, prefix hits, hit tokens and recycled blocks equal the
    JAX prefix-cache engine's; the registry holds the blocks in use once
    drained."""
    jm, jp, model, params = _pair("bf16")
    prompts = _system_prompt_traffic()
    max_new = [8] * len(prompts)
    kw = dict(slots=2, max_len=MAX_LEN, megastep_k=K, page_size=P,
              prefix_cache=True)
    jreqs, jeng = _serve(JEngine, JRequest, ((jm, jp), kw), prompts,
                         max_new, first_alone=True)
    treqs, teng = _serve(ServingEngine, Request, ((model, params), kw),
                         prompts, max_new, first_alone=True, audit=True)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    for stat in ("prefix_hits", "prefix_hit_tokens", "blocks_recycled",
                 "steps"):
        assert getattr(teng.stats, stat) == getattr(jeng.stats, stat), stat
    hits = len(prompts) - 2
    assert teng.stats.prefix_hits == hits
    assert teng.stats.prefix_hit_tokens == hits * (20 // P) * P
    assert teng.blocks_in_use == len(teng._prefix_reg) > 0
    # the hit streams are the dense engine's
    dense, _ = _serve(ServingEngine, Request,
                      ((model, params), dict(slots=2, max_len=MAX_LEN,
                                             megastep_k=K)),
                      prompts, max_new, first_alone=True)
    assert [r.output for r in treqs] == [r.output for r in dense]


def test_prefix_hit_pins_its_shared_blocks_before_evicting():
    """A known difference from the JAX engine, pinned: the port takes a
    reference on a prefix hit's shared blocks before it evicts registry
    entries for the rest of the request, so an eviction cannot recycle
    one of the hit's own pages. On the tiny pair with 5 usable blocks of
    8: a 17-token prompt on a 16-token system prompt registers its two
    pages, an unrelated 9-token prompt runs beside it, and a second
    17-token prompt on the same system prompt then needs the registry's
    LRU entries evicted for its 3 pages. The JAX engine's
    ``_admit_paged`` raises KeyError there (its ``move_to_end`` meets a
    key the eviction just removed); the port serves the stream of
    ``reference_decode`` with one 16-token hit, and ``audit()`` holds
    after every step."""
    from _torch_serving import pair, reference
    _, _, model, params = pair()
    rng = np.random.default_rng(0)
    system = rng.integers(1, 256, 16).astype(np.int32)
    first = np.concatenate([system, rng.integers(1, 256, 1).astype(np.int32)])
    other = rng.integers(1, 256, 9).astype(np.int32)
    again = np.concatenate([system, rng.integers(1, 256, 1).astype(np.int32)])
    eng = ServingEngine(model, params, slots=2, max_len=64, page_size=8,
                        cache_blocks=6, prefix_cache=True)
    eng.audit_every_step = True
    reqs = [Request(uid=0, prompt=first, max_new_tokens=8),
            Request(uid=1, prompt=other, max_new_tokens=8)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert eng.stats.prefix_hits == 0 and len(eng._prefix_reg) >= 2
    last = Request(uid=2, prompt=again, max_new_tokens=16)
    eng.submit(last)
    eng.run()
    assert eng.stats.prefix_hits == 1 and eng.stats.prefix_hit_tokens == 16
    for r in reqs + [last]:
        assert r.done and r.output == reference(r.prompt, r.max_new_tokens)
    eng.audit()
    assert eng.blocks_in_use == len(eng._prefix_reg)


@pytest.mark.parametrize("admission", ["chunked", "stall"])
def test_short_pool_blocks_fifo_like_jax(admission):
    """A pool of 9 blocks (P 8) for requests of 3-6 pages on 3 slots:
    admissions block at the head of the queue, in the JAX engine's
    order, with the same streams and steps; under chunked admission with
    the prefix cache the registry evicts LRU entries to make room."""
    jm, jp, model, params = _pair("bf16")
    prefix = admission == "chunked"
    prompts = _system_prompt_traffic(seed=4)
    max_new = [10, 20, 6, 14, 9, 12, 7]
    kw = dict(slots=3, max_len=MAX_LEN, megastep_k=4, page_size=8,
              cache_blocks=9, prefix_cache=prefix, admission=admission)
    order = {}

    def track(eng, name):
        fill = eng._fill_slots
        log = order.setdefault(name, [])

        def logged(*a):
            out = fill(*a)
            log.append([None if r is None else r.uid for r in eng.active])
            return out
        eng._fill_slots = logged
        return eng

    jeng = track(JEngine(jm, jp, **kw), "jax")
    teng = track(ServingEngine(model, params, **kw), "port")
    teng.audit_every_step = True
    jreqs = [JRequest(uid=i, prompt=p, max_new_tokens=m)
             for i, (p, m) in enumerate(zip(prompts, max_new))]
    treqs = [Request(uid=i, prompt=p, max_new_tokens=m)
             for i, (p, m) in enumerate(zip(prompts, max_new))]
    for jr, tr in zip(jreqs, treqs):
        jeng.submit(jr)
        teng.submit(tr)
    jeng.run()
    teng.run()
    assert order["port"] == order["jax"]
    assert any(None in occ for occ in order["port"][:3])   # a slot waited
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert teng.stats.steps == jeng.stats.steps
    assert teng.stats.blocks_recycled == jeng.stats.blocks_recycled
    assert teng.blocks_in_use == len(teng._prefix_reg)


# -- the allocator ----------------------------------------------------------------
def _mid_run(small, **kw):
    model, params = small
    eng = ServingEngine(model, params, slots=2, max_len=MAX_LEN,
                        megastep_k=4, page_size=8, prefix_cache=True, **kw)
    for i, p in enumerate(_system_prompt_traffic(n_tail=3)):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=12))
    for _ in range(3):
        eng.step()
    eng.audit()
    return eng


@pytest.mark.parametrize("fault", ["refcount", "double_owner", "block_0",
                                   "empty_slot", "done_active",
                                   "quarantined_and_free"])
def test_audit_catches_a_broken_invariant(small, fault):
    eng = _mid_run(small)
    s = next(i for i, b in enumerate(eng._slot_blocks) if b)
    blk = eng._slot_blocks[s][-1]
    if fault == "refcount":
        eng._ref[blk] += 1
    elif fault == "double_owner":
        eng._free.append(blk)
    elif fault == "block_0":
        eng._slot_blocks[s][0] = 0
    elif fault == "empty_slot":
        eng.active[s] = None
    elif fault == "done_active":
        eng.active[s].done = True
    else:
        assert eng.quarantine_blocks(2) == 2
        eng.audit()
        eng._free.append(eng._quarantined[0])
    with pytest.raises(EngineAuditError):
        eng.audit()


def test_quarantine_is_an_audited_owner_class(small):
    eng = _mid_run(small)
    free = len(eng._free)
    in_use = eng.blocks_in_use
    assert eng.quarantine_blocks(free + 5) == free
    assert eng.blocks_in_use == in_use + free and not eng._free
    eng.audit()
    eng.run()                        # admissions wait for the blocks
    eng.audit()
    assert eng.release_quarantined(2) == 2
    assert eng.release_quarantined() == free - 2
    eng.audit()
    eng.run()
    eng.audit()
    assert not eng.has_work()
    assert eng.blocks_in_use == len(eng._prefix_reg)


def test_paged_prompt_too_long(small):
    model, params = small
    eng = ServingEngine(model, params, slots=2, max_len=MAX_LEN,
                        page_size=8, cache_blocks=5)
    with pytest.raises(PromptTooLong, match="pages"):
        eng.submit(Request(uid=0, prompt=np.ones(30, np.int32),
                           max_new_tokens=3))        # 5 pages, pool of 4
    eng.submit(Request(uid=1, prompt=np.ones(28, np.int32),
                       max_new_tokens=4))            # 4 pages fit
    # a chunked prompt past the cache rings over its own pages
    big = ServingEngine(model, params, slots=1, max_len=16, page_size=8)
    big.audit_every_step = True
    r = Request(uid=2, prompt=np.arange(1, 21, dtype=np.int32),
                max_new_tokens=3)
    big.submit(r)
    big.run()
    assert r.done and len(r.output) == 3 and big.blocks_in_use == 0
    # so does a stall prompt past the cache, prefilled into the scratch
    # cache's ring and spliced into the slot's pages, as the JAX engine
    # serves it
    stall = ServingEngine(model, params, slots=1, max_len=16, page_size=8,
                          admission="stall")
    stall.audit_every_step = True
    r = Request(uid=3, prompt=np.arange(1, 21, dtype=np.int32),
                max_new_tokens=3)
    stall.submit(r)
    stall.run()
    assert r.done and r.output == model.reference_decode(
        params, r.prompt, 3, max_len=16, stepwise_prefill=False)
    assert stall.blocks_in_use == 0


@pytest.mark.parametrize("kv", FMTS)
def test_cache_nbytes_counts_the_pools(small, kv):
    model, params = small
    dense = ServingEngine(model, params, slots=4, max_len=MAX_LEN,
                          kv_quant=kv)
    full = ServingEngine(model, params, slots=4, max_len=MAX_LEN,
                         kv_quant=kv, page_size=16)
    small_pool = ServingEngine(model, params, slots=4, max_len=MAX_LEN,
                               kv_quant=kv, page_size=16, cache_blocks=6)
    for eng in (dense, full, small_pool):
        leaves = [eng.cache["lens"]] + [
            x for layer in eng.cache["layers"] for x in layer.values()]
        if eng.paged:
            leaves.append(eng.cache["block_table"])
        assert eng.cache_nbytes() == sum(x.numel() * x.element_size()
                                         for x in leaves)
    assert full.cache_blocks == 4 * MAX_LEN // 16 + 1
    assert small_pool.cache_nbytes() < dense.cache_nbytes()


def test_paged_engine_arguments(small):
    model, params = small
    with pytest.raises(ValueError, match="divide"):
        ServingEngine(model, params, max_len=MAX_LEN, page_size=24)
    with pytest.raises(ValueError, match="cache_blocks"):
        ServingEngine(model, params, max_len=MAX_LEN, page_size=8,
                      cache_blocks=1)
    with pytest.raises(ValueError, match="page_size"):
        ServingEngine(model, params, max_len=MAX_LEN, page_size=-8)
    for kw in (dict(), dict(page_size=8, admission="stall")):
        with pytest.warns(RuntimeWarning, match="prefix_cache"):
            eng = ServingEngine(model, params, max_len=MAX_LEN,
                                prefix_cache=True, **kw)
        assert not eng.prefix_cache
    dense = ServingEngine(model, params, max_len=MAX_LEN)
    assert not dense.paged and dense.blocks_in_use == 0
    assert dense.quarantine_blocks(3) == 0
    dense.audit()


def test_stochastic_paged_engine_matches_dense(small):
    """Sampled rows draw the same numbers through a paged cache."""
    model, params = small
    kw = dict(slots=3, max_len=MAX_LEN, megastep_k=4, seed=5,
              sampling=SamplingConfig(temperature=0.8, top_k=40))
    prompts = _prompts(5, seed=2)
    dense, _ = _serve(ServingEngine, Request, ((model, params), kw),
                      prompts, [9] * 5)
    paged, _ = _serve(ServingEngine, Request,
                      ((model, params), dict(kw, page_size=16)), prompts,
                      [9] * 5)
    assert [r.output for r in paged] == [r.output for r in dense]
