"""The port's pipelined engine and ``cancel`` against the JAX engine on
the CPU (tiny deepseek-7b, f32 weights carried by ``bridge.from_jax``;
``_torch_serving.py``).

- Depth 2 and 3 give the depth-1 greedy streams, which are the JAX
  engine's, over dense and paged caches, chunked and stall admission and
  K 1, 4 and 8; at depth 2 the port runs the JAX engine's number of
  megasteps (a freed slot refilled one megastep later, one all-idle
  megastep a queue drain).
- What runs only on the card, held here through the CPU path that
  shares its logic: the host ring hands a megastep another admission
  and block entry than the one in flight, ``reset()`` with a megastep in
  flight leaves none, and a drain never moves a newer occupant's prompt
  cursor or registers its prompt.
- ``cancel`` queued, mid-prefill, mid-decode, with a megastep in flight,
  twice, after completion, and on a slot whose prefix pages are shared:
  the same outcomes as the JAX engine's, streams equal.

Streams are compared exactly (greedy, f32 params).
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest

from _torch_serving import (engines, on_both, pair, prompt,
                            random_requests, reference)
from repro_torch.serving import Request, ServingEngine


def _outputs(reqs):
    return [(r.output, r.done, r.cancelled, r.error) for r in reqs]


# -- depth 2 and 3 against depth 1 and the JAX engine --------------------------
@pytest.mark.parametrize("K", [1, 4, 8])
@pytest.mark.parametrize("admission", ["chunked", "stall"])
@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_pipelined_engine_token_identical(mode, admission, K):
    """Five requests on three slots (slots freed and refilled mid-run):
    the port's streams at depth 1, 2 and 3 are the JAX engine's at depth
    1; at depth 2 both engines run the same number of megasteps, and run()
    leaves nothing in flight."""
    kw = dict(slots=3, megastep_k=K, admission=admission)
    if mode == "paged":
        kw.update(page_size=8)
    seed = {1: 3, 4: 5, 8: 7}[K]

    def serve(eng, req_cls):
        reqs = random_requests(req_cls, seed, 5)
        for r in reqs:
            eng.submit(r)
        eng.run()
        assert eng.in_flight == 0 and not eng.has_work()
        return [r.output for r in reqs], eng.stats.megasteps

    (want, j1), (got, t1) = on_both(serve, depth=1, **kw)
    assert got == want and t1 == j1
    (_, j2), (got2, t2) = on_both(serve, depth=2, **kw)
    assert got2 == want and t2 == j2 >= t1
    _, teng = engines(depth=3, **kw)
    assert serve(teng, Request)[0] == want
    if mode == "paged":
        assert teng.blocks_in_use == 0


def test_pipeline_depth_validated_and_reassignable():
    _, _, model, params = pair()
    with pytest.raises(ValueError, match="pipeline_depth"):
        ServingEngine(model, params, slots=2, max_len=64, pipeline_depth=0)
    eng = ServingEngine(model, params, slots=2, max_len=64, megastep_k=4)
    reqs = [Request(uid=i, prompt=prompt(5, seed=i), max_new_tokens=9)
            for i in range(3)]
    for r in reqs:
        eng.submit(r)
    for depth in (1, 2, 3, 1, 2):    # reassigned between steps
        eng.pipeline_depth = depth
        eng.step()
    eng.run()
    assert [r.output for r in reqs] == [reference(r.prompt, 9) for r in reqs]


# -- the host ring, reset and the drain: the card's logic on the CPU -----------
def test_host_ring_gives_each_megastep_in_flight_its_own_entry():
    """At depth 2 megastep t stages into and copies out to another ring
    entry than megastep t-1, still in flight; at depth 3 the entries in
    flight are distinct. Raising the depth grows the ring and keeps the
    entries it had (their pinned addresses)."""
    _, teng = engines(depth=1, slots=2, megastep_k=4)
    assert len(teng._admit_ring) >= 1
    first = teng._admit_ring[0].data_ptr()
    for depth in (2, 3):
        teng.reset()
        teng.pipeline_depth = depth
        for i in range(4):
            teng.submit(Request(uid=i, prompt=prompt(6, seed=i),
                                max_new_tokens=12))
        entries = []
        while teng.has_work():
            dispatched = teng.stats.megasteps
            teng.step()
            if teng.stats.megasteps > dispatched:
                entries.append(teng._inflight[-1][0])
                live = [e for e, _, _ in teng._inflight]
                assert len(live) == len(set(live)) <= depth - 1
        assert len(entries) > 3
        assert all(a != b for a, b in zip(entries, entries[1:]))
        assert len(teng._admit_ring) == len(teng._block_ring) >= depth
        assert teng._admit_ring[0].data_ptr() == first


def test_staging_leaves_the_entry_in_flight_alone():
    """Staging megastep t+1 (``_empty_admit``) zeroes its own entry, not
    the one megastep t copied in and out of."""
    _, teng = engines(depth=2, slots=2, megastep_k=4)
    teng.submit(Request(uid=0, prompt=prompt(9, seed=1), max_new_tokens=8))
    teng.step()                        # megastep 0 in flight, not drained
    entry = teng._inflight[0][0]
    staged = teng._admit_ring[entry].clone()
    block = teng._block_ring[entry].clone()
    assert staged.any() and block.any()
    teng._fill_slots()
    assert teng._stage != entry
    assert np.array_equal(teng._admit_ring[entry].numpy(), staged.numpy())
    assert np.array_equal(teng._block_ring[entry].numpy(), block.numpy())


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_reset_with_a_megastep_in_flight(mode):
    """reset() waits for and drops the megasteps in flight; the engine
    then serves the same requests to the same streams."""
    kw = dict(slots=2, megastep_k=4, page_size=8 if mode == "paged" else 0)
    _, teng = engines(depth=2, **kw)
    reqs = [Request(uid=i, prompt=prompt(5, seed=i), max_new_tokens=7)
            for i in range(3)]
    for r in reqs:
        teng.submit(r)
    teng.step()
    teng.step()
    assert teng.in_flight == 1
    teng.reset()
    assert teng.in_flight == 0 and not teng._inflight
    assert not teng.has_work() and teng.blocks_in_use == 0
    teng.pipeline_depth = 2
    again = [Request(uid=i, prompt=prompt(5, seed=i), max_new_tokens=7)
             for i in range(3)]
    for r in again:
        teng.submit(r)
    teng.run()
    assert [r.output for r in again] == [reference(r.prompt, 7)
                                         for r in again]


def test_drain_never_registers_a_newer_occupants_prompt():
    """One slot, depth 2, the prefix cache: A (20 prompt tokens) retires
    inside a megastep, B (17 tokens: two pages and one) takes its slot,
    and the next drain is of a megastep whose snapshot still holds A.
    That drain must neither move B's prompt cursor to A's position (B
    would never be refilled past its first chunk) nor register B's
    pages before B wrote them; C, B's prompt again, hits B's pages and
    gets B's stream."""
    _, teng = engines(depth=2, slots=1, megastep_k=4, page_size=8,
                      prefix_cache=True)
    a = Request(uid=0, prompt=prompt(20, seed=1), max_new_tokens=3)
    b = Request(uid=1, prompt=prompt(17, seed=2), max_new_tokens=6)
    c = Request(uid=2, prompt=prompt(17, seed=2), max_new_tokens=6)
    registered, stale = [], []
    register, drain = teng._register_prefix, teng._drain_oldest

    def watched_register(s, p):
        registered.append((teng.active[s].uid, teng._prefill_pos[s]))
        assert np.array_equal(p, teng.active[s].prompt)
        register(s, p)

    def watched_drain():
        occ, now = teng._inflight[0][2][0], teng.active[0]
        before = teng._prefill_pos[0]
        drain()
        if occ is not None and now is not None and occ is not now:
            stale.append((occ.uid, now.uid))
            assert teng._prefill_pos[0] == before
    teng._register_prefix = watched_register
    teng._drain_oldest = watched_drain
    try:
        teng.audit_every_step = True
        for r in (a, b, c):
            teng.submit(r)
        teng.run(max_steps=200)
    finally:
        del teng._register_prefix, teng._drain_oldest
    assert (0, 1) in stale             # the case arose
    assert all(pos >= 17 for uid, pos in registered if uid == 1)
    assert a.done and b.done and c.done
    assert b.output == c.output == reference(b.prompt, 6)
    assert a.output == reference(a.prompt, 3)
    assert teng.stats.prefix_hits == 1


# -- cancel ---------------------------------------------------------------------
@pytest.mark.parametrize("depth", [1, 2])
def test_cancel_queued_request(depth):
    def scenario(eng, req_cls):
        a = req_cls(uid=0, prompt=prompt(6), max_new_tokens=4)
        b = req_cls(uid=1, prompt=prompt(6, seed=1), max_new_tokens=4)
        eng.submit(a)
        eng.submit(b)                  # queued behind a on the one slot
        assert eng.cancel(b)
        assert b.cancelled and b.done and b.output == []
        eng.run()
        return _outputs([a, b]), eng.stats.cancelled

    want, got = on_both(scenario, depth, slots=1, megastep_k=4)
    assert got == want
    assert got[0][0][0] == reference(prompt(6), 4) and got[1] == 1


@pytest.mark.parametrize("depth", [1, 2])
def test_cancel_mid_prefill(depth):
    """A 40-token prompt at K 1: cancelled while it is still being fed;
    the other request is unharmed and a later one takes the freed slot."""
    def scenario(eng, req_cls):
        victim = req_cls(uid=0, prompt=prompt(40, seed=2), max_new_tokens=8)
        other = req_cls(uid=1, prompt=prompt(6, seed=3), max_new_tokens=8)
        eng.submit(victim)
        eng.submit(other)
        eng.step()
        assert not victim.done
        assert eng.cancel(victim)
        assert victim.cancelled and victim.output == []
        eng.run()
        late = req_cls(uid=2, prompt=prompt(6, seed=4), max_new_tokens=6)
        eng.submit(late)
        eng.run()
        return _outputs([victim, other, late])

    want, got = on_both(scenario, depth, slots=2, megastep_k=1)
    assert got == want
    assert got[1][0] == reference(prompt(6, seed=3), 8)
    assert got[2][0] == reference(prompt(6, seed=4), 6)


@pytest.mark.parametrize("depth", [1, 2])
def test_cancel_mid_decode_keeps_partial_output(depth):
    """Cancelled after its first tokens: the partial stream is kept, is
    a prefix of the reference, and no late token of a megastep in flight
    joins it; a second cancel is a no-op."""
    def scenario(eng, req_cls):
        req = req_cls(uid=0, prompt=prompt(6), max_new_tokens=32)
        eng.submit(req)
        eng.step()
        while not req.output and not req.done:
            eng.step()
        got = list(req.output)
        assert 0 < len(got) < 32
        assert eng.cancel(req)
        eng.run()
        assert eng.in_flight == 0 and not eng.has_work()
        assert req.output == got
        assert not eng.cancel(req)
        return _outputs([req]), eng.stats.cancelled

    want, got = on_both(scenario, depth, slots=2, megastep_k=4)
    assert got == want and got[1] == 1
    out = got[0][0][0]
    assert out == reference(prompt(6), 32)[:len(out)]


def test_cancel_idempotent_and_completed_noop():
    def scenario(eng, req_cls):
        victim = req_cls(uid=0, prompt=prompt(6), max_new_tokens=8)
        eng.submit(victim)
        eng.step()
        assert eng.cancel(victim)
        assert not eng.cancel(victim)
        done = req_cls(uid=1, prompt=prompt(6, seed=5), max_new_tokens=4)
        eng.submit(done)
        eng.run()
        assert done.done and not done.cancelled
        assert not eng.cancel(done)
        return _outputs([victim, done]), eng.stats.cancelled

    want, got = on_both(scenario, 2, slots=2, megastep_k=4)
    assert got == want and got[1] == 1


@pytest.mark.parametrize("depth", [1, 2])
def test_cancel_keeps_shared_prefix_blocks_live(depth):
    """Two requests hit the registered pages of a 17-token prompt; one is
    cancelled: the shared blocks keep their references, its private tail
    is recycled, and the other finishes with the reference stream."""
    shared = prompt(17, seed=7)

    def scenario(eng, req_cls):
        eng.audit_every_step = True
        warm = req_cls(uid=0, prompt=shared, max_new_tokens=4)
        eng.submit(warm)
        eng.run()
        reg = set(eng._prefix_reg.values())
        assert reg
        victim = req_cls(uid=1, prompt=shared, max_new_tokens=16)
        keeper = req_cls(uid=2, prompt=shared, max_new_tokens=16)
        eng.submit(victim)
        eng.submit(keeper)
        while not (victim.output and keeper.output):
            eng.step()
        before = eng.blocks_in_use
        assert eng.cancel(victim)
        eng.audit()
        assert all(eng._ref[b] >= 1 for b in reg)
        assert eng.blocks_in_use < before
        eng.run()
        assert eng.blocks_in_use == len(eng._prefix_reg) > 0
        return (_outputs([warm, victim, keeper]), eng.stats.prefix_hits,
                eng.stats.cancelled, eng.blocks_in_use)

    want, got = on_both(scenario, depth, slots=2, megastep_k=4,
                        page_size=8, prefix_cache=True)
    assert got == want
    assert got[0][2][0] == reference(shared, 16) and got[1] >= 2
