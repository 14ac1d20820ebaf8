"""The port's overload and fault handling against the JAX engine on the
CPU (tiny deepseek-7b, f32 weights carried by ``bridge.from_jax``;
``_torch_serving.py``): the typed rejects of ``submit``, the EDF queue,
preemption with resume under chunked and stall admission, the poison
row, the allocator audit, the fault injector, and seeded fault schedules
(``chaos``) replayed through both engines' injectors.

Streams are compared exactly (greedy, f32 params): with the JAX engine's
under every schedule, and with ``reference_decode`` wherever a request
was neither poisoned nor cancelled. A poisoned request's output is a
prefix of its reference stream.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import asyncio

import numpy as np
import pytest

from _torch_serving import (engines, on_both, pair, random_requests,
                            reference)
from repro.serving import FaultEvent as JFaultEvent
from repro.serving import FaultInjector as JFaultInjector
from repro.serving import FaultSchedule as JFaultSchedule
from repro.serving import Request as JRequest
from repro_torch.launch.serve import (AsyncServingFrontend, Backpressure,
                                      RequestFailed, build_parser)
from repro_torch.serving import (EngineAuditError, FaultEvent, FaultInjector,
                                 FaultSchedule, InfeasibleDeadline,
                                 PromptTooLong, QueueFull, Request,
                                 ServingEngine, SubmitReject,
                                 TransientStepFault)

PAGED9 = dict(slots=2, megastep_k=4, page_size=8, cache_blocks=9)


def _req(req_cls, uid, n_prompt=6, max_new=6, **kw):
    return req_cls(uid=uid, prompt=(np.arange(n_prompt, dtype=np.int32)
                                    % 200) + 1 + uid,
                   max_new_tokens=max_new, **kw)


def _outcome(reqs):
    return [(r.output, r.done, r.cancelled, r.error, r.preemptions)
            for r in reqs]


# -- typed rejects ---------------------------------------------------------------
def test_prompt_too_long_is_a_typed_reject():
    """Dense: a prompt past the cache is a ``PromptTooLong``, a
    ``SubmitReject`` and still a ``ValueError``; a prompt of exactly the
    cache's length is legal. Paged: more pages than the pool holds."""
    _, teng = engines(slots=2, max_len=32)
    with pytest.raises(PromptTooLong) as ei:
        teng.submit(_req(Request, 0, n_prompt=40))
    assert isinstance(ei.value, SubmitReject)
    assert isinstance(ei.value, ValueError)
    assert ei.value.reason == "prompt_too_long" and ei.value.uid == 0
    teng.submit(_req(Request, 1, n_prompt=32, max_new=4))
    assert len(teng.queue) == 1
    _, teng = engines(slots=2, page_size=8, cache_blocks=5)
    with pytest.raises(PromptTooLong):
        teng.submit(_req(Request, 0, n_prompt=30, max_new=10))


def test_queue_full_sheds_with_a_retry_hint():
    """At the bound the submit is shed (``QueueFull``, depth, no hint
    before a measured step); after a run the hint comes from the measured
    substep time, as in the JAX engine."""
    def scenario(eng, req_cls):
        eng.submit(_req(req_cls, 0))
        eng.submit(_req(req_cls, 1))
        # each package raises its own QueueFull: caught by the base class
        with pytest.raises(ValueError) as ei:
            eng.submit(_req(req_cls, 2))
        first = (ei.value.reason, ei.value.queue_depth,
                 ei.value.retry_after_s, eng.stats.shed)
        eng.run()
        eng.submit(_req(req_cls, 3))
        eng.submit(_req(req_cls, 4))
        with pytest.raises(ValueError, match="queue") as ei:
            eng.submit(_req(req_cls, 5))
        hint = ei.value.retry_after_s
        sub = eng.stats.decode_wall_s / eng.stats.steps
        # two queued requests of 6 + 6 substeps over one slot
        assert hint == pytest.approx(sub * 24)
        return first, eng.stats.shed

    want, got = on_both(scenario, slots=1, max_len=32, max_queue=2)
    assert got == want == (("queue_full", 2, None, 1), 2)
    _, teng = engines(slots=1, max_len=32, max_queue=1)
    teng.submit(_req(Request, 0))
    with pytest.raises(QueueFull):
        teng.submit(_req(Request, 1))


def test_infeasible_deadline_sheds():
    """A deadline of 0 is shed at once; one below the measured time of a
    substep, once a run has measured it."""
    _, teng = engines(slots=1, max_len=32, max_queue=2)
    with pytest.raises(InfeasibleDeadline):
        teng.submit(_req(Request, 0, deadline_s=-1.0))

    def scenario(eng, req_cls):
        with pytest.raises(ValueError) as ei:
            eng.submit(_req(req_cls, 0, deadline_s=0.0))
        assert ei.value.reason == "infeasible_deadline"
        r = _req(req_cls, 1, deadline_s=60.0)
        eng.submit(r)
        eng.run()
        # below one measured substep now
        sub = eng.stats.decode_wall_s / eng.stats.steps
        with pytest.raises(ValueError) as ei:
            eng.submit(_req(req_cls, 2, deadline_s=sub / 2))
        return r.output, eng.stats.shed, type(ei.value).__name__

    want, got = on_both(scenario, slots=1, max_len=32, max_queue=2)
    assert got == want and len(got[0]) == 6
    assert got[1:] == (2, "InfeasibleDeadline")


def test_edf_queue_ordering():
    """Deadline requests drain earliest first; requests without one stay
    FIFO behind them."""
    def scenario(eng, req_cls):
        for r in (_req(req_cls, 0), _req(req_cls, 1, deadline_s=60.0),
                  _req(req_cls, 2, deadline_s=5.0), _req(req_cls, 3),
                  _req(req_cls, 4, deadline_s=30.0)):
            eng.submit(r)
        order = [r.uid for r in eng.queue]
        eng.run()
        return order

    want, got = on_both(scenario, slots=2, max_len=32)
    assert got == want == [2, 4, 1, 0, 3]


def test_max_queue_validated():
    _, _, model, params = pair()
    with pytest.raises(ValueError, match="max_queue"):
        ServingEngine(model, params, slots=2, max_len=32, max_queue=-1)


# -- preemption and resume -------------------------------------------------------
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("admission", ["chunked", "stall"])
def test_preempt_resume_token_identical(admission, depth):
    """A request preempted after some decode progress is requeued, resumes
    from its prompt and the k tokens it had, and ends with the JAX
    engine's stream; nothing leaks. Under chunked admission the resume
    feeds the k tokens through the decode step: the stream is the
    uninterrupted reference. Under stall admission it prefills them: the
    tokens after the resume are the fused-prefill reference of the prompt
    and the k tokens."""
    def scenario(eng, req_cls):
        r = _req(req_cls, 0, n_prompt=8, max_new=12)
        eng.submit(r)
        while not r.output:
            eng.step()
        assert len(r.output) < 12
        assert eng.preempt(r)
        assert r.preemptions == 1 and any(q is r for q in eng.queue)
        eng.audit()
        resumed_at = []
        eff_prompt = eng._eff_prompt

        def logged(req):
            resumed_at.append(len(req.output))
            return eff_prompt(req)
        eng._eff_prompt = logged
        try:
            eng.run()
        finally:
            del eng._eff_prompt
        eng.audit()
        return (_outcome([r]), eng.stats.preemptions, eng.blocks_in_use,
                max(resumed_at))

    want, got = on_both(scenario, depth, admission=admission, **PAGED9)
    assert got == want and got[1:3] == (1, 0)
    out, k = got[0][0][0], got[3]
    prompt = _req(Request, 0, 8).prompt
    assert 0 < k < 12
    if admission == "chunked":
        assert out == reference(prompt, 12)
    else:
        _, _, model, params = pair()
        assert out[:k] == model.reference_decode(
            params, prompt, k, max_len=64, stepwise_prefill=False)
        assert out[k:] == model.reference_decode(
            params, np.concatenate([prompt, np.asarray(out[:k], np.int32)]),
            12 - k, max_len=64, stepwise_prefill=False)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("depth", [1, 2])
def test_stall_resume_past_max_len_matches_jax(depth, paged):
    """A stall-admission resume whose prompt and generated tokens (73)
    outgrow the cache (64): the resumed prompt is prefilled at its exact
    length through the ring write (the scratch cache's ring spliced into
    the slot's 8 pages when paged) and the stream ends as the JAX
    engine's. It used to raise at the prefill bucket's copy."""
    def scenario(eng, req_cls):
        r = req_cls(uid=0, prompt=np.random.default_rng(5).integers(
            1, 256, 40).astype(np.int32), max_new_tokens=40)
        eng.submit(r)
        while len(r.output) < 33:
            eng.step()
        assert eng.preempt(r)
        eng.audit()
        eng.run()
        eng.audit()
        return r.output, r.preemptions, eng.blocks_in_use

    kw = dict(PAGED9) if paged else dict(slots=2, megastep_k=4)
    want, got = on_both(scenario, depth, admission="stall", **kw)
    assert got == want and len(got[0]) == 40 and got[1:] == (1, 0)
    if depth == 1:
        assert got[0][-5:] == [99, 159, 205, 10, 31]


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("admission", ["chunked", "stall"])
def test_pool_starved_admission_preempts_a_later_deadline_victim(admission,
                                                                 depth):
    """With six of eight blocks quarantined only one request fits: an
    earlier-deadline arrival preempts the later-deadline occupant, which
    resumes once the blocks return; both streams are the JAX engine's."""
    def scenario(eng, req_cls):
        victim = _req(req_cls, 0, n_prompt=8, max_new=8, deadline_s=120.0)
        urgent = _req(req_cls, 1, n_prompt=8, max_new=8, deadline_s=30.0)
        eng.submit(victim)
        eng.step()
        assert eng.quarantine_blocks(6) == 6
        eng.submit(urgent)
        eng.step()
        eng.audit()
        assert victim.preemptions == 1
        eng.release_quarantined()
        eng.run()
        eng.audit()
        return _outcome([victim, urgent]), eng.blocks_in_use

    want, got = on_both(scenario, depth, admission=admission, **PAGED9)
    assert got == want and got[1] == 0
    if admission == "chunked":
        for uid in (0, 1):
            r = _req(Request, uid, 8)
            assert got[0][uid][0] == reference(r.prompt, 8)


def test_fifo_overload_blocks_instead_of_preempting():
    """Requests without deadlines never preempt: the later one waits."""
    def scenario(eng, req_cls):
        eng.quarantine_blocks(6)
        a = _req(req_cls, 0, n_prompt=8, max_new=8)
        b = _req(req_cls, 1, n_prompt=8, max_new=8)
        eng.submit(a)
        eng.submit(b)
        eng.step()
        assert any(q is b for q in eng.queue)
        eng.release_quarantined()
        eng.run()
        return _outcome([a, b]), eng.stats.preemptions

    want, got = on_both(scenario, **PAGED9)
    assert got == want and got[1] == 0


@pytest.mark.parametrize("depth", [1, 2])
def test_cancel_and_preempt_orderings_release_once(depth):
    """Cancel after a preemption takes the queue path (the blocks were
    released already); preempt after a cancel refuses. The audit holds
    throughout."""
    def scenario(eng, req_cls):
        r = _req(req_cls, 0, n_prompt=8, max_new=8)
        eng.submit(r)
        eng.step()
        assert eng.preempt(r)
        eng.audit()
        used = eng.blocks_in_use
        assert eng.cancel(r) is True
        eng.audit()
        assert eng.blocks_in_use == used and r.cancelled
        assert not any(q is r for q in eng.queue)
        s = _req(req_cls, 1, n_prompt=8, max_new=8)
        eng.submit(s)
        eng.step()
        assert eng.cancel(s) is True
        assert eng.preempt(s) is False
        eng.audit()
        eng.run()
        eng.audit()
        return _outcome([r, s]), eng.stats.preemptions, eng.blocks_in_use

    want, got = on_both(scenario, depth, **PAGED9)
    assert got == want and got[1:] == (1, 0)


# -- the poison row --------------------------------------------------------------
@pytest.mark.parametrize("depth", [1, 2])
def test_poisoned_request_is_isolated(depth):
    """Poisoned before its admission: it ends with "nonfinite-logits"
    and no token, its neighbour keeps the reference stream, and the next
    request is served normally."""
    def scenario(eng, req_cls):
        good = _req(req_cls, 0, n_prompt=6, max_new=8)
        bad = _req(req_cls, 7, n_prompt=5, max_new=8)
        eng.submit(good)
        eng.submit(bad)
        eng.inject_logit_poison(bad)
        eng.run()
        nxt = _req(req_cls, 20, n_prompt=6, max_new=8)
        eng.submit(nxt)
        eng.run()
        return _outcome([good, bad, nxt]), eng.stats.poisoned

    want, got = on_both(scenario, depth, slots=2, megastep_k=4)
    assert got == want and got[1] == 1
    outs = got[0]
    assert outs[1][3] == "nonfinite-logits" and outs[1][0] == []
    assert outs[0][0] == reference(_req(Request, 0).prompt, 8)
    assert outs[2][0] == reference(_req(Request, 20).prompt, 8)


@pytest.mark.parametrize("depth", [1, 2])
def test_poison_mid_stream_keeps_a_clean_prefix(depth):
    def scenario(eng, req_cls):
        r = _req(req_cls, 0, n_prompt=6, max_new=12)
        eng.submit(r)
        eng.step()
        eng.inject_logit_poison(r)
        eng.run()
        return _outcome([r])

    want, got = on_both(scenario, depth, slots=2, megastep_k=4)
    assert got == want
    out, _, _, err, _ = got[0]
    assert err == "nonfinite-logits" and len(out) < 12
    assert out == reference(_req(Request, 0).prompt, 12)[:len(out)]


def test_poison_row_rides_the_admission_buffer():
    """The poison is a row of the packed admission buffer, set for the
    slot the request holds, and read by the megastep body on the device
    (the card's graph turns the logits to NaN itself)."""
    _, teng = engines(slots=2, megastep_k=4)
    a, b = _req(Request, 0), _req(Request, 1)
    teng.submit(a)
    teng.submit(b)
    teng.step()
    teng.inject_logit_poison(b)
    admit = teng._fill_slots()
    slot = teng.active.index(b)
    assert list(admit["poison"]) == [int(s == slot) for s in range(2)]
    teng._admit_dev.copy_(teng._admit_host)
    assert teng._admit["poison"].tolist() == list(admit["poison"])


# -- audit and quarantine --------------------------------------------------------
@pytest.mark.parametrize("fault", ["refcount", "double_owner"])
def test_audit_catches_corruption(fault):
    _, teng = engines(**PAGED9)
    teng.submit(_req(Request, 0, n_prompt=8, max_new=8))
    teng.step()
    teng.audit()
    blk = teng._slot_blocks[0][0]
    if fault == "refcount":
        teng._ref[blk] += 1
    else:
        teng._free.append(blk)
    with pytest.raises(EngineAuditError):
        teng.audit()
    if fault == "refcount":
        teng._ref[blk] -= 1
    else:
        teng._free.remove(blk)
    teng.audit()
    teng.run()


def test_quarantine_is_an_audited_owner_class():
    _, teng = engines(**PAGED9)
    assert teng.quarantine_blocks(3) == 3
    teng.audit()
    assert teng.release_quarantined(1) == 1
    teng.audit()
    assert teng.release_quarantined() == 2
    teng.audit()
    assert len(teng._free) == 8


# -- the fault injector ----------------------------------------------------------
def test_transient_fault_retries_and_recovers():
    _, teng = engines(slots=2, megastep_k=4)
    r = _req(Request, 0, n_prompt=6, max_new=8)
    teng.submit(r)
    naps = []
    inj = FaultInjector(
        teng, FaultSchedule([FaultEvent(0, "step_exception", fires=2)]),
        max_retries=3, backoff_s=0.001, sleep=naps.append)
    inj.run([r])
    assert r.done and r.output == reference(r.prompt, 8)
    assert inj.retries == 2 and naps == [0.001, 0.002]


def test_transient_fault_exhausts_retries():
    _, teng = engines(slots=2, megastep_k=4)
    r = _req(Request, 0)
    teng.submit(r)
    inj = FaultInjector(
        teng, FaultSchedule([FaultEvent(0, "step_exception", fires=9)]),
        max_retries=2, backoff_s=0.0, sleep=lambda s: None)
    with pytest.raises(TransientStepFault):
        inj.run([r])
    assert inj.retries == 2
    assert not teng._quarantined


@pytest.mark.parametrize("seed,n,paged", [(42, 4, True), (43, 4, True),
                                          (7, 3, False), (2024, 5, True)])
def test_seeded_schedule_is_the_jax_packages(seed, n, paged):
    """The same seed draws the same storm as the JAX package's
    ``FaultSchedule.seeded``, and again the same on a second draw."""
    ours = FaultSchedule.seeded(seed, n_requests=n, paged=paged)
    theirs = JFaultSchedule.seeded(seed, n_requests=n, paged=paged)
    fields = ("step", "kind", "ridx", "blocks", "duration", "stall_s",
              "fires")
    assert [tuple(getattr(e, f) for f in fields) for e in ours.events] == \
        [tuple(getattr(e, f) for f in fields) for e in theirs.events]
    assert ours.events == FaultSchedule.seeded(seed, n_requests=n,
                                               paged=paged).events
    assert ours.poisoned_ridx == theirs.poisoned_ridx
    if not paged:
        assert all(e.kind != "exhaust_pool" for e in ours.events)
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultEvent(0, "meteor")


# -- the front-end surfaces sheds and failures -----------------------------------
def test_frontend_backpressure_carries_a_retry_hint():
    _, teng = engines(slots=1, max_len=32, max_queue=1, megastep_k=4)

    async def drive():
        fe = AsyncServingFrontend(teng, max_pending=8, drain_hint_s=0.25)
        p = np.asarray([1, 2, 3], np.int32)
        tasks = [asyncio.ensure_future(fe.generate(p, max_new_tokens=4))
                 for _ in range(3)]
        out = await asyncio.gather(*tasks, return_exceptions=True)
        await fe.close()
        return out

    out = asyncio.run(drive())
    shed = [e for e in out if isinstance(e, Backpressure)]
    done = [t for t in out if isinstance(t, list)]
    assert shed and done
    assert all(e.retry_after_s is not None and e.retry_after_s > 0
               for e in shed)
    assert all(t == reference(np.asarray([1, 2, 3], np.int32), 4)
               for t in done)


def test_frontend_surfaces_a_poisoned_request():
    _, teng = engines(slots=2, megastep_k=4)

    async def drive():
        fe = AsyncServingFrontend(teng, max_pending=4)
        task = asyncio.ensure_future(
            fe.generate(np.asarray([1, 2, 3, 4], np.int32),
                        max_new_tokens=6))
        while not fe._live:
            await asyncio.sleep(0.001)
        teng.inject_logit_poison(fe._live[0].req)
        try:
            await task
        except RequestFailed as e:
            return e
        finally:
            await fe.close()

    err = asyncio.run(drive())
    assert isinstance(err, RequestFailed)
    assert err.reason == "nonfinite-logits"


def test_parser_overload_knobs():
    args = build_parser().parse_args([])
    assert args.max_queue == 0 and args.audit is False
    args = build_parser().parse_args(["--max-queue", "8", "--audit"])
    assert args.max_queue == 8 and args.audit is True


# -- chaos: seeded schedules through both engines' injectors ---------------------
def _chaos_engines(mode, k, depth):
    kw = dict(slots=3, megastep_k=k)
    if mode == "paged":
        # 12 usable blocks, at most 4 pages a request: room for the three
        # slots, so contention comes from the exhaust_pool events
        kw.update(page_size=8, cache_blocks=13)
    return engines(depth, **kw)


def _replay(schedules, reqs_of, mode, k, depth):
    """Run the JAX and the port's engine under the same schedule (each
    through its own package's injector, audit after every step) and
    return both outcomes and the port engine."""
    jeng, teng = _chaos_engines(mode, k, depth)
    out = []
    for eng, req_cls, injector, sched in (
            (jeng, JRequest, JFaultInjector, schedules[0]),
            (teng, Request, FaultInjector, schedules[1])):
        reqs = reqs_of(eng, req_cls)
        for r in reqs:
            eng.submit(r)
        injector(eng, sched, audit=True, backoff_s=0.0,
                 sleep=lambda s: None).run(reqs)
        assert not eng.has_work()
        out.append(_outcome(reqs))
    assert not teng._quarantined
    if teng.paged:
        assert teng.blocks_in_use == len(teng._prefix_reg)
    return out[0], out[1], teng


def _check_against_reference(outcome, reqs):
    for (output, done, _, error, _), r in zip(outcome, reqs):
        assert done
        ref = reference(r.prompt, r.max_new_tokens)
        if error is not None:
            assert error == "nonfinite-logits"
            assert output == ref[:len(output)], r.uid
        else:
            assert output == ref, r.uid


@pytest.mark.chaos
@pytest.mark.parametrize("seed,mode,depth,k", [
    (11, "dense", 1, 1), (12, "dense", 2, 8), (13, "paged", 1, 8),
    (14, "paged", 2, 1), (15, "paged", 2, 8), (16, "dense", 2, 1)])
def test_chaos_schedule_survivors_match_reference(seed, mode, depth, k):
    """A seeded storm (pool exhaustion, preemption, poison, host stalls,
    transient exceptions): the port's outcome is the JAX engine's, every
    survivor's stream is the reference and a poisoned request's output
    a clean prefix of it; the pool is whole again at the end."""
    n = int(np.random.default_rng(seed).integers(2, 6))
    scheds = [cls.seeded(seed, n_requests=n, paged=mode == "paged")
              for cls in (JFaultSchedule, FaultSchedule)]

    def reqs_of(eng, req_cls):
        return random_requests(req_cls, seed, n)
    want, got, _ = _replay(scheds, reqs_of, mode, k, depth)
    assert got == want
    _check_against_reference(got, random_requests(Request, seed, n))


@pytest.mark.chaos
@pytest.mark.parametrize("mode,depth", [("dense", 2), ("paged", 1),
                                        ("paged", 2)])
def test_repeated_preemption_stays_token_identical(mode, depth):
    seed = 21
    tgt = 1
    scheds = [[cls(s, "preempt", ridx=tgt) for s in (1, 3, 5)]
              for cls in (JFaultEvent, FaultEvent)]
    scheds = [JFaultSchedule(scheds[0]), FaultSchedule(scheds[1])]

    def reqs_of(eng, req_cls):
        return random_requests(req_cls, seed, 3)
    want, got, _ = _replay(scheds, reqs_of, mode, 8, depth)
    assert got == want
    assert all(e is None for _, _, _, e, _ in got)
    assert got[tgt][4] >= 1
    _check_against_reference(got, random_requests(Request, seed, 3))


@pytest.mark.chaos
@pytest.mark.parametrize("k,depth", [(1, 1), (8, 2)])
def test_pool_exhaustion_storm_recovers(k, depth):
    seed = 31
    rng = np.random.default_rng(seed)
    events = [(0, int(rng.integers(6, 12)), 2), (3, int(rng.integers(2, 8)),
                                                 1)]
    scheds = [sched_cls([ev_cls(s, "exhaust_pool", blocks=b, duration=d)
                         for s, b, d in events])
              for sched_cls, ev_cls in ((JFaultSchedule, JFaultEvent),
                                        (FaultSchedule, FaultEvent))]

    def reqs_of(eng, req_cls):
        return random_requests(req_cls, seed, 5)
    want, got, _ = _replay(scheds, reqs_of, "paged", k, depth)
    assert got == want
    _check_against_reference(got, random_requests(Request, seed, 5))


@pytest.mark.chaos
@pytest.mark.parametrize("mode,depth", [("dense", 1), ("paged", 2)])
def test_poison_isolates_survivors_bytewise(mode, depth):
    """The same batch with and without one poisoned request: the
    survivors' streams are equal, and equal to the JAX engine's."""
    seed, tgt = 41, 2
    _, teng = _chaos_engines(mode, 8, depth)
    clean = random_requests(Request, seed, 4)
    for r in clean:
        teng.submit(r)
    teng.run()
    scheds = [sched_cls([ev_cls(0, "poison_logits", ridx=tgt)])
              for sched_cls, ev_cls in ((JFaultSchedule, JFaultEvent),
                                        (FaultSchedule, FaultEvent))]

    def reqs_of(eng, req_cls):
        return random_requests(req_cls, seed, 4)
    want, got, _ = _replay(scheds, reqs_of, mode, 8, depth)
    assert got == want
    assert got[tgt][3] == "nonfinite-logits"
    for (output, _, _, error, _), c in zip(got, clean):
        if error is None:
            assert output == c.output
    _check_against_reference(got, random_requests(Request, seed, 4))

