"""The port's asyncio front-end (``launch/serve.py``) on the CPU (tiny
deepseek-7b, f32 weights carried by ``bridge.from_jax``;
``_torch_serving.py``): streamed tokens, the ``max_pending`` bound,
deadline expiry, rejects at submit and cancelled tasks, at pipeline depth
1 and 2, with the results held to the JAX engine's streams for the same
prompts (exact: greedy, f32 params); and the CLI's flags.

The coroutines run under ``asyncio.run`` inside plain test functions.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import asyncio

import numpy as np
import pytest

from _torch_serving import engines, prompt, reference
from repro.serving import Request as JRequest
from repro_torch.launch import serve
from repro_torch.launch.serve import (AsyncServingFrontend, DeadlineExceeded,
                                      build_parser)

DEPTHS = [1, 2]


def _jax_streams(prompts, max_new, **kw):
    """The JAX engine's streams for these prompts, served together (this
    resets the port engine of the same configuration too)."""
    jeng, _ = engines(1, **kw)
    reqs = [JRequest(uid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        jeng.submit(r)
    jeng.run()
    return [r.output for r in reqs]


@pytest.mark.parametrize("depth", DEPTHS)
def test_frontend_streams_and_matches_the_jax_engine(depth):
    """Five requests through max_pending 3: each future's tokens are the
    JAX engine's stream, and the callback saw each token once."""
    prompts = [prompt(4 + i, seed=10 + i) for i in range(5)]
    _, teng = engines(depth, slots=2, megastep_k=4)
    streamed = {i: [] for i in range(5)}

    async def drive():
        fe = AsyncServingFrontend(teng, max_pending=3)
        outs = await asyncio.gather(*[
            fe.generate(p, max_new_tokens=6, on_token=streamed[i].append)
            for i, p in enumerate(prompts)])
        await fe.close()
        return outs

    outs = asyncio.run(drive())
    assert not teng.has_work()
    want = _jax_streams(prompts, 6, slots=2, megastep_k=4)
    assert outs == want
    assert [streamed[i] for i in range(5)] == want


@pytest.mark.parametrize("depth", DEPTHS)
def test_frontend_backpressure_bound(depth):
    """With max_pending 2 no more than two requests are submitted and
    unfinished at a time, however many generate() calls wait."""
    _, teng = engines(depth, slots=2, megastep_k=4)
    high_water = 0

    async def drive():
        nonlocal high_water
        fe = AsyncServingFrontend(teng, max_pending=2)

        def watch(_tok):
            nonlocal high_water
            high_water = max(high_water, fe.max_pending - fe._sem._value)

        outs = await asyncio.gather(*[
            fe.generate(prompt(6, seed=20 + i), max_new_tokens=4,
                        on_token=watch) for i in range(6)])
        await fe.close()
        return outs

    outs = asyncio.run(drive())
    assert outs == [reference(prompt(6, seed=20 + i), 4) for i in range(6)]
    assert high_water <= 2
    with pytest.raises(ValueError, match="max_pending"):
        AsyncServingFrontend(teng, max_pending=0)


@pytest.mark.parametrize("depth", DEPTHS)
def test_frontend_deadline_expiry_retires_and_recovers(depth):
    """An expired deadline raises DeadlineExceeded with its partial tokens
    (none: it expired before admission), counts an engine cancel, and the
    engine then serves the next request to its reference stream."""
    _, teng = engines(depth, slots=1, megastep_k=1)
    p = prompt(12, seed=30)

    async def drive():
        fe = AsyncServingFrontend(teng)
        try:
            await fe.generate(p, max_new_tokens=500, deadline_s=0.0)
        except DeadlineExceeded as e:
            err = e
        else:
            err = None
        ok = await fe.generate(p, max_new_tokens=5)
        await fe.close()
        return err, ok

    err, ok = asyncio.run(drive())
    assert isinstance(err, DeadlineExceeded) and err.tokens == []
    assert teng.stats.cancelled == 1
    assert ok == reference(p, 5)


def test_frontend_deadline_mid_decode_keeps_a_prefix():
    """A deadline that expires while the request decodes: the partial
    tokens it carries are a prefix of the reference stream."""
    _, teng = engines(2, slots=1, megastep_k=1)
    p = prompt(6, seed=31)

    async def drive():
        fe = AsyncServingFrontend(teng)
        got = []
        task = asyncio.ensure_future(fe.generate(
            p, max_new_tokens=60, deadline_s=30.0, on_token=got.append))
        while len(got) < 3:
            await asyncio.sleep(0.001)
        fe._live[0].deadline = 0.0       # expire it now
        try:
            await task
        except DeadlineExceeded as e:
            err = e
        await fe.close()
        return err

    err = asyncio.run(drive())
    assert 3 <= len(err.tokens) < 60
    assert err.tokens == reference(p, 60)[:len(err.tokens)]
    assert not teng.has_work()


def test_frontend_propagates_a_submit_rejection():
    _, teng = engines(1, slots=2, megastep_k=4)

    async def drive():
        fe = AsyncServingFrontend(teng)
        with pytest.raises(ValueError, match="empty prompt"):
            await fe.generate(np.zeros(0, np.int32), max_new_tokens=4)
        toks = await fe.generate(prompt(6), max_new_tokens=0)
        await fe.close()
        return toks

    assert asyncio.run(drive()) == []


@pytest.mark.parametrize("depth", DEPTHS)
def test_frontend_task_cancellation_cancels_the_request(depth):
    """Cancelling the awaiting task retires the request in the engine, and
    the loop keeps serving."""
    _, teng = engines(depth, slots=1, megastep_k=1)

    async def drive():
        fe = AsyncServingFrontend(teng)
        victim = asyncio.ensure_future(
            fe.generate(prompt(20, seed=40), max_new_tokens=500))
        await asyncio.sleep(0.05)
        victim.cancel()
        try:
            await victim
        except asyncio.CancelledError:
            pass
        survivor = await fe.generate(prompt(6, seed=41), max_new_tokens=5)
        await fe.close()
        return survivor

    assert asyncio.run(drive()) == reference(prompt(6, seed=41), 5)
    assert teng.stats.cancelled >= 1


# -- the CLI ---------------------------------------------------------------------
def test_parser_async_knobs():
    ap = build_parser()
    assert ap.parse_args([]).reduced is True
    assert ap.parse_args(["--no-reduced"]).reduced is False
    args = ap.parse_args(["--pipeline-depth", "2", "--frontend",
                          "--deadline-s", "0.5", "--max-queue", "3"])
    assert args.pipeline_depth == 2 and args.frontend
    assert args.deadline_s == 0.5 and args.max_queue == 3
    defaults = ap.parse_args([])
    assert defaults.pipeline_depth == 1 and not defaults.frontend
    assert defaults.deadline_s is None and defaults.max_queue == 0


@pytest.mark.parametrize("frontend", [False, True])
def test_cli_serves_at_depth_2(capsys, frontend):
    """The CLI at depth 2 on the CPU: the synchronous run's streams are
    the depth-1 run's; the front-end run completes every request."""
    base = ["--device", "cpu", "--requests", "5", "--max-new", "6",
            "--temperature", "0", "--slots", "2", "--max-len", "64"]
    res2 = serve.main(base + ["--pipeline-depth", "2"]
                      + (["--frontend"] if frontend else []))
    out = capsys.readouterr().out
    assert "pipeline: depth 2, drain-wait" in out
    assert res2.engine.pipeline_depth == 2 and not res2.engine.has_work()
    if frontend:
        assert "frontend: 5 completed, 0 deadline-expired" in out
        assert res2.requests == []
    else:
        res1 = serve.main(base)
        assert [r.output for r in res2.requests] == \
            [r.output for r in res1.requests]
        assert all(len(r.output) == 6 for r in res2.requests)
