"""Deterministic fault injection for ``ServingEngine`` (the port's own
copy of the JAX package's ``serving/faults.py``: ``FaultSchedule.seeded``
draws the same schedule for the same seed, so one storm can be replayed
through both engines).

The overload/failure layer (preemption, shedding, poisoned-slot
retirement, the block-pool audit) is only trustworthy if its failure
paths actually run — and production faults don't arrive on demand.
This module makes them schedulable and *seeded*: a ``FaultSchedule``
is a plain list of ``FaultEvent``s pinned to megastep indices, either
hand-built (regression tests replay one exact ordering) or drawn from
``FaultSchedule.seeded(seed)`` (chaos property tests sweep seeds, each
seed a reproducible storm). ``FaultInjector`` wraps the engine's step
loop, applies each event at its step, audits the allocator after every
step, and retries transient step faults with bounded exponential
backoff.

Event kinds:

- ``exhaust_pool``  — quarantine ``blocks`` free blocks for
  ``duration`` steps (admissions starve → preemption/putback paths
  fire), then release them. Uses the allocator's first-class
  quarantine owner class so ``engine.audit()`` stays green throughout.
- ``poison_logits`` — NaN the logits of request index ``ridx`` while
  it occupies a slot (inside the megastep, via the admission buffer's
  ``poison`` row) → the
  finiteness check error-retires it; co-batched survivors must be
  untouched.
- ``preempt``       — force-preempt request index ``ridx`` (evict +
  requeue); the resumed request must stay greedy token-identical.
- ``host_stall``    — sleep ``stall_s`` before the step (a GC pause /
  noisy-neighbor stand-in); the pipelined loop must absorb it without
  corrupting drain ordering.
- ``step_exception``— raise ``TransientStepFault`` *before* the step
  dispatches, ``fires`` times; the injector's bounded retry+backoff
  must recover and the stream must be unaffected (nothing was
  dispatched, so nothing replays).
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, List, Optional

KINDS = ("exhaust_pool", "poison_logits", "preempt", "host_stall",
         "step_exception")


class TransientStepFault(RuntimeError):
    """Injected failure raised before a step dispatches — models a
    recoverable runtime hiccup (allocator race, transient runtime error).
    ``FaultInjector`` retries these with bounded backoff."""


@dataclasses.dataclass
class FaultEvent:
    """One scheduled fault. ``step`` is the megastep index (0-based,
    counted by the injector) at which it applies."""
    step: int
    kind: str
    ridx: Optional[int] = None   # request index (poison / preempt)
    blocks: int = 0              # exhaust_pool: blocks to quarantine
    duration: int = 1            # exhaust_pool: steps before release
    stall_s: float = 0.0         # host_stall: sleep length
    fires: int = 1               # step_exception: consecutive raises

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {KINDS})")


@dataclasses.dataclass
class FaultSchedule:
    """An ordered storm of events. ``seeded`` draws a reproducible
    schedule: same seed → same events, so a chaos failure is
    re-runnable by seed alone."""
    events: List[FaultEvent] = dataclasses.field(default_factory=list)

    @classmethod
    def seeded(cls, seed: int, *, n_requests: int, horizon: int = 12,
               n_events: int = 4, paged: bool = True,
               kinds: Optional[tuple] = None) -> "FaultSchedule":
        rng = random.Random(seed)
        pool = list(kinds) if kinds is not None else [
            k for k in KINDS if paged or k != "exhaust_pool"]
        events = []
        poisoned: set = set()
        for _ in range(n_events):
            kind = rng.choice(pool)
            step = rng.randrange(horizon)
            if kind == "exhaust_pool":
                events.append(FaultEvent(
                    step, kind, blocks=rng.randrange(2, 8),
                    duration=rng.randrange(1, 4)))
            elif kind == "poison_logits":
                # at most one poisoned request per schedule keeps the
                # survivor set well-defined for reference pinning
                cands = [i for i in range(n_requests)
                         if i not in poisoned]
                if not cands:
                    continue
                ridx = rng.choice(cands)
                poisoned.add(ridx)
                events.append(FaultEvent(step, kind, ridx=ridx))
            elif kind == "preempt":
                events.append(FaultEvent(
                    step, kind, ridx=rng.randrange(n_requests)))
            elif kind == "host_stall":
                events.append(FaultEvent(
                    step, kind, stall_s=rng.uniform(0.001, 0.01)))
            else:  # step_exception
                events.append(FaultEvent(
                    step, kind, fires=rng.randrange(1, 3)))
        events.sort(key=lambda e: e.step)
        return cls(events)

    @property
    def poisoned_ridx(self) -> set:
        return {e.ridx for e in self.events
                if e.kind == "poison_logits"}


class FaultInjector:
    """Drives ``engine.step()`` under a ``FaultSchedule``.

    ``run(requests)`` submits nothing — callers submit first — but
    needs the request list to resolve each event's ``ridx``. Each loop
    iteration: fire this step's events, raise/retry any pending
    transient fault (bounded ``max_retries`` with exponential backoff
    starting at ``backoff_s``), step the engine, expire elapsed
    ``exhaust_pool`` events, and (when ``audit=True``) run
    ``engine.audit()``. On exit all remaining quarantined blocks are
    released so the pool is fully recoverable."""

    def __init__(self, engine, schedule: FaultSchedule, *,
                 max_retries: int = 3, backoff_s: float = 0.0005,
                 audit: bool = True,
                 sleep: Callable[[float], None] = time.sleep):
        self.engine = engine
        self.schedule = schedule
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.audit = audit
        self._sleep = sleep
        self.steps_run = 0
        self.retries = 0
        self.stalls_s = 0.0
        self._expiries: List = []   # (release_step, blocks)
        self._pending_raises = 0

    def _apply(self, ev: FaultEvent, requests) -> None:
        eng = self.engine
        if ev.kind == "exhaust_pool":
            got = eng.quarantine_blocks(ev.blocks)
            if got:
                self._expiries.append((self.steps_run + ev.duration,
                                       got))
        elif ev.kind == "poison_logits":
            req = requests[ev.ridx]
            if not (req.done or req.cancelled):
                eng.inject_logit_poison(req)
        elif ev.kind == "preempt":
            eng.preempt(requests[ev.ridx])
        elif ev.kind == "host_stall":
            self._sleep(ev.stall_s)
            self.stalls_s += ev.stall_s
        elif ev.kind == "step_exception":
            self._pending_raises += ev.fires

    def _step_with_retry(self) -> None:
        delay = self.backoff_s
        for attempt in range(self.max_retries + 1):
            try:
                if self._pending_raises > 0:
                    self._pending_raises -= 1
                    raise TransientStepFault(
                        f"injected transient fault "
                        f"(step {self.steps_run}, attempt {attempt})")
                self.engine.step()
                return
            except TransientStepFault:
                if attempt >= self.max_retries:
                    raise
                self.retries += 1
                self._sleep(delay)
                delay *= 2

    def run(self, requests, max_steps: int = 10000) -> None:
        eng = self.engine
        try:
            while eng.has_work() and self.steps_run < max_steps:
                for ev in self.schedule.events:
                    if ev.step == self.steps_run:
                        self._apply(ev, requests)
                self._step_with_retry()
                self.steps_run += 1
                expired = [e for e in self._expiries
                           if e[0] <= self.steps_run]
                for e in expired:
                    eng.release_quarantined(e[1])
                    self._expiries.remove(e)
                if self.audit:
                    eng.audit()
        finally:
            # pool fully recoverable after the storm, whatever happened
            eng.release_quarantined()
        if self.audit:
            eng.audit()
