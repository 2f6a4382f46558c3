"""Tiered QoS request scheduler over one or more serving engines (port of
``repro/serving/scheduler.py``, host code: a copy with its imports on
``repro_torch``).

Implements the UFA request-plane policy: strict tier priority with
starvation-bounded aging, engine-level admission respecting blocked tiers,
and failover hooks that (1) block preemptible-tier traffic, (2) preempt
running non-critical waves so critical tiers get the capacity — the
request-level mirror of the container-level orchestration in core/omg.py.

Request-plane hardening (§4.2 differentiated SLAs, made graceful):

  - per-tier :class:`TierPolicy` — deadline budget, bounded retries with
    exponential backoff + deterministic jitter, a queue-depth bound for
    load-shedding admission, and fail-fast rejection while a tier is
    blocked (no queue build-up behind a blacked-out tier).
  - ``block_tier``/``restore_tier`` — per-tier variants of the failover
    hooks so ``serving.failover.FailoverBridge`` can blackout and restore
    tiers independently, following the timeline kernel's capacity traces;
    preempted non-critical work is *held* during the blackout and requeued
    (re-prefilled, one retry consumed) after restoration.
  - scheduler-level counters + ``availability()`` — drained-queue
    rejections and fail-fast rejections are charged here, not to an
    arbitrary engine, so per-engine ``availability()`` stays truthful.

The scheduler keeps a simulation clock: ``tick(now=...)`` advances it,
``tick()`` (legacy) advances round-by-round at 1 s/round.  Finalized
requests are appended to ``events`` as ``(t, outcome, request)`` so the
workload driver can build per-step availability traces for the SLO
burn-rate monitors.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import random
from collections import defaultdict
from typing import Dict, List, Optional, Set, Tuple

from repro_torch import obs
from repro_torch.core.tiers import (DEFAULT_CLASS_OF_TIER, FailureClass,
                                    RTO_SECONDS, Tier)
from repro_torch.serving.engine import Request, ServingEngine

__all__ = ["TierPolicy", "default_policies", "TieredScheduler"]


@dataclasses.dataclass(frozen=True)
class TierPolicy:
    """Per-tier request-plane budget (deadline, retries, shedding)."""
    deadline_s: float = float("inf")   # end-to-end latency budget
    max_retries: int = 2               # bounded retries (preempt/requeue)
    backoff_base_s: float = 5.0        # first-retry backoff
    backoff_mult: float = 2.0          # exponential backoff factor
    jitter_frac: float = 0.1           # uniform jitter on each backoff
    queue_bound: Optional[int] = None  # shed arrivals beyond this depth
    fail_fast_blocked: bool = True     # reject (vs queue) blocked tiers

    def backoff(self, attempts: int, u: float) -> float:
        """Backoff before retry ``attempts`` (1-based); ``u`` in [0, 1)."""
        base = self.backoff_base_s * self.backoff_mult ** max(0, attempts - 1)
        return base * (1.0 + self.jitter_frac * u)


def default_policies() -> Dict[Tier, TierPolicy]:
    """Differentiated budgets: critical tiers get tight deadlines and
    eager retries; preemptible tiers get their Restore-Later RTO as the
    deadline (a request may legitimately wait out the blackout)."""
    pol: Dict[Tier, TierPolicy] = {}
    for t, fc in DEFAULT_CLASS_OF_TIER.items():
        if fc.preemptible:
            rto = RTO_SECONDS[FailureClass.RESTORE_LATER]
            pol[t] = TierPolicy(deadline_s=2.0 * rto, max_retries=2,
                                backoff_base_s=30.0, queue_bound=512)
        else:
            pol[t] = TierPolicy(deadline_s=900.0, max_retries=3,
                                backoff_base_s=5.0, queue_bound=1024)
    return pol


class TieredScheduler:
    def __init__(self, engines: Dict[str, ServingEngine],
                 aging_rounds: int = 50,
                 policies: Optional[Dict[Tier, TierPolicy]] = None,
                 seed: int = 0):
        self.engines = engines
        self.aging_rounds = aging_rounds
        self.policies = default_policies()
        if policies:
            self.policies.update(policies)
        self._q: List[Tuple[int, int, int, Request]] = []  # (eff_tier, born, seq, r)
        self._seq = itertools.count()
        self.round = 0
        self.now = 0.0
        self.failover_active = False
        self.blocked: Set[Tier] = set()
        self._depth: Dict[Tier, int] = defaultdict(int)
        # retry buffer: (t_ready, seq, request) released when now >= t_ready
        self._retry: List[Tuple[float, int, Request]] = []
        # preempted blocked-tier work held until its tier is restored
        self._preempted: List[Tuple[ServingEngine, Request]] = []
        self._rng = random.Random(seed)    # deterministic backoff jitter
        self._aged_round = 0
        self.counters: Dict[str, Dict[Tier, int]] = {
            k: defaultdict(int)
            for k in ("arrived", "served", "rejected", "shed", "deadline",
                      "retry_exhausted", "preempted", "requeued")}
        # finalize log: (t, outcome, request) — consumed by the workload
        # driver to build per-step availability traces for the SLO monitor
        self.events: List[Tuple[float, str, Request]] = []

    # ------------------------------------------------------------------
    def policy(self, tier: Tier) -> TierPolicy:
        return self.policies.get(tier, TierPolicy())

    def submit(self, req: Request, now: Optional[float] = None):
        """External arrival: admission control (fail-fast + shedding),
        then enqueue.  ``now`` defaults to the scheduler clock."""
        t = self.now if now is None else float(now)
        pol = self.policy(req.tier)
        if req.t_arrival is None:
            req.t_arrival = t
        if req.deadline_s is None:
            req.deadline_s = pol.deadline_s
        self.counters["arrived"][req.tier] += 1
        if req.tier in self.blocked and pol.fail_fast_blocked:
            self._finalize(req, "rejected", t)
            return
        if pol.queue_bound is not None \
                and self._depth[req.tier] >= pol.queue_bound:
            self._finalize(req, "shed", t)
            return
        self._push(req)

    def _push(self, req: Request):
        """Enqueue without admission control (internal requeues)."""
        req.state = "queued"
        self._depth[req.tier] += 1
        heapq.heappush(
            self._q, (int(req.tier), self.round, next(self._seq), req))

    def _finalize(self, req: Request, outcome: str, t: float):
        req.t_finish = float(t)
        if outcome == "served":
            req.state = "done"
        else:
            req.state = "rejected" if outcome == "rejected" else "failed"
            req.fail_reason = outcome
        self.counters[outcome][req.tier] += 1
        self.events.append((float(t), outcome, req))
        if obs.enabled():
            obs.inc("ufa_serving_requests_total",
                    tier=req.tier.name, outcome=outcome)
            if outcome == "served" and req.t_arrival is not None:
                obs.observe("ufa_serving_request_latency_s",
                            float(t) - float(req.t_arrival),
                            tier=req.tier.name)

    # ------------------------------------------------------------------
    def _age_heap(self):
        """Re-key the heap with current effective tiers so starvation
        aging actually reorders pops: an ancient low-priority request is
        promoted one tier per ``aging_rounds`` rounds waited (ties break
        on ``born`` — oldest first), bounding its starvation."""
        if self._aged_round == self.round or not self._q:
            return
        self._aged_round = self.round
        if self.aging_rounds <= 0:
            return
        self._q = [
            (max(0, int(r.tier) - (self.round - born) // self.aging_rounds),
             born, seq, r)
            for (_, born, seq, r) in self._q]
        heapq.heapify(self._q)

    def _expired(self, r: Request) -> bool:
        return (r.deadline_s is not None and r.t_arrival is not None
                and self.now - r.t_arrival > r.deadline_s)

    def _pop_wave(self, engine: ServingEngine) -> List[Request]:
        """Pop up to ``max_batch`` equal-length requests this engine can
        serve, in aged-priority order; lazily expires deadline-blown and
        drops blocked-tier stragglers on the way."""
        self._age_heap()
        taken: List[Request] = []
        rest: List[Tuple[int, int, int, Request]] = []
        plen: Optional[int] = None
        while self._q and len(taken) < engine.max_batch:
            key, born, seq, r = heapq.heappop(self._q)
            self._depth[r.tier] -= 1
            if self._expired(r):
                self._finalize(r, "deadline", self.now)
                continue
            if r.tier in self.blocked:
                self._finalize(r, "rejected", self.now)
                continue
            if not engine.can_serve(r.tier) \
                    or (plen is not None and len(r.prompt) != plen):
                rest.append((key, born, seq, r))
                self._depth[r.tier] += 1
                continue
            plen = len(r.prompt)
            taken.append(r)
        for item in rest:
            heapq.heappush(self._q, item)
        return taken

    def tick(self, now: Optional[float] = None) -> int:
        """One scheduling round: release due retries, keep engines busy,
        run one decode step per engine.  ``now`` advances the sim clock
        (defaults to +1 s/round).  Returns decode steps executed."""
        self.round += 1
        self.now = self.now + 1.0 if now is None else max(self.now,
                                                          float(now))
        while self._retry and self._retry[0][0] <= self.now:
            _, _, r = heapq.heappop(self._retry)
            if self._expired(r):
                self._finalize(r, "deadline", self.now)
            else:
                self._push(r)
        steps = 0
        for engine in self.engines.values():
            if not engine.active:
                continue
            if not engine.wave and self._q:
                wave = self._pop_wave(engine)
                if wave:
                    engine.admit(wave)
                    for r in wave:
                        if r.state == "queued":   # didn't fit this wave
                            self._push(r)
                        elif r.state == "rejected":  # engine-level block
                            self._finalize(r, "rejected", self.now)
            if engine.wave:
                wave = list(engine.wave)
                engine.decode_round(self.now)
                steps += 1
                if not engine.wave:               # wave completed
                    for r in wave:
                        if r.state == "done":
                            self.counters["served"][r.tier] += 1
                            self.events.append((self.now, "served", r))
                            if obs.enabled():
                                obs.inc("ufa_serving_requests_total",
                                        tier=r.tier.name, outcome="served")
                                if r.t_arrival is not None:
                                    obs.observe(
                                        "ufa_serving_request_latency_s",
                                        self.now - float(r.t_arrival),
                                        tier=r.tier.name)
        return steps

    # ------------------------------------------------------------------
    # UFA failover integration
    # ------------------------------------------------------------------
    def absorb_preempted(self, engine: ServingEngine,
                         dropped: List[Request]):
        """Route a preempted wave: blocked-tier requests are held for
        post-restore requeue; others (critical riders of a mixed wave, or
        capacity-dip preemptions) retry immediately with backoff."""
        for r in dropped:
            self.counters["preempted"][r.tier] += 1
            if r.tier in self.blocked:
                self._preempted.append((engine, r))
            else:
                engine.restored_credit(r)
                self._requeue(r, self.now)

    def _requeue(self, r: Request, t: float):
        """Bounded retry with exponential backoff + jitter; re-prefill
        semantics (output restarts when the next wave starts)."""
        pol = self.policy(r.tier)
        r.attempts += 1
        if r.attempts > pol.max_retries:
            self._finalize(r, "retry_exhausted", t)
            return
        self.counters["requeued"][r.tier] += 1
        if obs.enabled():
            obs.inc("ufa_serving_retries_total", tier=r.tier.name)
        t_ready = t + pol.backoff(r.attempts, self._rng.random())
        r.state = "queued"
        heapq.heappush(self._retry, (t_ready, next(self._seq), r))

    def block_tier(self, tier: Tier, now: Optional[float] = None):
        """Blackout one tier: stop admission, preempt running waves that
        carry it, drain + reject its queued work (fail fast, §4.2).
        Rejections are charged at the scheduler level, not to an
        arbitrary engine."""
        if now is not None:
            self.now = max(self.now, float(now))
        self.blocked.add(tier)
        for engine in self.engines.values():
            engine.block_tiers({tier})
            if engine.wave and any(r.tier in self.blocked
                                   for r in engine.wave):
                self.absorb_preempted(engine, engine.preempt())
        kept = []
        while self._q:
            key, born, seq, r = heapq.heappop(self._q)
            if r.tier == tier:
                self._depth[r.tier] -= 1
                self._finalize(r, "rejected", self.now)
            else:
                kept.append((key, born, seq, r))
        for item in kept:
            heapq.heappush(self._q, item)

    def restore_tier(self, tier: Tier, now: Optional[float] = None):
        """Tier restored: reopen admission and requeue its held preempted
        work (re-prefill, one retry consumed, backoff + jitter)."""
        if now is not None:
            self.now = max(self.now, float(now))
        self.blocked.discard(tier)
        for engine in self.engines.values():
            engine.unblock_tiers({tier})
        held, rest = [], []
        for engine, r in self._preempted:
            (held if r.tier == tier else rest).append((engine, r))
        self._preempted = rest
        for engine, r in held:
            engine.restored_credit(r)
            self._requeue(r, self.now)

    def enter_failover(self, now: Optional[float] = None):
        """Block every preemptible tier, preempt its running work, drain
        its queue (fail fast until restoration)."""
        self.failover_active = True
        for t, fc in DEFAULT_CLASS_OF_TIER.items():
            if fc.preemptible:
                self.block_tier(t, now)

    def exit_failover(self, now: Optional[float] = None):
        self.failover_active = False
        for t, fc in DEFAULT_CLASS_OF_TIER.items():
            if fc.preemptible:
                self.restore_tier(t, now)

    # ------------------------------------------------------------------
    def queue_depth(self, tier: Optional[Tier] = None) -> int:
        if tier is not None:
            return self._depth[tier]
        return len(self._q)

    def preempted_pending(self, tier: Tier) -> int:
        return sum(1 for _, r in self._preempted if r.tier == tier)

    def availability(self, tier: Tier) -> float:
        """Scheduler-level request availability: served over every final
        (or still-preempted-pending) verdict for the tier.  Failures of
        all reasons — fail-fast rejections, shed arrivals, deadline
        misses, exhausted retries — count against the tier's SLA, as do
        preempted-and-not-yet-restored requests (§4.2: against the
        preemptible tier, never the critical one)."""
        c = self.counters
        s = c["served"][tier]
        fails = (c["rejected"][tier] + c["shed"][tier] + c["deadline"][tier]
                 + c["retry_exhausted"][tier])
        return s / max(1, s + fails + self.preempted_pending(tier))

    def drain_events(self) -> List[Tuple[float, str, Request]]:
        ev, self.events = self.events, []
        return ev
