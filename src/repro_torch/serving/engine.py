"""Batched decode serving engine (port of ``repro/serving/engine.py``).

Wave-based continuous batching: up to ``max_batch`` equal-length requests
run as one wave (synthetic workloads use fixed prompt lengths; ragged
admission is future work — the UFA control-plane behaviors below are the
point).  The engine exposes exactly the hooks the UFA layer drives:

  - ``block_tiers`` / ``unblock_tiers``: the §4.2 traffic-isolation analog —
    requests of blocked tiers are refused at admission (fail-fast).
  - ``preempt()``: drop the running wave (Restore-Later semantics) and
    return its requests; KV caches are disposable on preemption, requests
    re-prefill after restore (stateless-service assumption, DESIGN.md §2).
  - ``active``: replica liveness — ``serving.failover.FailoverBridge``
    toggles it from the timeline kernel's per-tier capacity traces, so a
    full-peak failover evicts/restores actual inference replicas.
  - per-tier served/rejected/preempted/restored counters -> availability
    accounting with the §4.2 differentiated-SLA semantics: a preempted
    request counts against its own (preemptible) tier's SLA until it is
    requeued after restoration.

The decode step is ``repro_torch.models.decode_step`` (B5 against the KV
cache, B4 on every norm, on the card) under ``torch.no_grad``; the K/V
caches are written in place, as the reference's donated buffers are.  The engine runs where its ``params``
lie.  Each round reads the wave's greedy tokens to the host once, and the
cache length is counted on the host, so a round synchronises with the
card once.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Set

import torch

from repro_torch.core.tiers import Tier
from repro_torch.models import (DecodeState, LMConfig, decode_step,
                                init_decode_state)


def _params_device(params) -> torch.device:
    """The device of the first tensor in the (nested) parameter dict."""
    for v in params.values():
        if isinstance(v, dict):
            return _params_device(v)
        return v.device
    raise ValueError("ServingEngine: empty params")


@dataclasses.dataclass
class Request:
    rid: int
    tier: Tier
    prompt: List[int]
    max_new_tokens: int = 16
    output: List[int] = dataclasses.field(default_factory=list)
    state: str = "queued"  # queued|running|done|rejected|preempted|failed
    # request-plane hardening fields (stamped by TieredScheduler.submit;
    # None means "scheduler fills from its clock / tier policy")
    t_arrival: Optional[float] = None
    deadline_s: Optional[float] = None
    attempts: int = 0                 # retry attempts consumed
    t_finish: Optional[float] = None  # sim time of the final verdict
    fail_reason: str = ""             # rejected|shed|deadline|retry_exhausted


class ServingEngine:
    def __init__(self, cfg: LMConfig, params, max_batch: int = 8,
                 max_seq: int = 256, cache_dtype=torch.float32,
                 serves: Optional[Set[Tier]] = None):
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.cache_dtype = cache_dtype
        self.serves = set(serves) if serves is not None else None
        self.active = True            # replica liveness (FailoverBridge)
        self.blocked_tiers: Set[Tier] = set()
        self.counters: Dict[str, Dict[Tier, int]] = {
            k: defaultdict(int)
            for k in ("served", "rejected", "preempted", "restored")}
        self.wave: List[Request] = []
        self._state: Optional[DecodeState] = None
        self._len = 0                 # tokens in the wave's cache (host)
        self.tokens_decoded = 0

    @property
    def device(self) -> torch.device:
        """Where the engine decodes: its params' device."""
        return _params_device(self.params)

    # ------------------------------------------------------------------
    def _step(self, params, state: DecodeState, tokens):
        """One decode step of the wave (the reference's ``_jitted_step``)."""
        with torch.no_grad():
            return decode_step(params, self.cfg, state, tokens)

    def can_serve(self, tier: Tier) -> bool:
        return self.active and (self.serves is None or tier in self.serves)

    def admit(self, reqs: List[Request]) -> List[Request]:
        """Admission control: refuse blocked tiers, fill up to max_batch
        with equal-length prompts, highest criticality first."""
        if not self.active:
            return []                 # deactivated replica: leave queued
        accepted: List[Request] = []
        for r in sorted(reqs, key=lambda r: r.tier):
            if r.tier in self.blocked_tiers:
                r.state = "rejected"
                r.fail_reason = "rejected"
                self.counters["rejected"][r.tier] += 1
                continue
            if len(accepted) >= self.max_batch:
                r.state = "queued"
                continue
            if accepted and len(r.prompt) != len(accepted[0].prompt):
                continue  # wave requires uniform prompt length
            accepted.append(r)
        if accepted:
            self._start_wave(accepted)
        return accepted

    def _start_wave(self, reqs: List[Request]):
        assert not self.wave, "wave already running"
        self.wave = reqs
        for r in reqs:
            r.state = "running"
            r.output = []   # re-prefill after preemption: outputs restart
        B = len(reqs)
        dev = self.device
        self._state = init_decode_state(self.cfg, B, self.max_seq,
                                        self.cache_dtype, device=dev)
        # prefill: feed prompt tokens (teacher-forced) through decode steps
        prompts = torch.tensor([[int(t) for t in r.prompt] for r in reqs],
                               dtype=torch.int32).to(dev)
        for t in range(prompts.shape[1]):
            logits, self._state = self._step(self.params, self._state,
                                             prompts[:, t])
        self._len = prompts.shape[1]
        self._last_logits = logits

    # ------------------------------------------------------------------
    def decode_round(self, now: Optional[float] = None) -> bool:
        """One greedy decode step for the running wave.  Returns True while
        the wave still has work.  ``now`` (sim time) stamps completions."""
        if not self.wave:
            return False
        next_tok = torch.argmax(self._last_logits, dim=-1).to(torch.int32)
        for r, tok in zip(self.wave, next_tok.tolist()):
            r.output.append(tok)
        self.tokens_decoded += len(self.wave)
        done = all(len(r.output) >= r.max_new_tokens for r in self.wave)
        if done or self._len >= self.max_seq - 1:
            for r in self.wave:
                r.state = "done"
                if now is not None:
                    r.t_finish = float(now)
                self.counters["served"][r.tier] += 1
            self.wave = []
            self._state = None
            return False
        self._last_logits, self._state = self._step(
            self.params, self._state, next_tok)
        self._len += 1
        return True

    # ------------------------------------------------------------------
    # UFA hooks
    # ------------------------------------------------------------------
    def block_tiers(self, tiers: Set[Tier]):
        self.blocked_tiers |= set(tiers)

    def unblock_tiers(self, tiers: Set[Tier]):
        self.blocked_tiers -= set(tiers)

    def preempt(self) -> List[Request]:
        """Drop the running wave (UFA eviction); caches are discarded."""
        dropped = self.wave
        for r in dropped:
            r.state = "preempted"
            self.counters["preempted"][r.tier] += 1
        self.wave = []
        self._state = None
        return dropped

    def restored_credit(self, req: Request):
        """A request this engine preempted has been requeued post-restore:
        it stops counting against this engine's availability (the request
        is back in flight, its final verdict lands wherever it completes)."""
        self.counters["restored"][req.tier] += 1

    def reset(self):
        """Back to a fresh steady state (pooled engines across drills)."""
        self.blocked_tiers = set()
        self.active = True
        self.counters = {
            k: defaultdict(int)
            for k in ("served", "rejected", "preempted", "restored")}
        self.wave = []
        self._state = None
        self.tokens_decoded = 0

    def availability(self, tier: Tier) -> float:
        """Per-tier request availability with §4.2 differentiated-SLA
        semantics: preempted-and-never-restored requests count against
        the (preemptible) tier they belong to."""
        s = self.counters["served"][tier]
        rej = self.counters["rejected"][tier]
        pending = max(0, self.counters["preempted"][tier]
                      - self.counters["restored"][tier])
        return s / max(1, s + rej + pending)
