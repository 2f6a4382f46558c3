"""Control plane ⇄ serving plane bridge: capacity traces as replica actuation
(port of ``repro/serving/failover.py``, host code on numpy: a copy with
its imports on ``repro_torch``).

The timeline kernel (``core.timeline_sim``) and the Orchestrator
(``core.omg``) both produce per-tier *live-core* trajectories through a
full-peak failover.  :class:`FailoverBridge` replays either one as
replica-count actuation on a pool of
:class:`~repro_torch.serving.ServingEngine` replicas grouped by tier:

  - full-peak entry drives a preemptible tier's live fraction to ~0 →
    its replicas deactivate, running waves are preempted (KV caches
    dropped), and the tier is blacked out at the scheduler (fail-fast
    §4.2);
  - Restore-Later capacity returns only when the trace says it does —
    burst conversion after the preheat delay, cloud arrivals after
    ``provision_time`` — so replicas (and the tier's admission) come
    back exactly when the control plane restores cores, and held
    preempted requests are requeued to re-prefill (stateless-service
    assumption);
  - Always-On tiers can exceed their steady fraction (the in-place 2x
    upscale into the failover buffer): standby replicas activate to
    absorb the surviving-region traffic multiplier.

Two drive modes, one actuation formula (``target = round(base * frac)``
clamped to the group's slots):

  - :meth:`drive_trace` / :meth:`drive_step` replay a
    ``simulate_timeline`` result step by step (the deterministic path
    the workload driver and the chaos drills use);
  - :meth:`bind` chains onto an Orchestrator's ``on_evict`` /
    ``on_migrate`` / ``on_restore`` callbacks and recomputes the same
    per-tier live fractions from ``orch.fs`` at event-loop time — the
    discrete-event path, parity-tested against the trace path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core.tiers import DEFAULT_CLASS_OF_TIER, Tier
from repro_torch.core.timeline_sim import (N_TIERS, RESTORE_THRESH,
                                           TimelineConfig)
from repro_torch.serving.scheduler import TieredScheduler

__all__ = ["ReplicaGroup", "FailoverBridge", "tier_live_fractions"]


@dataclasses.dataclass(frozen=True)
class ReplicaGroup:
    """Replica slots of one tier: ``names`` index ``scheduler.engines``
    in activation order; the first ``base`` are active in steady state,
    the rest are standby headroom (Always-On upscale)."""
    tier: Tier
    names: Tuple[str, ...]
    base: int

    def __post_init__(self):
        if not 0 < self.base <= len(self.names):
            raise ValueError(
                f"group {self.tier.name}: base {self.base} not in "
                f"[1, {len(self.names)}]")


def tier_live_fractions(sim: Mapping[str, np.ndarray], cfg: TimelineConfig,
                        step: int) -> np.ndarray:
    """Per-tier live fraction at one trace step: ``tier_live / totals``."""
    totals = np.maximum(cfg.tier_totals(), 1e-9)
    return np.asarray(sim["tier_live"][step], np.float64) / totals


class FailoverBridge:
    def __init__(self, scheduler: TieredScheduler,
                 groups: Sequence[ReplicaGroup],
                 restore_thresh: float = RESTORE_THRESH):
        self.sched = scheduler
        self.groups: Dict[Tier, ReplicaGroup] = {}
        for g in groups:
            if g.tier in self.groups:
                raise ValueError(f"duplicate group for tier {g.tier.name}")
            for n in g.names:
                if n not in scheduler.engines:
                    raise KeyError(f"group {g.tier.name}: engine {n!r} "
                                   "not in scheduler.engines")
            self.groups[g.tier] = g
        self.restore_thresh = float(restore_thresh)
        # actuation log: (t, tier, target) — one entry per target change
        self.log: List[Tuple[float, Tier, int]] = []
        for g in self.groups.values():    # steady state: base active
            self._apply(0.0, g, g.base, record=False)

    # ------------------------------------------------------------------
    @staticmethod
    def target_for(group: ReplicaGroup, frac: float) -> int:
        """Replica target for a live fraction — the one actuation formula
        both drive modes share (parity-tested)."""
        return int(np.clip(round(group.base * frac), 0, len(group.names)))

    def active_count(self, tier: Tier) -> int:
        g = self.groups[tier]
        return sum(self.sched.engines[n].active for n in g.names)

    def actuate(self, now: float, live_frac: np.ndarray):
        """Drive every group toward ``round(base * frac)`` replicas; a
        preemptible tier is blacked out while its target is 0 and
        restored when capacity returns."""
        for tier, g in self.groups.items():
            self._apply(now, g, self.target_for(g, float(live_frac[tier])))

    def _apply(self, now: float, g: ReplicaGroup, target: int,
               record: bool = True):
        cur = self.active_count(g.tier)
        if target == cur:
            return
        preemptible = DEFAULT_CLASS_OF_TIER[g.tier].preemptible
        if target < cur:
            if preemptible and target == 0 \
                    and g.tier not in self.sched.blocked:
                # blackout first: queued work fails fast, running waves
                # are preempted and *held* for post-restore requeue
                self.sched.block_tier(g.tier, now)
            for name in reversed(g.names):      # standby-last deactivation
                if cur <= target:
                    break
                eng = self.sched.engines[name]
                if eng.active:
                    dropped = eng.preempt()
                    eng.active = False
                    if dropped:
                        self.sched.absorb_preempted(eng, dropped)
                    cur -= 1
        else:
            for name in g.names:
                if cur >= target:
                    break
                eng = self.sched.engines[name]
                if not eng.active:
                    eng.active = True
                    cur += 1
            if preemptible and g.tier in self.sched.blocked:
                self.sched.restore_tier(g.tier, now)
        if record:
            self.log.append((float(now), g.tier, target))
        if obs.enabled():
            obs.set_gauge("ufa_serving_replicas_active", target,
                          tier=g.tier.name)

    # ------------------------------------------------------------------
    # drive mode 1: timeline-kernel traces
    # ------------------------------------------------------------------
    def drive_step(self, sim: Mapping[str, np.ndarray], cfg: TimelineConfig,
                   step: int):
        self.actuate(float(sim["t"][step]),
                     tier_live_fractions(sim, cfg, step))

    def drive_trace(self, sim: Mapping[str, np.ndarray],
                    cfg: TimelineConfig):
        """Replay a whole ``simulate_timeline`` result (no workload —
        pure actuation; the workload driver interleaves arrivals)."""
        for i in range(len(sim["t"])):
            self.drive_step(sim, cfg, i)

    # ------------------------------------------------------------------
    # drive mode 2: live Orchestrator events
    # ------------------------------------------------------------------
    def bind(self, orch):
        """Chain onto the orchestrator's eviction/migration/restoration
        callbacks: after each fired service-environment, recompute the
        per-tier live fractions from ``orch.fs`` at ``orch.loop.now`` and
        actuate.  Same formula as the trace path — restores only happen
        when the event loop delivers capacity (cloud ``provision_time``
        included), so the two modes agree step for step."""
        totals = np.maximum(np.bincount(
            np.asarray(orch.fs.tier, np.int64),
            weights=np.asarray(orch.fs.spec_cores, np.float64),
            minlength=N_TIERS), 1e-9)

        def fire(_spec=None):
            live = np.bincount(
                np.asarray(orch.fs.tier, np.int64),
                weights=np.asarray(orch.fs.cores_live, np.float64),
                minlength=N_TIERS)
            self.actuate(float(orch.loop.now), live / totals)

        def chained(prev):
            if prev is None:
                return fire

            def cb(spec):
                prev(spec)
                fire(spec)
            return cb

        orch.on_evict = chained(orch.on_evict)
        orch.on_migrate = chained(orch.on_migrate)
        orch.on_restore = chained(orch.on_restore)
        return self
