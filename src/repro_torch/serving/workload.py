"""Open-loop Poisson workload driver: a live workload through a failover
(port of ``repro/serving/workload.py``).

``run_drill`` pushes a synthetic millions-of-users request trace (open
loop: arrivals never wait for completions, Poisson per tick from one
seeded stream) through a scripted full-peak failover:

  1. a paper-shaped fleet is synthesized and the timeline kernel
     simulates its failover (``simulate_timeline``);
  2. a :class:`~repro_torch.serving.failover.FailoverBridge` replays the
     per-tier capacity traces as replica actuation on a pool of real
     ``ServingEngine`` replicas behind a hardened ``TieredScheduler``;
  3. tiered Poisson arrivals (critical traffic doubling as the surviving
     region absorbs the failed region's users) flow through the same
     window, and every request gets a user-visible verdict.

The result is a :class:`DrillReport` of *measured request* SLOs — p50/p99
latency, goodput, availability, time-to-restore per tier — fed through
the ``obs`` burn-rate monitors (``obs.slo.alerts_np``), in contrast to
the core-count availability the sweep engine reports.

Two chaos knobs make the drill a campaign target (``chaos.faults``
``REQUEST_FAMILIES``): ``arrival_mult`` scales every arrival rate (the
arrival-spike family) and ``retry_storm`` adds speculative client
duplicates per arrival (the retry-storm family).  ``drill_oracle`` wraps
the drill for ``chaos.Campaign`` so bisection can localize the
request-level SLA frontier; drills are bit-deterministic per spec, so
``verify_report`` replays campaigns exactly.

The port runs the drill where ``device`` says (default: the CUDA card):
the timeline simulation and the engine pool's decode steps there, the
scheduler, the bridge, the arrival and jitter streams (numpy and
``random``, seeded through ``stage_seed``, so they are the reference's
bit for bit) and the verdicts on the host.  The pool's weights are the
port's ``init_params(cfg, 0)``; the reference draws its own with
``jax.random``, so verdicts equal the reference's only on its weights
(carried across with ``convert.params_from_reference``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Mapping, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core.scenarios import stage_seed
from repro_torch.core.tiers import FailureClass, RTO_SECONDS, Tier
from repro_torch.core.timeline_sim import (TimelineConfig, config_for_fleet,
                                           default_ts, simulate_timeline)
from repro_torch.kernels.backend import resolve_device
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.failover import FailoverBridge, ReplicaGroup
from repro_torch.serving.scheduler import TieredScheduler, TierPolicy

__all__ = ["DrillSpec", "TierVerdict", "DrillReport", "run_drill",
           "drill_oracle", "request_campaign", "pool_for"]

# tiny model: the workload is real (decode on the card), the model is not
# the point — same shape the seed failover_drill example uses
_LM = dict(name="live-drill", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=2, d_head=16, d_ff=128, vocab_size=128,
           tie_embeddings=True)


@dataclasses.dataclass(frozen=True)
class DrillSpec:
    """A fully seeded live-workload failover drill.

    Frozen + hashable so the engine pool and the (workload-independent)
    timeline simulation are cached across drills (per device) — a chaos
    campaign re-runs the workload per probe, not the fleet synthesis or
    the weights' initialisation."""
    # control plane
    scale: float = 0.02            # fleet synthesis scale
    fleet_seed: int = 4
    horizon_s: float = 7200.0
    n_steps: int = 96
    traffic_mult: float = 2.0      # surviving-region multiplier (sim + load)
    # serving pool
    crit_tier: Tier = Tier.T1
    pre_tier: Tier = Tier.T5
    crit_replicas: int = 2
    crit_standby: int = 2          # Always-On upscale headroom
    pre_replicas: int = 2
    max_batch: int = 4
    prompt_len: int = 4
    max_new_tokens: int = 4
    # workload
    crit_rps: float = 0.06         # steady critical arrivals / sim-second
    pre_rps: float = 0.12
    users_per_request: float = 7000.0
    ticks_per_step: int = 5        # scheduler rounds per trace step
    ramp_s: float = 480.0          # city-wave ramp of the 2x crit traffic
    seed: int = 0
    drain: bool = True             # run the queue dry past the horizon
    # chaos knobs (request-plane fault families)
    arrival_mult: float = 1.0      # arrival-spike severity knob
    retry_storm: float = 0.0       # speculative-duplicate severity knob
    # request-level SLA
    avail_slo: float = 0.9997
    crit_p99_slo_s: float = 150.0

    @property
    def rates(self) -> Dict[Tier, float]:
        return {self.crit_tier: self.crit_rps, self.pre_tier: self.pre_rps}


@dataclasses.dataclass
class TierVerdict:
    """User-visible per-tier outcome of one drill."""
    tier: str
    arrived: int
    served: int
    rejected: int
    shed: int
    deadline: int
    retry_exhausted: int
    preempted: int
    requeued: int
    pending: int                   # in flight at the end (censored)
    availability: float            # served / completed verdicts
    goodput_rps: float             # served / horizon
    p50_s: float
    p99_s: float
    time_to_restore_s: float       # first post-blackout completion (inf: n/a)
    slo_alert: bool                # burn-rate monitor fired on this tier
    t_first_alert_s: float

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class DrillReport:
    spec: DrillSpec
    tiers: Dict[Tier, TierVerdict]
    sla_ok: bool
    users_served: float
    actuation_log: List[Tuple[float, Tier, int]]
    avail_trace: Dict[Tier, np.ndarray]    # per-step availability (SLO input)
    ts: np.ndarray

    @property
    def crit(self) -> TierVerdict:
        return self.tiers[self.spec.crit_tier]

    @property
    def pre(self) -> TierVerdict:
        return self.tiers[self.spec.pre_tier]

    def render(self) -> str:
        lines = [
            f"live failover drill  seed={self.spec.seed}  "
            f"horizon={self.spec.horizon_s:.0f}s  "
            f"~{self.users_served / 1e6:.2f}M users served  "
            f"SLA: {'PASS' if self.sla_ok else 'FAIL'}",
            f"{'tier':<6}{'arrived':>8}{'served':>8}{'failed':>8}"
            f"{'avail':>9}{'p50':>8}{'p99':>8}{'restore':>9}  slo",
        ]
        for t in sorted(self.tiers):
            v = self.tiers[t]
            failed = (v.rejected + v.shed + v.deadline + v.retry_exhausted)
            rest = ("-" if not np.isfinite(v.time_to_restore_s)
                    else f"{v.time_to_restore_s:.0f}s")
            lines.append(
                f"{v.tier:<6}{v.arrived:>8}{v.served:>8}{failed:>8}"
                f"{v.availability:>9.4f}{v.p50_s:>7.0f}s{v.p99_s:>7.0f}s"
                f"{rest:>9}  "
                + ("ALERT" if v.slo_alert else "ok"))
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# cached heavyweight pieces: fleet/timeline sim + the engine pool
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _sim_for(scale: float, fleet_seed: int, horizon_s: float, n_steps: int,
             traffic_mult: float, device: str = "cuda"
             ) -> Tuple[TimelineConfig, Dict[str, np.ndarray]]:
    from repro_torch.core.service import synthesize_fleet
    fleet = synthesize_fleet(scale=scale, seed=fleet_seed)
    cfg = config_for_fleet(fleet)
    sim = simulate_timeline(cfg, {"traffic_mult": traffic_mult},
                            ts=default_ts(horizon_s, n_steps), device=device)
    return cfg, sim


@functools.lru_cache(maxsize=4)
def _engine_pool(crit_tier: Tier, pre_tier: Tier, crit_replicas: int,
                 crit_standby: int, pre_replicas: int, max_batch: int,
                 max_seq: int, device: str = "cuda"
                 ) -> Tuple[Dict[str, ServingEngine],
                            Tuple[ReplicaGroup, ...]]:
    from repro_torch.models import LMConfig, init_params
    cfg = LMConfig(**_LM)
    params = init_params(cfg, 0, device=device)
    crit_serves = {t for t in Tier if t.is_critical}
    pre_serves = set(Tier) - crit_serves
    engines: Dict[str, ServingEngine] = {}
    crit_names, pre_names = [], []
    for i in range(crit_replicas + crit_standby):
        name = f"crit-{i}"
        engines[name] = ServingEngine(cfg, params, max_batch=max_batch,
                                      max_seq=max_seq, serves=crit_serves)
        crit_names.append(name)
    for i in range(pre_replicas):
        name = f"pre-{i}"
        engines[name] = ServingEngine(cfg, params, max_batch=max_batch,
                                      max_seq=max_seq, serves=pre_serves)
        pre_names.append(name)
    groups = (ReplicaGroup(crit_tier, tuple(crit_names), crit_replicas),
              ReplicaGroup(pre_tier, tuple(pre_names), pre_replicas))
    return engines, groups


def _policies(spec: DrillSpec) -> Dict[Tier, TierPolicy]:
    rto = RTO_SECONDS[FailureClass.RESTORE_LATER]
    return {
        spec.crit_tier: TierPolicy(deadline_s=900.0, max_retries=3,
                                   backoff_base_s=5.0, queue_bound=1024),
        spec.pre_tier: TierPolicy(deadline_s=2.0 * rto, max_retries=2,
                                  backoff_base_s=30.0, queue_bound=512),
    }


# ---------------------------------------------------------------------------
# the drill
# ---------------------------------------------------------------------------

def _device_key(device) -> str:
    """The pool and simulation caches' key for ``device`` (checked)."""
    return str(resolve_device(device))


def pool_for(spec: DrillSpec, device=None
             ) -> Tuple[Dict[str, ServingEngine], Tuple[ReplicaGroup, ...]]:
    """The cached engine pool and replica groups that ``run_drill(spec,
    device)`` drives."""
    return _engine_pool(
        spec.crit_tier, spec.pre_tier, spec.crit_replicas,
        spec.crit_standby, spec.pre_replicas, spec.max_batch,
        spec.prompt_len + spec.max_new_tokens + 8, _device_key(device))


def run_drill(spec: DrillSpec, device=None) -> DrillReport:
    """One scripted full-peak failover under live load on ``device``
    (default: the CUDA card).  Deterministic: the same spec reproduces
    every verdict bit for bit (one seeded arrival stream, greedy decode,
    deterministic backoff jitter)."""
    dev = _device_key(device)
    cfg, sim = _sim_for(spec.scale, spec.fleet_seed, spec.horizon_s,
                        spec.n_steps, spec.traffic_mult, dev)
    engines, groups = pool_for(spec, dev)
    for e in engines.values():
        e.reset()
    sched = TieredScheduler(engines, policies=_policies(spec),
                            seed=stage_seed(spec.seed, "drill-jitter"))
    bridge = FailoverBridge(sched, groups)
    rng = np.random.default_rng(stage_seed(spec.seed, "drill-arrivals"))

    ts = sim["t"]
    dt = float(ts[1] - ts[0])
    tick_dt = dt / spec.ticks_per_step
    kill_t = float(cfg.kill_s)
    tiers = sorted(spec.rates)
    rid = iter(range(10 ** 9))
    lat: Dict[Tier, List[float]] = {t: [] for t in tiers}
    served_at: Dict[Tier, List[float]] = {t: [] for t in tiers}
    # per-step (served, failed) tallies -> availability trace per tier
    tally = {t: np.zeros((spec.n_steps, 2), np.int64) for t in tiers}

    def crit_mult(t: float) -> float:
        if t < kill_t:
            return 1.0
        ramp = min(1.0, (t - kill_t) / max(spec.ramp_s, 1e-9))
        return 1.0 + (spec.traffic_mult - 1.0) * ramp

    def record(events, step: int):
        for t_ev, outcome, r in events:
            if r.tier not in tally:
                continue
            i = min(step, spec.n_steps - 1)
            if outcome == "served":
                tally[r.tier][i, 0] += 1
                lat[r.tier].append(t_ev - float(r.t_arrival))
                served_at[r.tier].append(t_ev)
            else:
                tally[r.tier][i, 1] += 1

    for i in range(spec.n_steps):
        t0 = float(ts[i])
        bridge.drive_step(sim, cfg, i)
        for j in range(spec.ticks_per_step):
            t_tick = t0 + (j + 1) * tick_dt
            for tier in tiers:
                rate = spec.rates[tier] * spec.arrival_mult
                if tier.is_critical:
                    rate *= crit_mult(t_tick)
                n = int(rng.poisson(rate * tick_dt))
                if spec.retry_storm > 0.0 and n:
                    # speculative client duplicates (retry storm): extra
                    # copies of this tick's arrivals, same load path
                    n += int(rng.poisson(n * 3.0 * spec.retry_storm))
                for _ in range(n):
                    prompt = rng.integers(
                        0, _LM["vocab_size"], spec.prompt_len).tolist()
                    sched.submit(Request(
                        next(rid), tier=tier, prompt=prompt,
                        max_new_tokens=spec.max_new_tokens), now=t_tick)
            sched.tick(now=t_tick)
        record(sched.drain_events(), i)
        if obs.enabled():
            for tier in tiers:
                obs.set_gauge("ufa_serving_queue_depth",
                              sched.queue_depth(tier), tier=tier.name)

    if spec.drain:   # let retries/requeues complete past the horizon
        t = float(ts[-1]) + dt
        for _ in range(20 * spec.ticks_per_step * spec.n_steps):
            busy = sched.tick(now=t)
            t += tick_dt
            if not busy and not sched._q and not sched._retry:
                break
        record(sched.drain_events(), spec.n_steps - 1)

    # ---- verdicts ------------------------------------------------------
    from repro_torch.obs.slo import alerts_np
    blackout_t = next((t for t, tier, tgt in bridge.log
                       if tier == spec.pre_tier and tgt == 0), None)
    react_t = None          # capacity back after the blackout
    if blackout_t is not None:
        react_t = next((t for t, tier, tgt in bridge.log
                        if tier == spec.pre_tier and tgt > 0
                        and t > blackout_t), None)
    verdicts: Dict[Tier, TierVerdict] = {}
    avail_trace: Dict[Tier, np.ndarray] = {}
    users_served = 0.0
    for tier in tiers:
        c = {k: sched.counters[k][tier] for k in sched.counters}
        done, failed = tally[tier][:, 0], tally[tier][:, 1]
        tot = done + failed
        avail = np.where(tot > 0, done / np.maximum(tot, 1), 1.0)
        avail_trace[tier] = avail
        al = alerts_np(avail, ts, target=spec.avail_slo)
        fails = (c["rejected"] + c["shed"] + c["deadline"]
                 + c["retry_exhausted"])
        pending = max(0, c["arrived"] - c["served"] - fails)  # censored
        ls = np.asarray(lat[tier], np.float64)
        # user-visible time-to-restore: blackout entry -> first served
        # completion once the bridge has reactivated capacity
        restore = float("inf")
        if blackout_t is not None and react_t is not None:
            post = [t_s for t_s in served_at[tier] if t_s >= react_t]
            if post:
                restore = min(post) - blackout_t
        verdicts[tier] = TierVerdict(
            tier=tier.name, arrived=c["arrived"], served=c["served"],
            rejected=c["rejected"], shed=c["shed"], deadline=c["deadline"],
            retry_exhausted=c["retry_exhausted"], preempted=c["preempted"],
            requeued=c["requeued"], pending=pending,
            availability=sched.availability(tier),
            goodput_rps=c["served"] / spec.horizon_s,
            p50_s=float(np.percentile(ls, 50)) if ls.size else float("nan"),
            p99_s=float(np.percentile(ls, 99)) if ls.size else float("nan"),
            time_to_restore_s=restore if tier == spec.pre_tier
            else (0.0 if c["served"] else float("inf")),
            slo_alert=bool(al["alert"]),
            t_first_alert_s=float(al["t_first_alert"]))
        users_served += c["served"] * spec.users_per_request

    crit, pre = verdicts[spec.crit_tier], verdicts[spec.pre_tier]
    rto = RTO_SECONDS[FailureClass.RESTORE_LATER]
    sla_ok = (crit.availability >= spec.avail_slo
              and not crit.slo_alert
              and np.isfinite(crit.p99_s)
              and crit.p99_s <= spec.crit_p99_slo_s
              and pre.time_to_restore_s <= rto)
    report = DrillReport(spec=spec, tiers=verdicts, sla_ok=bool(sla_ok),
                         users_served=users_served,
                         actuation_log=list(bridge.log),
                         avail_trace=avail_trace, ts=np.asarray(ts))
    return report


# ---------------------------------------------------------------------------
# chaos integration: the drill as a campaign target
# ---------------------------------------------------------------------------

def drill_oracle(base: DrillSpec, device=None) -> Callable:
    """Wrap the drill as a ``chaos.Campaign`` oracle over the
    request-plane fault knobs: each scenario row maps ``arrival_mult`` /
    ``retry_storm`` onto a fresh deterministic drill; ``ok`` is the
    drill's request-level SLA verdict.  Rows are independent drills, so
    replayed batches are bit-identical regardless of batch composition
    (``verify_report(..., oracle=...)``).  The drills run on ``device``
    (default: the CUDA card)."""
    dev = _device_key(device)

    def oracle(grid: Mapping[str, np.ndarray]):
        n = len(next(iter(grid.values())))
        am = np.asarray(grid.get("arrival_mult",
                                 np.full(n, base.arrival_mult)), np.float64)
        rs = np.asarray(grid.get("retry_storm",
                                 np.full(n, base.retry_storm)), np.float64)
        ok = np.zeros(n, bool)
        res = {k: np.zeros(n, np.float64) for k in
               ("sla_ok", "crit_availability", "crit_p99_s",
                "pre_restore_s")}
        for i in range(n):
            rep = run_drill(dataclasses.replace(
                base, arrival_mult=float(am[i]), retry_storm=float(rs[i])),
                dev)
            ok[i] = rep.sla_ok
            res["sla_ok"][i] = float(rep.sla_ok)
            res["crit_availability"][i] = rep.crit.availability
            res["crit_p99_s"][i] = rep.crit.p99_s
            res["pre_restore_s"][i] = rep.pre.time_to_restore_s
        return ok, res

    return oracle


def request_campaign(base: DrillSpec, *, rays=None, tol: float = 1.0 / 16.0,
                     max_rounds: int = 6, device=None, **kw):
    """A chaos campaign over the request-plane fault families: hunts the
    arrival-spike / retry-storm severities at which the drill's measured
    request-level SLA first breaks (drills on ``device``, default the
    CUDA card)."""
    from repro_torch.chaos.campaign import Campaign, Ray
    from repro_torch.chaos.faults import REQUEST_FAMILIES
    if rays is None:
        rays = (Ray("arrival_spike", {"arrival_spike": 1.0}),
                Ray("retry_storm", {"retry_storm": 1.0}))
    return Campaign(oracle=drill_oracle(base, device), rays=rays,
                    families=REQUEST_FAMILIES, tol=tol,
                    max_rounds=max_rounds, seed=base.seed, **kw)
