"""Array-native discrete-time failover timeline: summary verdicts for a
batch of scenarios (hard path).

Port of ``repro/core/timeline_sim.py``.  The reference scans a step
function over the 240-step grid per scenario; here the per-step series
(``_instant_core``) is closed-form in ``t`` once a scenario's schedule
(``_schedule``) is known, so it is evaluated for the whole ``(S, T)``
slab at once, with no Python loop over steps, and the scan carry becomes
one call of the verdict-reduction kernel (``kernels/ufa/reduce.py``).
Every op of the schedule, the series and ``_finalize`` is the
reference's op on float32 tensors, in the reference's order: booleans
and restore times are exact, the availability integral is a float32 sum
in another order (float32-tight), and other floats match to the last
bit, within which the reference's compiled CPU program can differ where
it fuses a multiply-add.

Aggregation semantics and the ``EPS_T`` time tolerance are the
reference's (see its module docstring).  Not ported yet: the per-step
trace outputs (``_instant``, ``simulate_timeline``, ``sweep_timeline``)
and the soft relaxation (``tau``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.core.fleet_state import (AM, AO, POOL_OVERCOMMIT,
                                          POOL_STATELESS, RL, TM)
from repro_torch.core.tiers import (QOS_EVICT_UTILIZATION, RTO_SECONDS,
                                    FailureClass, Tier)
from repro_torch.kernels.backend import resolve_device

EPS_T = 1e-3                    # time-comparison tolerance (seconds)
N_TIERS = len(Tier)
N_CLASSES = 4
BASE_AVAILABILITY = 0.9997      # ambient (paper Fig 8)
AVAIL_SLA_TOL = 5e-5            # integral may dip this far below ambient
RESTORE_THRESH = 0.999          # tier counts as restored above this frac

_DEMAND_CRIT = 0.62             # demand per live core, critical classes
_DEMAND_PRE = 0.35              # demand per live core, preemptible classes


# ---------------------------------------------------------------------------
# Config extraction
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TimelineConfig:
    """Aggregate fleet/region state the timeline simulates over (the
    reference's fields, one for one)."""
    # class aggregates (spec cores; live == spec in steady state)
    ao_cores: float
    am_cores: float
    rl_cores: float
    tm_cores: float
    am_envs: float
    rl_envs: float
    tm_envs: float
    # (n_tiers, n_classes) spec cores — per-tier live-core traces
    tier_class_cores: np.ndarray
    # steady pools, post-placement
    stateless_cap: float
    overcommit_cap: float
    steady_used0: float
    overcommit_used0: float
    oc_preempt_cores: float     # preemptible cores accounted in overcommit
    sl_preempt_cores: float     # preemptible overflow spilled to stateless
    am_stateless_cores: float   # AM cores accounted in the stateless pool
    # batch -> burst conversion
    burst_cap_full: float
    spawn_rate: float           # cores/s once conversion starts
    # cloud (§4.6)
    cloud_quota: float
    cloud_rate: float
    phys_cores: float
    # orchestrator tunables (single-sourced from Orchestrator at extract)
    kill_s: float = 5.0
    preheat_s: float = 270.0
    mbb_wave_s: float = 45.0
    mbb_parallelism: float = 2000.0
    rl_wave_s: float = 120.0
    rl_rto_s: float = float(RTO_SECONDS[FailureClass.RESTORE_LATER])

    def as_consts(self, device=None) -> Dict[str, torch.Tensor]:
        """float32 constants on ``device`` (default: the CUDA card)."""
        dev = resolve_device(device)
        f = lambda v: torch.tensor(np.asarray(v, np.float32), device=dev)
        return {
            "ao": f(self.ao_cores), "am": f(self.am_cores),
            "rl": f(self.rl_cores), "tm": f(self.tm_cores),
            "am_envs": f(self.am_envs), "rl_envs": f(self.rl_envs),
            "tm_envs": f(self.tm_envs),
            "tier_class": f(self.tier_class_cores),
            "stateless_cap": f(self.stateless_cap),
            "overcommit_cap": f(self.overcommit_cap),
            "steady_used0": f(self.steady_used0),
            "overcommit_used0": f(self.overcommit_used0),
            "oc_preempt_cores": f(self.oc_preempt_cores),
            "sl_preempt_cores": f(self.sl_preempt_cores),
            "am_stateless_cores": f(self.am_stateless_cores),
            "burst_cap_full": f(self.burst_cap_full),
            "spawn_rate": f(self.spawn_rate),
            "cloud_quota": f(self.cloud_quota),
            "cloud_rate": f(self.cloud_rate),
            "phys_cores": f(self.phys_cores),
            "kill_s": f(self.kill_s), "preheat_s": f(self.preheat_s),
            "mbb_wave_s": f(self.mbb_wave_s),
            "mbb_parallelism": f(self.mbb_parallelism),
            "rl_wave_s": f(self.rl_wave_s), "rl_rto_s": f(self.rl_rto_s),
        }


def extract_timeline_config(orch) -> TimelineConfig:
    """Read a steady-state ``Orchestrator`` into a ``TimelineConfig``.

    Must run before ``failover()``: it captures the post-placement,
    pre-eviction pool occupancy the event loop starts from."""
    fs, region = orch.fs, orch.region
    cores = fs.spec_cores
    cls = [float(cores[fs.fclass == c].sum()) for c in (AO, AM, RL, TM)]
    tier_class = np.zeros((N_TIERS, N_CLASSES), np.float64)
    for t in range(N_TIERS):
        tmask = fs.tier == t
        for c in range(N_CLASSES):
            tier_class[t, c] = float(cores[tmask & (fs.fclass == c)].sum())
    pre = fs.preemptible
    return TimelineConfig(
        ao_cores=cls[0], am_cores=cls[1], rl_cores=cls[2], tm_cores=cls[3],
        am_envs=float(np.count_nonzero(fs.fclass == AM)),
        rl_envs=float(np.count_nonzero(fs.fclass == RL)),
        tm_envs=float(np.count_nonzero(fs.fclass == TM)),
        tier_class_cores=tier_class,
        stateless_cap=float(region.steady.stateless.capacity),
        overcommit_cap=float(region.steady.overcommit.capacity),
        steady_used0=float(region.steady.stateless.used),
        overcommit_used0=float(region.steady.overcommit.used),
        oc_preempt_cores=float(
            cores[pre & (fs.pool == POOL_OVERCOMMIT)].sum()),
        sl_preempt_cores=float(
            cores[pre & (fs.pool == POOL_STATELESS)].sum()),
        am_stateless_cores=float(
            cores[(fs.fclass == AM) & (fs.pool == POOL_STATELESS)].sum()),
        burst_cap_full=float(region.batch.convertible_cores),
        spawn_rate=float(orch.SPAWN_CORES_PER_HOST_S * region.batch.n_hosts),
        cloud_quota=float(region.cloud.quota_cores),
        cloud_rate=float(region.cloud.provision_rate_cores_per_s),
        phys_cores=float(region.steady.physical_cores),
        kill_s=float(orch.KILL_LATENCY_S),
        preheat_s=float(orch.BATCH_EVICT_S + orch.PREFETCH_S),
        mbb_wave_s=float(orch.MBB_WAVE_S),
        mbb_parallelism=float(orch.MBB_PARALLELISM),
        rl_wave_s=float(orch.RL_RESTORE_WAVE_S),
    )


def config_for_fleet(fleet, region=None) -> TimelineConfig:
    """Build a ``TimelineConfig`` for a fleet (dict of ``ServiceSpec`` or a
    ``FleetState``): sizes a fresh region (unless given), performs the
    orchestrator's steady-state placement, extracts.  Side-effect free
    for the caller (placement runs against a copy of the region, and a
    ``FleetState``'s ``pool`` column is restored afterwards)."""
    import copy

    from repro_torch.core.capacity import RegionCapacity
    from repro_torch.core.omg import Orchestrator
    if region is None:
        region = RegionCapacity.for_fleet("timeline", fleet)
    else:
        region = copy.deepcopy(region)
        region.steady.stateless.used = 0.0
        region.steady.overcommit.used = 0.0
    pool_save = fleet.pool.copy() if hasattr(fleet, "pool") else None
    try:
        return extract_timeline_config(Orchestrator(fleet, region))
    finally:
        if pool_save is not None:
            fleet.pool[:] = pool_save


# ---------------------------------------------------------------------------
# Scenario parameters
# ---------------------------------------------------------------------------

PARAM_KEYS = ("traffic_mult", "burst_delay_s", "burst_availability",
              "cloud_quota_frac", "overcommit_factor", "evict_fraction",
              "dep_broken_frac",
              # chaos fault families: partial-region degradation + the
              # cascading dependency-storm schedule (exact no-ops at the
              # defaults below)
              "region_degradation", "storm_refrac", "storm_t0_s",
              "storm_period_s", "storm_recover_s", "storm_broken_frac",
              # eviction-order knobs: per-class shifts of the evicted
              # fraction (additive forms, exact no-ops at 0)
              "rl_evict_delta", "tm_evict_delta")


def default_scenario(**overrides) -> Dict[str, float]:
    """The paper's operating point (2x traffic, full burst, full quota),
    no chaos fault, pro-rata class eviction."""
    p = {"traffic_mult": 2.0, "burst_delay_s": 270.0,
         "burst_availability": 1.0, "cloud_quota_frac": 1.0,
         "overcommit_factor": 1.5, "evict_fraction": 1.0,
         "dep_broken_frac": 0.0,
         "region_degradation": 0.0, "storm_refrac": 0.0,
         "storm_t0_s": 1800.0, "storm_period_s": 1800.0,
         "storm_recover_s": 600.0, "storm_broken_frac": 0.0,
         "rl_evict_delta": 0.0, "tm_evict_delta": 0.0}
    p.update(overrides)
    return p


def validate_grid(grid) -> int:
    """Validate a scenario grid (dict of parallel axis columns) and
    return the scenario count; raises ``ValueError`` on an unknown key,
    an empty grid or ragged axes."""
    if not grid:
        raise ValueError("empty scenario grid: no axes given (pass at "
                         "least one PARAM_KEYS column, or None for the "
                         "default grid)")
    unknown = sorted(set(grid) - set(PARAM_KEYS))
    if unknown:
        raise ValueError(
            f"unknown scenario grid key(s) {unknown}: a misspelled axis "
            "would silently sweep nothing (defaults would be used "
            f"instead); valid axes: {sorted(PARAM_KEYS)}")
    n = len(next(iter(grid.values())))
    if n == 0:
        raise ValueError("empty scenario grid: zero-length scenario axes")
    ragged = {k: len(v) for k, v in grid.items() if len(v) != n}
    if ragged:
        raise ValueError(f"ragged scenario grid: axis lengths {ragged} "
                         f"differ from {n}")
    return n


def default_ts(horizon_s: float = 7200.0, n_steps: int = 240) -> np.ndarray:
    """Uniform step grid from 0: long enough to see the RL RTO expire."""
    return np.arange(n_steps, dtype=np.float64) * (horizon_s / n_steps)


# ---------------------------------------------------------------------------
# Schedule + closed-form per-step series
# ---------------------------------------------------------------------------


def _max(x, v):
    return torch.clamp(x, min=v)


def _min(x, v):
    return torch.clamp(x, max=v)


def _schedule(c: Dict, p: Dict) -> Dict:
    """Scenario-level event times and capacity splits, elementwise over
    the scenario axis (every ``p`` leaf has the same shape)."""
    mult = p["traffic_mult"]
    evict = p["evict_fraction"]

    # partial-region degradation; ``x * (1 - 0)`` is exact in float32
    cap_scale = 1.0 - p.get("region_degradation", 0.0)
    stateless_eff = c["stateless_cap"] * cap_scale

    burst_cap = c["burst_cap_full"] * p["burst_availability"]
    ramp_total = burst_cap / _max(c["spawn_rate"], 1e-9)
    burst_full_t = p["burst_delay_s"] + ramp_total

    n_am_waves = torch.ceil(c["am_envs"] / c["mbb_parallelism"])
    am_done_t = burst_full_t + n_am_waves * c["mbb_wave_s"]
    am_in_burst = torch.minimum(c["am"], burst_cap)

    ao_need = c["ao"] * (mult - 1.0)
    # steady free once the preemptible spill is evicted and AM released
    am_release_frac = c["am_stateless_cores"] / _max(c["am"], 1e-9)
    am_released = am_in_burst * am_release_frac
    free_at_am_done = (stateless_eff
                       - (c["steady_used0"] - evict * c["sl_preempt_cores"]
                          - am_released))
    ao_ok = ao_need <= free_at_am_done + 1e-6
    ao_short = _max(ao_need - free_at_am_done, 0.0)

    d_rl = p.get("rl_evict_delta", 0.0)
    rl_need = c["rl"] * evict + c["rl"] * d_rl
    rl_envs_evicted = c["rl_envs"] * evict + c["rl_envs"] * d_rl
    n_rl_waves = _max(torch.ceil(rl_envs_evicted / c["mbb_parallelism"]),
                      1.0)
    rl_last_wave_t = burst_full_t + n_rl_waves * c["rl_wave_s"]
    burst_free_rl = _max(burst_cap - am_in_burst, 0.0)
    quota_eff = c["cloud_quota"] * p["cloud_quota_frac"]
    total_cloud = torch.minimum(_max(rl_need - burst_free_rl, 0.0),
                                quota_eff)
    per_wave = rl_need / n_rl_waves
    k_star = torch.minimum(
        torch.floor(burst_free_rl / _max(per_wave, 1e-9)) + 1.0, n_rl_waves)
    cloud_start_t = burst_full_t + k_star * c["rl_wave_s"]
    cloud_arrival_t = cloud_start_t + total_cloud / _max(c["cloud_rate"],
                                                         1e-9)
    rl_shortfall = _max(rl_need - burst_free_rl - quota_eff, 0.0)
    rl_done_t = torch.where(
        rl_shortfall > 1e-6, float("inf"),
        torch.maximum(rl_last_wave_t,
                      torch.where(total_cloud > 1e-6, cloud_arrival_t, 0.0)))

    return {"burst_cap": burst_cap,
            "cap_scale": cap_scale, "stateless_eff": stateless_eff,
            "storm_refrac": p.get("storm_refrac", 0.0),
            "storm_t0": p.get("storm_t0_s", 1800.0),
            "storm_period": p.get("storm_period_s", 1800.0),
            "storm_recover": p.get("storm_recover_s", 600.0),
            "burst_full_t": burst_full_t,
            "n_am_waves": n_am_waves, "am_done_t": am_done_t,
            "am_in_burst": am_in_burst,
            "am_release_frac": am_release_frac,
            "ao_need": ao_need, "ao_ok": ao_ok, "ao_short": ao_short,
            "rl_need": rl_need, "rl_envs_evicted": rl_envs_evicted,
            "n_rl_waves": n_rl_waves, "rl_last_wave_t": rl_last_wave_t,
            "burst_free_rl": burst_free_rl, "quota_eff": quota_eff,
            "total_cloud": total_cloud, "cloud_start_t": cloud_start_t,
            "cloud_arrival_t": cloud_arrival_t,
            "rl_shortfall": rl_shortfall, "rl_done_t": rl_done_t}


def _storm_darkness(s: Dict, t):
    """Cascading-storm re-darkening envelope at time ``t`` (a sawtooth
    from ``storm_t0`` on, amplitude ``storm_refrac``); identically 0.0
    when ``storm_refrac`` is 0."""
    k = torch.clamp(torch.floor((t - s["storm_t0"] + EPS_T)
                                / _max(s["storm_period"], 1e-9)),
                    0.0, 1e6)
    since = t - s["storm_t0"] - k * s["storm_period"]
    env = torch.clamp(1.0 - since / _max(s["storm_recover"], 1e-9),
                      0.0, 1.0)
    gate = torch.where(t >= s["storm_t0"] - EPS_T, 1.0, 0.0)
    return s["storm_refrac"] * env * gate


def _instant_core(c: Dict, p: Dict, s: Dict, t) -> Dict:
    """The per-step series the scan carry consumes (availability, the
    demand-model utilization, the cloud draw, per-tier live cores),
    elementwise: ``p``/``s`` leaves of shape ``(S, 1)`` against ``t`` of
    shape ``(1, T)`` give ``(S, T)`` series and ``tier_live`` of shape
    ``(S, T, R)``."""
    mult = p["traffic_mult"]
    evicted = (t >= c["kill_s"] - EPS_T)
    e = torch.where(evicted, p["evict_fraction"], 0.0)
    d_rl_t = torch.where(evicted, p.get("rl_evict_delta", 0.0), 0.0)
    d_tm_t = torch.where(evicted, p.get("tm_evict_delta", 0.0), 0.0)

    # Active-Migrate MBB waves into burst
    am_waves_done = torch.minimum(
        _max(torch.floor((t - s["burst_full_t"] + EPS_T) / c["mbb_wave_s"]),
             0.0),
        s["n_am_waves"])
    am_envs_moved = torch.minimum(c["am_envs"],
                                  c["mbb_parallelism"] * am_waves_done)
    am_attempt = c["am"] * am_envs_moved / _max(c["am_envs"], 1.0)
    am_moved = torch.minimum(am_attempt, s["burst_cap"])

    # Always-On in-place upscale at migration completion
    ao_scaled = s["ao_ok"] & (t >= s["am_done_t"] - EPS_T)
    ao_live = c["ao"] * torch.where(ao_scaled, mult, 1.0)

    # Restore-Later waves: burst first, the cloud batch after provisioning
    rl_waves_done = torch.minimum(
        _max(torch.floor((t - s["burst_full_t"] + EPS_T) / c["rl_wave_s"]),
             0.0),
        s["n_rl_waves"])
    processed = s["rl_need"] * rl_waves_done / s["n_rl_waves"]
    rl_burst = torch.minimum(processed, s["burst_free_rl"])
    cloud_req = processed - rl_burst
    cloud_prov = torch.minimum(cloud_req, s["quota_eff"])
    cloud_arrived = torch.where(t >= s["cloud_arrival_t"] - EPS_T,
                                s["total_cloud"], 0.0)
    cloud_live = torch.minimum(cloud_arrived, cloud_prov)
    storm_dark = _storm_darkness(s, t)
    rl_restored = (rl_burst + cloud_live) * (1.0 - storm_dark)
    rl_live = c["rl"] - (e + d_rl_t) * c["rl"] + rl_restored
    tm_live = c["tm"] * (1.0 - e - d_tm_t)

    # demand-model utilization
    am_steady_cores = c["am"] - am_moved
    pre_steady = ((c["rl"] + c["tm"]) * (1.0 - e)
                  - (c["rl"] * d_rl_t + c["tm"] * d_tm_t))
    busy_model = (c["ao"] * _DEMAND_CRIT * mult
                  + am_steady_cores * _DEMAND_CRIT * mult
                  + pre_steady * _DEMAND_PRE)
    util_model = _min(busy_model / _max(s["stateless_eff"], 1.0), 1.0)

    # availability
    crit = _max(c["ao"] + c["am"], 1.0)
    rl_down = c["rl"] - rl_live
    tm_down = c["tm"] - tm_live
    ao_pen = torch.where(evicted, 0.5 * s["ao_short"] / crit, 0.0)
    overdue = torch.where(t > c["rl_rto_s"] + EPS_T, 1.0, 0.0)
    rl_pen = 0.1 * rl_down / _max(c["rl"], 1.0) * overdue
    dark_tot = _max(
        s["rl_need"] + (p["evict_fraction"]
                        + p.get("tm_evict_delta", 0.0)) * c["tm"], 1e-9)
    dark_frac = (rl_down + tm_down) / dark_tot
    dep_pen = 0.5 * p["dep_broken_frac"] * dark_frac
    util_pen = torch.where(util_model > QOS_EVICT_UTILIZATION, 1e-4, 0.0)
    storm_pen = 0.5 * p.get("storm_broken_frac", 0.0) * storm_dark
    availability = torch.clamp(
        BASE_AVAILABILITY - ao_pen - rl_pen - dep_pen - util_pen
        - storm_pen, 0.0, 1.0)

    # per-tier live cores: class live fractions applied to the tier x
    # class core composition, summed over classes in the reference's order
    class_live = (ao_live, c["am"], rl_live, tm_live)
    class_total = (c["ao"], c["am"], c["rl"], c["tm"])
    tier_live = None
    for k in range(N_CLASSES):
        frac = class_live[k] / _max(class_total[k], 1e-9)
        term = c["tier_class"][:, k] * frac[..., None]
        tier_live = term if tier_live is None else tier_live + term

    return {"availability": availability, "util_model": util_model,
            "cloud_used": cloud_prov, "tier_live": tier_live}


def _finalize(c: Dict, p: Dict, s: Dict, carry: Dict, ts) -> Dict:
    """Per-scenario summary/verdicts from the reduced carry."""
    span = _max(ts[-1] - ts[0], 1e-9)
    availability_mean = carry["avail_int"] / span
    time_to_restore = torch.where(carry["below_seen"], carry["restore_t"],
                                  0.0)
    oc_cap_s = s["stateless_eff"] * (p["overcommit_factor"] - 1.0)
    preempt_resident = ((c["rl"] + c["tm"]) * (1.0 - p["evict_fraction"])
                        - (c["rl"] * p.get("rl_evict_delta", 0.0)
                           + c["tm"] * p.get("tm_evict_delta", 0.0)))
    # the SLA verdict scores the post-migration steady point (stranded AM
    # only), like the analytic model
    am_stranded = c["am"] - s["am_in_burst"]
    busy_post = (c["ao"] * _DEMAND_CRIT * p["traffic_mult"]
                 + am_stranded * _DEMAND_CRIT * p["traffic_mult"]
                 + preempt_resident * _DEMAND_PRE)
    util_post = _min(busy_post / _max(s["stateless_eff"], 1.0), 1.0)
    preempt_fit = preempt_resident <= oc_cap_s + 1e-6
    dep_ok = p["dep_broken_frac"] <= 0.0
    avail_ok = availability_mean >= BASE_AVAILABILITY - AVAIL_SLA_TOL
    util_ok = util_post <= QOS_EVICT_UTILIZATION
    rl_rto_met = s["rl_done_t"] <= c["rl_rto_s"] + EPS_T
    sla_ok = (s["ao_ok"] & rl_rto_met & preempt_fit & dep_ok & avail_ok
              & util_ok & (s["am_done_t"] <= 30.0 * 60.0)
              & (s["burst_full_t"] <= 20.0 * 60.0))
    return {
        "burst_full_s": s["burst_full_t"], "am_done_s": s["am_done_t"],
        "rl_done_s": s["rl_done_t"], "rl_rto_met": rl_rto_met,
        "ao_ok": s["ao_ok"], "ao_short_cores": s["ao_short"],
        "rl_shortfall_cores": s["rl_shortfall"],
        "cloud_grant_cores": s["total_cloud"],
        "cloud_arrival_s": s["cloud_arrival_t"],
        "peak_cloud_cores": carry["cloud_peak"],
        "availability_mean": availability_mean,
        "availability_min": carry["avail_min"],
        "util_peak": carry["util_peak"], "util_post": util_post,
        "time_to_restore_s": time_to_restore,
        "preempt_fit": preempt_fit, "dep_ok": dep_ok,
        "avail_ok": avail_ok, "util_ok": util_ok, "sla_ok": sla_ok,
    }


def timeline_verdicts_batch(c: Dict, p: Dict, ts: torch.Tensor) -> Dict:
    """Summary verdicts for a BATCH of scenarios (every ``p`` leaf
    ``(S,)`` float32, ``ts`` ``(T,)`` float32, all on one device): the
    schedule and the per-step series for the whole ``(S, T)`` slab, the
    carry reduced by ``timeline_reduce`` (the CUDA kernel on the card),
    then ``_finalize``."""
    from repro_torch.kernels.ufa.reduce import timeline_reduce

    s = _schedule(c, p)
    col = lambda d: {k: (v[:, None] if torch.is_tensor(v) and v.dim() == 1
                         else v) for k, v in d.items()}
    core = _instant_core(c, col(p), col(s), ts[None, :])
    S, T = p["traffic_mult"].shape[0], ts.shape[0]
    tc = c["tier_class"]
    tier_total = _max(tc[:, 0] + tc[:, 1] + tc[:, 2] + tc[:, 3], 1e-9)
    carry = timeline_reduce(
        core["availability"].expand(S, T), core["util_model"].expand(S, T),
        core["cloud_used"].expand(S, T),
        (core["tier_live"] / tier_total).expand(S, T, -1), ts,
        thresh=RESTORE_THRESH)
    return _finalize(c, p, s, carry, ts)
