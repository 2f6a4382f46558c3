"""Array-native discrete-time failover timeline: per-step traces and
summary verdicts for a batch of scenarios, hard or soft-relaxed.

Port of ``repro/core/timeline_sim.py``.  The reference scans a step
function over the 240-step grid per scenario; here the per-step series
(``_instant_core``, and ``_instant`` on top of it for the traces) is
closed-form in ``t`` once a scenario's schedule (``_schedule``) is
known, so it is evaluated for the whole ``(S, T)`` slab at once, with
no Python loop over steps.  The scan carry (the reference's ``_carry0``
/ ``_carry_step``) is not written as a loop either: it is one call of
the verdict-reduction kernel (``kernels/ufa/reduce.py``:
``timeline_reduce``, with ``ref_timeline_reduce`` its plain version on
the CPU) over the same core series, so a sweep's summary is bit for bit
the same with and without traces.  Every op of the schedule, the series
and ``_finalize`` is the reference's op on float32 tensors, in the
reference's order: booleans, counts and restore times are exact, the
availability integral is a float32 sum in another order
(float32-tight), and other floats match to the last bit, within which
the reference's compiled CPU program can differ where it fuses a
multiply-add.  Divisions by a constant go through a float32 tensor
(``scenarios._div``).

Entry points: ``simulate_timeline`` (one scenario, any increasing time
grid), ``sweep_timeline`` (a grid, in chunks of the engine's ``CHUNK``
scenarios, with or without traces), ``timeline_verdicts`` (one
scenario's summary) and ``summarize_timeline_sweep`` (host).
Aggregation semantics and the ``EPS_T`` time tolerance are the
reference's (see its module docstring).

The soft relaxation (``tau``, for the capacity optimizer) is the
reference's: every hard comparison becomes ``soft_ge``, a sigmoid of the
signed margin.  The reference's soft mode runs its sequential scan; here
the soft ``(S, T)`` series is built under ``tau``, its first crossings
(no gradient) come from the same ``timeline_reduce`` as the hard path,
and the float accumulators that carry gradients are torch ops
(``_soft_carry``), the availability integral summed in the scan's
order.  ``tau=None`` runs the hard ops, unchanged.

The constants ``c`` are one fleet's 0-d tensors, or per-row ``(S,)``
tensors with ``tier_class`` ``(S, R, C)`` (the optimizer's CEM scores a
whole population of designs as one batch).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.fleet_state import (AM, AO, POOL_OVERCOMMIT,
                                          POOL_STATELESS, RL, TM)
from repro_torch.core.scenarios import _div, scenario_grid
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
# Soft relaxation (opt-in): sigmoid-smoothed SLA indicators.  Passing a
# temperature ``tau`` replaces every hard comparison with a sigmoid of the
# signed margin, in units of a per-quantity scale times tau; the verdicts
# become floats in (0, 1) that tend to the exact booleans as tau -> 0.
# ``tau=None`` (the default) runs the original ops.
# ---------------------------------------------------------------------------

SOFT_TIME_SCALE = 60.0          # seconds: deadline margins
SOFT_FRAC_SCALE = 0.02          # utilization / fraction margins
SOFT_AVAIL_SCALE = 2.0e-5       # availability-integral margins
SOFT_CORES_FRAC = 0.01          # cores margins, as a fraction of fleet total
SOFT_DEP_SCALE = 1e-6           # broken-critical fractions (quantized at
                                # 1/n_crit, so the pass threshold sits at
                                # 1e-7 — below one broken service)


def soft_ge(x, y, scale, tau):
    """Soft indicator of ``x >= y``: sigmoid of the margin in units of
    ``scale * tau`` (``tau`` a float32 tensor).  Tends to the hard
    boolean as ``tau -> 0``."""
    return torch.sigmoid((x - y) / (scale * tau))


def _cores_scale(c: Dict):
    """Cores-margin scale for one fleet: 1% of the class total."""
    return SOFT_CORES_FRAC * (c["ao"] + c["am"] + c["rl"] + c["tm"])


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

    def tier_totals(self) -> np.ndarray:
        """Per-tier spec cores summed over failure classes — the
        denominator turning the kernel's ``tier_live`` traces into live
        fractions (``serving.failover`` actuates replicas from these)."""
        return np.asarray(self.tier_class_cores, np.float64).sum(axis=1)

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


def _schedule(c: Dict, p: Dict, tau=None) -> Dict:
    """Scenario-level event times and capacity splits, elementwise over
    the scenario axis (every ``p`` leaf has the same shape).  ``tau``: the
    feasibility booleans (``ao_ok``) become sigmoid indicators and the
    infinite ``rl_done_t`` on a cloud-quota shortfall a smooth finite
    overrun; ``None`` runs the original ops."""
    mult = p["traffic_mult"]
    evict = p["evict_fraction"]

    # partial-region degradation; ``x * (1 - 0)`` is exact in float32
    cap_scale = 1.0 - p.get("region_degradation", 0.0)
    stateless_eff = c["stateless_cap"] * cap_scale

    burst_cap = c["burst_cap_full"] * p["burst_availability"]
    ramp_total = burst_cap / _max(c["spawn_rate"], 1e-9)
    tick_s = _div(ramp_total, 10.0)
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
    if tau is None:
        ao_ok = ao_need <= free_at_am_done + 1e-6
    else:
        ao_ok = soft_ge(free_at_am_done + 1e-6, ao_need, _cores_scale(c),
                        tau)
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
    rl_ok_soft = None
    if tau is None:
        rl_done_t = torch.where(
            rl_shortfall > 1e-6, float("inf"),
            torch.maximum(rl_last_wave_t,
                          torch.where(total_cloud > 1e-6, cloud_arrival_t,
                                      0.0)))
    else:
        # the beyond-quota remainder provisions at the cloud rate (a
        # finite, monotone overrun past the RTO), and the "any cloud at
        # all" gate softens over ~1 core
        cloud_gate = soft_ge(total_cloud, 0.5, 0.25, tau)
        rl_done_t = (torch.maximum(rl_last_wave_t,
                                   cloud_gate * cloud_arrival_t)
                     + rl_shortfall / _max(c["cloud_rate"], 1e-2))
        # the signed no-shortfall margin, folded into rl_rto_met
        rl_ok_soft = soft_ge(0.0, rl_need - burst_free_rl - quota_eff,
                             _cores_scale(c), tau)

    return {"burst_cap": burst_cap, "tick_s": tick_s,
            "rl_ok_soft": rl_ok_soft,
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


def _instant_core(c: Dict, p: Dict, s: Dict, t, tau=None) -> Dict:
    """The per-step series the scan carry consumes (availability, the
    demand-model utilization, the cloud draw, per-tier live cores) plus
    the intermediates the trace-only extras derive from, elementwise:
    ``p``/``s`` leaves of shape ``(S, 1)`` against ``t`` of shape
    ``(1, T)`` give ``(S, T)`` series and ``tier_live`` of shape
    ``(S, T, R)``.  ``tau`` softens the knob-dependent time gates and the
    QoS penalty step; ``None`` runs the original ops."""
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
    if tau is None:
        ao_scaled = s["ao_ok"] & (t >= s["am_done_t"] - EPS_T)
        ao_live = c["ao"] * torch.where(ao_scaled, mult, 1.0)
    else:
        ao_scaled = s["ao_ok"] * soft_ge(t, s["am_done_t"] - EPS_T,
                                         SOFT_TIME_SCALE, tau)
        ao_live = c["ao"] * (1.0 + ao_scaled * (mult - 1.0))

    # Restore-Later waves: burst first, the cloud batch after provisioning
    rl_waves_done = torch.minimum(
        _max(torch.floor((t - s["burst_full_t"] + EPS_T) / c["rl_wave_s"]),
             0.0),
        s["n_rl_waves"])
    processed = s["rl_need"] * rl_waves_done / s["n_rl_waves"]
    rl_burst = torch.minimum(processed, s["burst_free_rl"])
    cloud_req = processed - rl_burst
    cloud_prov = torch.minimum(cloud_req, s["quota_eff"])
    if tau is None:
        cloud_arrived = torch.where(t >= s["cloud_arrival_t"] - EPS_T,
                                    s["total_cloud"], 0.0)
    else:
        cloud_arrived = s["total_cloud"] * soft_ge(
            t, s["cloud_arrival_t"] - EPS_T, SOFT_TIME_SCALE, tau)
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
    if tau is None:
        util_pen = torch.where(util_model > QOS_EVICT_UTILIZATION, 1e-4,
                               0.0)
    else:
        util_pen = 1e-4 * soft_ge(util_model, QOS_EVICT_UTILIZATION,
                                  SOFT_FRAC_SCALE, tau)
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
        term = c["tier_class"][..., k] * frac[..., None]
        tier_live = term if tier_live is None else tier_live + term

    return {"e": e, "evicted": evicted, "am_envs_moved": am_envs_moved,
            "am_moved": am_moved, "ao_scaled": ao_scaled,
            "ao_live": ao_live, "rl_restored": rl_restored,
            "rl_burst": rl_burst, "rl_live": rl_live, "tm_live": tm_live,
            "am_steady_cores": am_steady_cores,
            "cloud_used": cloud_prov, "util_model": util_model,
            "availability": availability, "tier_live": tier_live}


def _instant(c: Dict, p: Dict, s: Dict, t, k: Dict) -> Dict:
    """All per-step series (the reference's ``_instant``): the core
    series ``k`` of ``_instant_core(c, p, s, t)`` plus the trace-only
    extras (pool accounting, env counts, the conversion ramp, physical
    utilization), in the same ``(S, 1)`` against ``(1, T)`` layout."""
    mult = p["traffic_mult"]
    e = k["e"]

    # burst conversion ramp (10 spawner ticks, orchestrator semantics)
    ticks = torch.clamp(torch.floor((t - p["burst_delay_s"] + EPS_T)
                                    / _max(s["tick_s"], 1e-9)), 0.0, 10.0)
    burst_online = _div(s["burst_cap"] * ticks, 10.0)
    burst_capacity = torch.where(t >= p["burst_delay_s"] - EPS_T,
                                 s["burst_cap"], 0.0)

    ao_extra = torch.where(k["ao_scaled"], s["ao_need"], 0.0)

    # placed-pool accounting
    steady_used = (c["steady_used0"] - e * c["sl_preempt_cores"]
                   - k["am_moved"] * s["am_release_frac"] + ao_extra)
    overcommit_used = c["overcommit_used0"] - e * c["oc_preempt_cores"]
    burst_used = k["am_moved"] + k["rl_burst"]

    # env-count series (orchestrator snapshot names); round half to even
    # like jnp.round
    d_rl_t = torch.where(k["evicted"], p.get("rl_evict_delta", 0.0), 0.0)
    d_tm_t = torch.where(k["evicted"], p.get("tm_evict_delta", 0.0), 0.0)
    am_bursted = k["am_envs_moved"]
    am_steady = c["am_envs"] - am_bursted
    rl_bursted = torch.round(s["rl_envs_evicted"] * k["rl_restored"]
                             / _max(s["rl_need"], 1e-9))
    rl_not_bursted = torch.round((e + d_rl_t) * c["rl_envs"]) - rl_bursted
    rl_t_steady = torch.round((1.0 - e) * (c["rl_envs"] + c["tm_envs"])
                              - (d_rl_t * c["rl_envs"]
                                 + d_tm_t * c["tm_envs"]))
    terminated = torch.round((e + d_tm_t) * c["tm_envs"])

    # utilization, orchestrator-mirror (traffic multiplier on survivors)
    pre_steady = ((c["rl"] + c["tm"]) * (1.0 - e)
                  - (c["rl"] * d_rl_t + c["tm"] * d_tm_t))
    busy = (k["ao_live"] * _DEMAND_CRIT * mult
            + k["am_steady_cores"] * _DEMAND_CRIT * mult
            + pre_steady * _DEMAND_PRE)
    utilization = _min(
        busy / _max(c["phys_cores"] * s["cap_scale"], 1.0), 1.0)

    return {"steady_used": steady_used, "overcommit_used": overcommit_used,
            "burst_capacity": burst_capacity, "burst_online": burst_online,
            "burst_used": burst_used, "cloud_used": k["cloud_used"],
            "ao_live": k["ao_live"], "am_live": c["am"] + 0.0 * t,
            "rl_live": k["rl_live"], "tm_live": k["tm_live"],
            "am_steady": am_steady, "am_bursted": am_bursted,
            "rl_bursted": rl_bursted, "rl_not_bursted": rl_not_bursted,
            "rl_t_steady": rl_t_steady, "terminated": terminated,
            "utilization": utilization, "util_model": k["util_model"],
            "availability": k["availability"],
            "tier_live": k["tier_live"]}


def _finalize(c: Dict, p: Dict, s: Dict, carry: Dict, ts, tau=None) -> Dict:
    """Per-scenario summary/verdicts from the reduced carry.  ``tau``
    replaces the hard verdicts with sigmoid margins and the boolean AND
    with a product of indicators; ``None`` runs the original ops."""
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
    if tau is None:
        preempt_fit = preempt_resident <= oc_cap_s + 1e-6
        dep_ok = p["dep_broken_frac"] <= 0.0
        avail_ok = availability_mean >= BASE_AVAILABILITY - AVAIL_SLA_TOL
        util_ok = util_post <= QOS_EVICT_UTILIZATION
        rl_rto_met = s["rl_done_t"] <= c["rl_rto_s"] + EPS_T
        sla_ok = (s["ao_ok"] & rl_rto_met & preempt_fit & dep_ok & avail_ok
                  & util_ok & (s["am_done_t"] <= 30.0 * 60.0)
                  & (s["burst_full_t"] <= 20.0 * 60.0))
    else:
        cs = _cores_scale(c)
        preempt_fit = soft_ge(oc_cap_s + 1e-6, preempt_resident, cs, tau)
        dep_ok = soft_ge(1e-7, p["dep_broken_frac"], SOFT_DEP_SCALE, tau)
        avail_ok = soft_ge(availability_mean,
                           BASE_AVAILABILITY - AVAIL_SLA_TOL,
                           SOFT_AVAIL_SCALE, tau)
        util_ok = soft_ge(QOS_EVICT_UTILIZATION, util_post,
                          SOFT_FRAC_SCALE, tau)
        rl_rto_met = (soft_ge(c["rl_rto_s"] + EPS_T, s["rl_done_t"],
                              SOFT_TIME_SCALE, tau) * s["rl_ok_soft"])
        sla_ok = (s["ao_ok"] * rl_rto_met * preempt_fit * dep_ok
                  * avail_ok * util_ok
                  * soft_ge(30.0 * 60.0, s["am_done_t"],
                            SOFT_TIME_SCALE, tau)
                  * soft_ge(20.0 * 60.0, s["burst_full_t"],
                            SOFT_TIME_SCALE, tau))
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


def _col(d: Dict) -> Dict:
    """``(S, 1)`` views of a dict's per-row leaves (``(S, 1, R, C)`` for a
    per-row ``tier_class``); 0-d leaves and the fleet's ``(R, C)``
    ``tier_class`` stay as they are."""
    return {k: (v[:, None] if torch.is_tensor(v) and (
        v.dim() == 1 or (k == "tier_class" and v.dim() == 3)) else v)
        for k, v in d.items()}


def _series(c: Dict, p: Dict, ts: torch.Tensor, tau=None):
    """The schedule and the core series of a batch: ``p`` leaves
    ``(S,)`` float32, ``ts`` ``(T,)`` float32, all on one device.
    Returns the schedule, the ``(S, 1)`` views of ``p`` and of the
    schedule, and the core series (``(S, T)`` or broadcastable to it)."""
    s = _schedule(c, p, tau)
    pc, sc = _col(p), _col(s)
    return s, pc, sc, _instant_core(_col(c), pc, sc, ts[None, :], tau)


def _reduce(c: Dict, core: Dict, ts: torch.Tensor, S: int) -> Dict:
    """The carry of the core series through ``timeline_reduce`` (the
    CUDA kernel on the card)."""
    from repro_torch.kernels.ufa.reduce import timeline_reduce

    T = ts.shape[0]
    tc = c["tier_class"]
    tier_total = _max(tc[..., 0] + tc[..., 1] + tc[..., 2] + tc[..., 3],
                      1e-9)
    if tier_total.dim() == 2:                 # per-row constants
        tier_total = tier_total[:, None]
    return timeline_reduce(
        core["availability"].expand(S, T), core["util_model"].expand(S, T),
        core["cloud_used"].expand(S, T),
        (core["tier_live"] / tier_total).expand(S, T, -1), ts,
        thresh=RESTORE_THRESH)


def _summary(c: Dict, p: Dict, s: Dict, core: Dict, ts: torch.Tensor
             ) -> Dict:
    """``_reduce``, then ``_finalize``."""
    carry = _reduce(c, core, ts, p["traffic_mult"].shape[0])
    return _finalize(c, p, s, carry, ts)


def _soft_carry(c: Dict, core: Dict, ts: torch.Tensor, S: int) -> Dict:
    """The soft path's carry: the first crossings (no gradient) from
    ``timeline_reduce`` over the detached series, the float accumulators
    as differentiable torch ops.  The availability integral is summed
    step by step in float32, the reference scan's order, on every
    device: the soft verdicts' sigmoid of its margin (at scale
    ``SOFT_AVAIL_SCALE * tau``) turns one unit in the last place of the
    mean into ~3e-3 of a logit at tau 1, so a reordered sum would show
    in the verdicts and their gradients.  Min and max are exact in any
    order."""
    T = ts.shape[0]
    series = {k: core[k].expand(S, T)
              for k in ("availability", "util_model", "cloud_used")}
    carry = _reduce({"tier_class": c["tier_class"].detach()},
                    {**{k: v.detach() for k, v in series.items()},
                     "tier_live": core["tier_live"].detach()}, ts, S)
    avail = series["availability"]
    dt = _max(torch.diff(ts, prepend=ts[:1]), 0.0)
    avail_int = torch.zeros_like(avail[:, 0])
    for t in range(T):
        avail_int = avail_int + avail[:, t] * dt[t]
    return {**carry, "avail_int": avail_int,
            "avail_min": _min(avail.amin(dim=1), 1.0),
            "util_peak": _max(series["util_model"].amax(dim=1), 0.0),
            "cloud_peak": _max(series["cloud_used"].amax(dim=1), 0.0)}


def timeline_verdicts_batch(c: Dict, p: Dict, ts: torch.Tensor,
                            tau=None) -> Dict:
    """Summary verdicts for a BATCH of scenarios (every ``p`` leaf
    ``(S,)`` float32, ``ts`` ``(T,)`` float32, all on one device): the
    schedule and the per-step series for the whole ``(S, T)`` slab, the
    carry reduced by ``timeline_reduce`` (the CUDA kernel on the card),
    then ``_finalize``.  ``tau`` (a float32 tensor) runs the soft
    relaxation, differentiable in ``c`` and ``p``."""
    s, _, _, core = _series(c, p, ts, tau)
    if tau is None:
        return _summary(c, p, s, core, ts)
    carry = _soft_carry(c, core, ts, p["traffic_mult"].shape[0])
    return _finalize(c, p, s, carry, ts, tau)


def _simulate(c: Dict, p: Dict, ts: torch.Tensor) -> Tuple[Dict, Dict]:
    """A batch of scenarios (leaves as in ``timeline_verdicts_batch``):
    returns (per-step traces, per-scenario summary/verdicts).  Traces are
    ``(S, T)`` (``tier_live`` ``(S, T, R)``), some of them broadcast
    views; the summary is ``timeline_verdicts_batch``'s, from the same
    core series."""
    s, pc, sc, core = _series(c, p, ts)
    t = ts[None, :]
    S, T = p["traffic_mult"].shape[0], ts.shape[0]
    traces = {k: (v.expand(S, T, -1) if k == "tier_live"
                  else v.expand(S, T))
              for k, v in _instant(c, pc, sc, t, core).items()}
    return traces, _summary(c, p, s, core, ts)


def timeline_verdicts(c: Dict, p: Dict, ts: torch.Tensor, tau=None) -> Dict:
    """Summary verdicts for ONE scenario (0-d ``p`` leaves), run as a
    batch of one: the same ops as ``_simulate``'s summary, or (``tau``,
    a float32 tensor) the soft relaxation."""
    out = timeline_verdicts_batch(c, {k: v.reshape(1) for k, v in p.items()},
                                  ts, tau)
    return {k: v[0] for k, v in out.items()}


def _as_params(p: Dict[str, float], device) -> Dict[str, torch.Tensor]:
    """A scenario's parameters as 0-d float32 tensors on ``device``."""
    return {k: torch.tensor(np.float32(p[k]), device=device)
            for k in PARAM_KEYS}


def simulate_timeline(cfg: TimelineConfig,
                      params: Optional[Dict[str, float]] = None,
                      ts: Optional[np.ndarray] = None,
                      device=None) -> Dict[str, np.ndarray]:
    """Run ONE scenario timeline on ``device`` (default: the CUDA card);
    returns ``{"t": ts, traces..., summary scalars...}`` as numpy.  ``ts``
    may be any increasing grid — pass the orchestrator's snapshot times
    to compare against its ``Timeline``."""
    dev = resolve_device(device)
    base = default_scenario(burst_delay_s=cfg.preheat_s)
    params = dict(base, **(params or {}))
    ts = default_ts() if ts is None else np.asarray(ts, np.float64)
    p = {k: v.reshape(1) for k, v in _as_params(params, dev).items()}
    traces, summary = _simulate(
        cfg.as_consts(dev), p,
        torch.from_numpy(ts.astype(np.float32)).to(dev))
    out = {"t": ts}
    out.update({k: v[0].cpu().numpy() for k, v in traces.items()})
    out.update({k: v[0].cpu().numpy() for k, v in summary.items()})
    return out


def sweep_timeline(cfg: TimelineConfig,
                   grid: Optional[Dict[str, np.ndarray]] = None,
                   ts: Optional[np.ndarray] = None,
                   dep_broken_frac: Optional[np.ndarray] = None,
                   return_traces: bool = False,
                   device=None) -> Dict[str, np.ndarray]:
    """Temporal verdicts for every scenario in the grid on ``device``
    (default: the CUDA card): per-scenario time-to-restore per tier,
    availability integral vs 99.97%, peak on-demand cloud draw, and the
    SLA verdict — plus the full per-step traces (``trace_<series>``,
    and the grid ``t``) when ``return_traces``.

    The grid runs in chunks of ``sweep_engine.CHUNK`` scenarios, the
    last one short (no padding), so a chunk's working set stays near
    100 MB at any grid size; each chunk's traces are copied into numpy
    arrays allocated once for the whole grid.  ``grid`` defaults to
    ``scenarios.scenario_grid()``; ``dep_broken_frac`` folds the
    dependency-graph propagation verdicts into the availability trace."""
    from repro_torch.core.sweep_engine import CHUNK
    dev = resolve_device(device)
    grid = scenario_grid() if grid is None else grid
    n = validate_grid(grid)
    cols = {k: np.asarray(grid[k], np.float32)
            for k in PARAM_KEYS if k in grid}
    if dep_broken_frac is None:
        dep_broken_frac = grid.get("dep_broken_frac", np.zeros(n))
    cols["dep_broken_frac"] = np.asarray(dep_broken_frac, np.float32)
    defaults = default_scenario(burst_delay_s=cfg.preheat_s)
    for k in PARAM_KEYS:                       # missing axes -> defaults
        if k not in cols:
            cols[k] = np.full(n, defaults[k], np.float32)
    params = {k: torch.from_numpy(v).to(dev) for k, v in cols.items()}
    ts = default_ts() if ts is None else np.asarray(ts, np.float64)
    tsd = torch.from_numpy(ts.astype(np.float32)).to(dev)
    consts = cfg.as_consts(dev)
    meter = obs.enabled()            # one branch per sweep — free off
    t0 = time.perf_counter() if meter else 0.0
    traces = None
    chunks = []
    for lo in range(0, n, CHUNK):
        p = {k: v[lo:lo + CHUNK] for k, v in params.items()}
        if not return_traces:
            chunks.append(timeline_verdicts_batch(consts, p, tsd))
            continue
        tr, summary = _simulate(consts, p, tsd)
        chunks.append(summary)
        if traces is None:
            traces = {k: np.empty((n,) + tuple(v.shape[1:]), np.float32)
                      for k, v in tr.items()}
        for k, v in tr.items():
            torch.from_numpy(traces[k][lo:lo + CHUNK]).copy_(v)
    out = {k: torch.cat([c[k] for c in chunks]).cpu().numpy()
           for k in chunks[0]}
    if return_traces:
        out["t"] = ts
        out.update({f"trace_{k}": v for k, v in traces.items()})
    if meter:
        dt = time.perf_counter() - t0
        obs.inc("ufa_timeline_scenarios_total", n)
        if dt > 0:
            obs.set_gauge("ufa_timeline_scenarios_per_s", n / dt)
    return out


def summarize_timeline_sweep(result: Dict[str, np.ndarray]
                             ) -> Dict[str, object]:
    """Ensemble-level digest of a ``sweep_timeline`` result."""
    n = len(result["sla_ok"])
    finite_rl = result["rl_done_s"][np.isfinite(result["rl_done_s"])]
    return {
        "n_scenarios": n,
        "n_sla_ok": int(result["sla_ok"].sum()),
        "n_rl_rto_met": int(result["rl_rto_met"].sum()),
        "availability_mean_min": float(result["availability_mean"].min()),
        "availability_floor": float(result["availability_min"].min()),
        "worst_finite_rl_done_min": (float(finite_rl.max() / 60.0)
                                     if len(finite_rl) else float("nan")),
        "n_rl_never_restored": int(np.isinf(result["rl_done_s"]).sum()),
        "peak_cloud_cores_max": float(result["peak_cloud_cores"].max()),
        "worst_util_peak": float(result["util_peak"].max()),
    }
