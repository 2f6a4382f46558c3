"""Scenario-ensemble failover analysis: the closed-form capacity model
over a batch of scenarios (hard path).

Port of ``repro/core/scenarios.py``.  ``_scenario_outcome`` is the
reference's per-scenario closed form written elementwise over the
scenario axis, op for op in the reference's order: booleans match the
reference exactly, floats to the last bit or within it where the
reference's compiled CPU program fuses a multiply-add (XLA contracts
``a * b + c`` on the CPU; PyTorch rounds the product and the sum
separately on the CPU and the card alike).  Divisions by a constant go
through a float32 tensor, never a Python number: PyTorch's CUDA division
by a host scalar multiplies by its reciprocal, which can differ from the
true quotient in the last bit.

Entry points on ``device=`` (default: the CUDA card): ``sweep_scenarios``
(the analytic model over a whole grid, or the fused ``SweepEngine`` with
``timeline=``) and ``sweep_with_dependency_ensemble`` (the blackhole
ensemble through the propagation kernel, or the engine with
``temporal=True``); on the host: ``scenario_grid``,
``operating_point_mask``, ``summarize_sweep`` and ``scenario_records``.

Scenario axes:
  traffic_mult        surviving-region traffic multiplier (paper: 2.0)
  burst_delay_s       preheat delay before burst capacity starts ramping
  burst_availability  fraction of batch capacity actually convertible
  cloud_quota_frac    multiplier on the region's cloud quota
  overcommit_factor   host-level overcommit (paper: 1.5, O_max 1.66)
  evict_fraction      fraction of preemptible demand actually evicted
"""

from __future__ import annotations

import dataclasses
import itertools
import zlib
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import capacity as C
from repro_torch.core.fleet_state import FleetState
from repro_torch.core.omg import Orchestrator
from repro_torch.core.tiers import (QOS_EVICT_UTILIZATION, RTO_SECONDS,
                                    FailureClass)
from repro_torch.kernels.backend import resolve_device

# single-source constants: orchestrator tunables + region-sizing rules
_SLACK = C.DEFAULT_SLACK
_SPAWN_CORES_PER_HOST_S = Orchestrator.SPAWN_CORES_PER_HOST_S
_BATCH_CORES_PER_HOST = C.BATCH_CORES_PER_HOST
_MBB_WAVE_S = Orchestrator.MBB_WAVE_S
_MBB_PARALLELISM = Orchestrator.MBB_PARALLELISM
_RL_WAVE_S = Orchestrator.RL_RESTORE_WAVE_S
_RL_RTO_S = RTO_SECONDS[FailureClass.RESTORE_LATER]
_QOS_EVICT = QOS_EVICT_UTILIZATION
_BASE_AVAILABILITY = 0.9997


# ---------------------------------------------------------------------------
# Stage seeds: JAX's threefry2x32 key derivation, on the host, bit-exact
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0: int, k1: int, x0: int, x1: int) -> tuple[int, int]:
    """Threefry-2x32 with 20 rounds on one counter pair — the block
    function of JAX's default PRNG (``threefry2x32_p``)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & _M32, (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def stage_seed(seed: int, stage: str) -> int:
    """Derive an independent integer seed for a named pipeline stage from
    one campaign seed — equal to the reference's
    ``randint(fold_in(PRNGKey(seed), crc32(stage) & 0x7FFFFFFF), (), 0,
    2**31 - 1)`` under JAX's default PRNG (threefry2x32, partitionable
    key derivation, 32-bit mode), computed here without JAX:

    * ``PRNGKey(seed)`` is the key ``(0, seed mod 2**32)``;
    * ``fold_in(key, d)`` is ``threefry(key, (0, d))``;
    * ``randint`` splits the key into ``threefry(key, (0, 0))`` and
      ``threefry(key, (0, 1))``, draws 32 bits from each as the XOR of
      ``threefry(subkey, (0, 0))``, and reduces them modulo the span with
      JAX's uint32 arithmetic."""
    def bits32(k):
        y0, y1 = _threefry2x32(*k, 0, 0)
        return y0 ^ y1

    key = _threefry2x32(0, seed & _M32, 0,
                        zlib.crc32(stage.encode()) & 0x7FFFFFFF)
    hi_bits = bits32(_threefry2x32(*key, 0, 0))
    lo_bits = bits32(_threefry2x32(*key, 0, 1))
    span = np.iinfo(np.int32).max            # maxval - minval, minval 0
    mult = (((1 << 16) % span) ** 2 & _M32) % span
    offset = ((((hi_bits % span) * mult) & _M32) + lo_bits % span) & _M32
    return int(offset % span)


@dataclasses.dataclass(frozen=True)
class FleetAggregates:
    """Class-level core/env totals — all the analytic model needs."""
    ao_cores: float
    am_cores: float
    rl_cores: float
    tm_cores: float
    am_envs: int
    rl_envs: int

    @property
    def total_cores(self) -> float:
        return self.ao_cores + self.am_cores + self.rl_cores + self.tm_cores

    @classmethod
    def from_fleet_state(cls, fs: FleetState) -> "FleetAggregates":
        from repro_torch.core.fleet_state import AM, RL
        ao, am, rl, tm = fs.class_core_totals()
        return cls(ao_cores=ao, am_cores=am, rl_cores=rl, tm_cores=tm,
                   am_envs=int(np.count_nonzero(fs.fclass == AM)),
                   rl_envs=int(np.count_nonzero(fs.fclass == RL)))

    @classmethod
    def from_fleet(cls, fleet: Dict[str, "object"]) -> "FleetAggregates":
        fs = FleetState.from_specs(fleet)
        return cls.from_fleet_state(fs)


def scenario_grid(traffic_mult=(1.6, 1.8, 2.0, 2.2),
                  burst_delay_s=(180.0, 270.0, 360.0, 600.0),
                  burst_availability=(1.0, 0.85, 0.7, 0.5),
                  cloud_quota_frac=(1.0, 0.5, 0.25, 0.0),
                  overcommit_factor=(1.5,),
                  evict_fraction=(1.0,)) -> Dict[str, np.ndarray]:
    """Cartesian scenario grid, flattened to parallel parameter arrays
    (defaults: 4^4 = 256 variants around the paper's operating point)."""
    axes = dict(traffic_mult=traffic_mult, burst_delay_s=burst_delay_s,
                burst_availability=burst_availability,
                cloud_quota_frac=cloud_quota_frac,
                overcommit_factor=overcommit_factor,
                evict_fraction=evict_fraction)
    rows = list(itertools.product(*axes.values()))
    cols = np.asarray(rows, np.float64).T
    return {k: cols[i] for i, k in enumerate(axes)}


def operating_point_mask(grid: Dict[str, np.ndarray]) -> np.ndarray:
    """Boolean mask selecting the paper's operating point in a scenario
    grid: 2x traffic, normal preheat, full burst, full cloud quota, full
    eviction — the single scenario the event-driven orchestrator runs."""
    return ((np.asarray(grid["traffic_mult"]) == 2.0)
            & (np.asarray(grid["burst_delay_s"]) == 270.0)
            & (np.asarray(grid["burst_availability"]) == 1.0)
            & (np.asarray(grid["cloud_quota_frac"]) == 1.0)
            & (np.asarray(grid["evict_fraction"]) == 1.0))


def _div(x: torch.Tensor, v: float) -> torch.Tensor:
    """``x / v`` for a Python constant ``v``, as a true float32 quotient
    on every device (see the module docstring)."""
    return x / torch.full((), v, dtype=torch.float32, device=x.device)


def _scenario_outcome(consts: Dict[str, torch.Tensor],
                      p: Dict[str, torch.Tensor],
                      tau=None) -> Dict[str, torch.Tensor]:
    """SLA outcome of a batch of scenarios (every ``p`` leaf ``(S,)``
    float32; ``consts`` float32 scalars, or ``(S,)`` per-row tensors, on
    the same device).  ``tau`` (a float32 tensor, opt-in): the boolean
    verdicts become sigmoid indicators of the signed margins and
    ``sla_ok`` their product (``timeline_sim.soft_ge``), differentiable;
    ``None`` runs the original ops."""
    from repro_torch.core.timeline_sim import (SOFT_DEP_SCALE,
                                               SOFT_FRAC_SCALE,
                                               SOFT_TIME_SCALE, soft_ge)
    ao, am = consts["ao"], consts["am"]
    rl, tm = consts["rl"], consts["tm"]
    am_envs, rl_envs = consts["am_envs"], consts["rl_envs"]

    mult = p["traffic_mult"]
    oc = p["overcommit_factor"]
    evict = p["evict_fraction"]
    # eviction-order shifts: per-class deltas on the evicted fraction,
    # additive so a present-but-zero knob is exact
    d_rl = p.get("rl_evict_delta", 0.0)
    d_tm = p.get("tm_evict_delta", 0.0)
    if tau is not None:
        cs = 0.01 * (ao + am + rl + tm)      # cores-margin scale (soft)

    # region sizing (same rule as RegionCapacity.for_fleet, model="ufa");
    # an optional ``ao_buffer`` const replaces the 2x Always-On buffer
    buf = consts["ao_buffer"] if "ao_buffer" in consts else 2.0
    stateless = (buf * ao + am) * _SLACK
    # partial-region degradation; x * (1 - 0) is exact in float32
    if "region_degradation" in p:
        stateless = stateless * (1.0 - p["region_degradation"])
    oc_cap = stateless * (oc - 1.0)
    preempt_resident = ((rl + tm) * (1.0 - evict)
                        - (rl * d_rl + tm * d_tm))
    if tau is None:
        preempt_fit = preempt_resident <= oc_cap + 1e-6
    else:
        preempt_fit = soft_ge(oc_cap + 1e-6, preempt_resident, cs, tau)

    # batch -> burst conversion (same sizing rule as for_fleet); an
    # optional ``spawn_mult`` const scales the spawner throughput
    batch_cores = _div((am + rl) * C.BATCH_BURST_HEADROOM,
                       C.BATCH_PREEMPTIBLE_FRACTION)
    burst_cap = (batch_cores * C.BATCH_PREEMPTIBLE_FRACTION
                 * p["burst_availability"])
    spawn_rate = _div(_SPAWN_CORES_PER_HOST_S * batch_cores,
                      _BATCH_CORES_PER_HOST)
    if "spawn_mult" in consts:
        spawn_rate = spawn_rate * consts["spawn_mult"]
    burst_full_s = p["burst_delay_s"] + burst_cap / torch.clamp(spawn_rate,
                                                                min=1e-9)

    # Active-Migrate MBB into burst
    am_in_burst = torch.minimum(am, burst_cap)
    am_waves = torch.ceil(_div(am_envs, _MBB_PARALLELISM))
    am_done_s = burst_full_s + am_waves * _MBB_WAVE_S
    am_stranded = am - am_in_burst            # stays in steady if burst full

    # Always-On in-place scale-up into freed headroom
    free_after_am = stateless - ao - am + am_in_burst
    ao_need = ao * (mult - 1.0)
    ao_short = torch.clamp(ao_need - free_after_am, min=0.0)
    if tau is None:
        ao_ok = ao_short <= 1e-6
    else:
        # signed margin (ao_short is one-sided)
        ao_ok = soft_ge(free_after_am + 1e-6, ao_need, cs, tau)

    # Restore-Later: burst first, cloud (with provisioning latency) last
    burst_left = torch.clamp(burst_cap - am_in_burst, min=0.0)
    rl_need = rl * evict + rl * d_rl          # evicted RL demand to restore
    rl_in_burst = torch.minimum(rl_need, burst_left)
    cloud_need = rl_need - rl_in_burst
    quota = C.default_cloud_quota(rl) * p["cloud_quota_frac"]
    cloud_grant = torch.minimum(cloud_need, quota)
    rl_down = cloud_need - cloud_grant
    cloud_rate = torch.clamp(_div(rl, C.CLOUD_RATE_RL_DIVISOR),
                             min=C.CLOUD_RATE_FLOOR)
    cloud_delay = cloud_grant / cloud_rate
    rl_waves = torch.ceil(_div(rl_envs, _MBB_PARALLELISM))
    rl_done_s = burst_full_s + rl_waves * _RL_WAVE_S + cloud_delay
    if tau is None:
        rl_ok = (rl_down <= 1e-6) & (rl_done_s <= _RL_RTO_S)
    else:
        # signed fit margin: quota vs. what must come from the cloud, the
        # +1.0-core shift keeping the fully-served point in the ok tail
        rl_ok = (soft_ge(quota + 1.0, cloud_need, cs, tau)
                 * soft_ge(_RL_RTO_S, rl_done_s, SOFT_TIME_SCALE, tau))

    # surviving-region utilization at the post-migration peak
    busy = (ao * mult * 0.62 + am_in_burst * 0.0
            + am_stranded * 0.62 * mult + preempt_resident * 0.35)
    util_peak = busy / torch.clamp(stateless, min=1.0)
    if tau is None:
        util_ok = util_peak <= _QOS_EVICT
    else:
        util_ok = soft_ge(_QOS_EVICT, util_peak, SOFT_FRAC_SCALE, tau)

    # availability estimate: AO shortfall bites immediately; unrestored RL
    # degrades the fraction of critical flows that depend on it; every
    # critical service the propagation says breaks is down for the window
    crit = torch.clamp(ao + am, min=1.0)
    rl_exposure = 0.1 * rl_down / torch.clamp(rl, min=1.0)
    window_frac = torch.clamp(_div(rl_done_s, _RL_RTO_S), max=1.0)
    dep_broken = p["dep_broken_frac"]
    if tau is None:
        dep_ok = dep_broken <= 0.0
        util_pen = torch.where(util_ok, 0.0, 1e-4)
    else:
        # a 1e-7 threshold with a 1e-6 scale keeps "nothing broken" in the
        # ok tail and the smallest nonzero fraction firmly refused
        dep_ok = soft_ge(1e-7, dep_broken, SOFT_DEP_SCALE, tau)
        util_pen = 1e-4 * (1.0 - util_ok)
    availability = (_BASE_AVAILABILITY
                    - 0.5 * ao_short / crit
                    - rl_exposure * window_frac
                    - 0.5 * dep_broken
                    - util_pen)
    availability = torch.clamp(availability, 0.0, 1.0)
    if tau is None:
        sla_ok = (ao_ok & rl_ok & preempt_fit & dep_ok
                  & (am_done_s <= 30.0 * 60.0)
                  & (burst_full_s <= 20.0 * 60.0) & util_ok)
    else:
        sla_ok = (ao_ok * rl_ok * preempt_fit * dep_ok
                  * soft_ge(30.0 * 60.0, am_done_s, SOFT_TIME_SCALE, tau)
                  * soft_ge(20.0 * 60.0, burst_full_s, SOFT_TIME_SCALE, tau)
                  * util_ok)
    # cascading dependency storm: the storm's dark set re-breaks
    # ``storm_broken_frac`` of criticals with pulse amplitude
    # ``storm_refrac``; the closed form charges the exposure once
    if "storm_refrac" in p:
        storm_frac = p.get("storm_broken_frac", 0.0)
        storm_exposure = storm_frac * p["storm_refrac"]
        availability = torch.clamp(availability - 0.5 * storm_exposure,
                                   0.0, 1.0)
        if tau is None:
            storm_ok = storm_exposure <= 1e-6
            sla_ok = sla_ok & storm_ok
        else:
            storm_ok = soft_ge(1e-7, storm_exposure, SOFT_DEP_SCALE, tau)
            sla_ok = sla_ok * storm_ok
    out = {
        "dep_broken_frac": dep_broken,
        "dep_ok": dep_ok,
        "burst_full_s": burst_full_s,
        "am_done_s": am_done_s,
        "rl_done_s": rl_done_s,
        "rl_down_cores": rl_down,
        "cloud_grant_cores": cloud_grant,
        "cloud_delay_s": cloud_delay,
        "util_peak": util_peak,
        "ao_ok": ao_ok,
        "rl_ok": rl_ok,
        "preempt_fit": preempt_fit,
        "util_ok": util_ok,
        "availability": availability,
        "sla_ok": sla_ok,
    }
    if "storm_refrac" in p and "storm_broken_frac" in p:
        out["storm_ok"] = storm_ok
        out["storm_broken_frac"] = storm_frac
    return out


# public entry point: the fused sweep engine calls this on each chunk
scenario_outcome = _scenario_outcome


def analytic_consts(agg: FleetAggregates, *, ao_buffer=None,
                    spawn_mult=None, device=None) -> Dict[str, torch.Tensor]:
    """float32 constants for ``scenario_outcome`` on ``device`` (default:
    the CUDA card).  ``ao_buffer`` / ``spawn_mult`` (optional) add the
    capacity optimizer's keys; absent keys leave the original model."""
    dev = resolve_device(device)
    f = lambda v: torch.tensor(np.float32(v), device=dev)
    out = {"ao": f(agg.ao_cores), "am": f(agg.am_cores),
           "rl": f(agg.rl_cores), "tm": f(agg.tm_cores),
           "am_envs": f(agg.am_envs), "rl_envs": f(agg.rl_envs)}
    if ao_buffer is not None:
        out["ao_buffer"] = f(ao_buffer)
    if spawn_mult is not None:
        out["spawn_mult"] = f(spawn_mult)
    return out


def sweep_scenarios(agg: FleetAggregates,
                    grid: Optional[Dict[str, np.ndarray]] = None,
                    dep_broken_frac: Optional[np.ndarray] = None,
                    timeline: Optional[object] = None,
                    ts: Optional[np.ndarray] = None,
                    device=None) -> Dict[str, np.ndarray]:
    """Evaluate the failover model over every scenario on ``device``
    (default: the CUDA card), the whole grid in one pass.

    dep_broken_frac: optional per-scenario fraction of critical services
    the dependency-graph blackhole propagation says break (see
    ``sweep_with_dependency_ensemble``); defaults to 0 everywhere.

    timeline: optional ``timeline_sim.TimelineConfig`` — runs the fused
    ``SweepEngine`` instead, which adds the ``t_``-prefixed temporal
    verdicts to the analytic ones.  ``ts`` overrides the default
    2h/240-step grid."""
    from repro_torch.core.timeline_sim import validate_grid
    grid = grid if grid is not None else scenario_grid()
    n = validate_grid(grid)
    if timeline is not None:
        from repro_torch.core.sweep_engine import SweepEngine
        eng = SweepEngine(agg, timeline, ts=ts, device=device)
        return eng.run(grid, dep_broken_frac=dep_broken_frac)
    dev = resolve_device(device)
    consts = analytic_consts(agg, device=dev)
    up = lambda v: torch.from_numpy(np.asarray(v, np.float32)).to(dev)
    params = {k: up(v) for k, v in grid.items()}
    if dep_broken_frac is None:
        dep_broken_frac = np.zeros(n)
    params["dep_broken_frac"] = up(dep_broken_frac)
    out = _scenario_outcome(consts, params)
    result = {k: v.cpu().numpy() for k, v in out.items()}
    result.update({k: np.asarray(v) for k, v in grid.items()})
    return result


def sweep_with_dependency_ensemble(fs: FleetState,
                                   grid: Optional[Dict[str, np.ndarray]]
                                   = None,
                                   seed: int = 0,
                                   temporal: bool = False,
                                   region: Optional[object] = None,
                                   ts: Optional[np.ndarray] = None,
                                   device=None) -> Dict[str, np.ndarray]:
    """Scenario sweep with the dependency layer closed in, on ``device``
    (default: the CUDA card): each scenario's ``evict_fraction`` sets its
    blackhole intensity (shared uniform draws, so equal fractions share
    one dark set and differing fractions give nested sets); one batched
    multi-hop propagation certifies the whole ensemble and the
    per-scenario broken-critical fractions feed the availability
    estimate and SLA verdicts.

    temporal=True runs the fused ``SweepEngine`` instead (sizing a
    region for ``fs`` unless ``region`` is given), which folds the same
    propagation verdicts into the availability trace and adds the
    ``t_``-prefixed temporal verdicts.  Each stage draws from its own
    ``stage_seed`` of the one campaign seed."""
    from repro_torch.graph import CallGraph
    grid = grid if grid is not None else scenario_grid()
    graph = CallGraph.from_fleet_state(fs)
    agg = FleetAggregates.from_fleet_state(fs)
    if temporal:
        from repro_torch.core.sweep_engine import SweepEngine
        from repro_torch.core.timeline_sim import config_for_fleet
        timeline = config_for_fleet(fs, region=region)
        eng = SweepEngine(agg, timeline, graph=graph,
                          seed=stage_seed(seed, "sweep-engine"), ts=ts,
                          device=device)
        return eng.run(grid)
    from repro_torch.graph import blackhole_ensemble
    ens = blackhole_ensemble(graph,
                             seed=stage_seed(seed, "blackhole-ensemble"),
                             fractions=np.asarray(grid["evict_fraction"]),
                             device=device)
    result = sweep_scenarios(agg, grid,
                             dep_broken_frac=ens["broken_critical_frac"],
                             device=device)
    # int32, matching the fused temporal path's device-computed counts
    result["dep_n_broken_critical"] = np.asarray(ens["n_broken_critical"],
                                                 np.int32)
    result["dep_n_dark"] = np.asarray(ens["n_dark"], np.int32)
    return result


def summarize_sweep(result: Dict[str, np.ndarray]) -> Dict[str, object]:
    n = len(result["sla_ok"])
    ok = int(result["sla_ok"].sum())
    out = {
        "n_scenarios": n,
        "n_sla_ok": ok,
        "sla_ok_fraction": ok / max(1, n),
        "availability_min": float(result["availability"].min()),
        "availability_mean": float(result["availability"].mean()),
        "worst_rl_done_min": float(result["rl_done_s"].max() / 60.0),
        "worst_util_peak": float(result["util_peak"].max()),
    }
    if "dep_ok" in result:
        out["n_dep_ok"] = int(result["dep_ok"].sum())
        out["worst_dep_broken_frac"] = float(
            result["dep_broken_frac"].max())
    if "t_sla_ok" in result:        # temporal verdicts present
        finite = result["t_rl_done_s"][np.isfinite(result["t_rl_done_s"])]
        out["n_t_sla_ok"] = int(result["t_sla_ok"].sum())
        out["n_analytic_temporal_agree"] = int(
            (result["sla_ok"] == result["t_sla_ok"]).sum())
        out["t_availability_mean_min"] = float(
            result["t_availability_mean"].min())
        out["t_worst_finite_rl_done_min"] = (
            float(finite.max() / 60.0) if len(finite) else float("nan"))
        out["t_n_rl_never_restored"] = int(
            np.isinf(result["t_rl_done_s"]).sum())
        out["t_peak_cloud_cores_max"] = float(
            result["t_peak_cloud_cores"].max())
    return out


def scenario_records(result: Dict[str, np.ndarray]) -> list:
    """Per-scenario verdict rows (JSON-serializable) for the bench log."""
    keys = ["traffic_mult", "burst_delay_s", "burst_availability",
            "cloud_quota_frac", "overcommit_factor", "evict_fraction",
            "burst_full_s", "rl_done_s", "util_peak", "availability",
            "ao_ok", "rl_ok", "util_ok", "sla_ok"]
    n = len(result["sla_ok"])
    return [{k: (bool(result[k][i]) if result[k].dtype == bool
                 else round(float(result[k][i]), 6)) for k in keys}
            for i in range(n)]
