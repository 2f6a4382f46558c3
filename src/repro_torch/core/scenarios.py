"""Scenario-ensemble failover analysis: the closed-form capacity model
over a batch of scenarios (hard path).

Port of ``repro/core/scenarios.py``.  ``_scenario_outcome`` is the
reference's per-scenario closed form written elementwise over the
scenario axis, op for op in the reference's order: booleans match the
reference exactly, floats to the last bit or within it where the
reference's compiled CPU program fuses a multiply-add (XLA contracts
``a * b + c`` on the CPU; PyTorch rounds the product and the sum
separately on the CPU and the card alike).  Divisions by a constant go through a float32
tensor, never a Python number: PyTorch's CUDA division by a host scalar
multiplies by its reciprocal, which can differ from the true quotient
in the last bit.

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
from typing import Dict

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


def _div(x: torch.Tensor, v: float) -> torch.Tensor:
    """``x / v`` for a Python constant ``v``, as a true float32 quotient
    on every device (see the module docstring)."""
    return x / torch.full((), v, dtype=torch.float32, device=x.device)


def _scenario_outcome(consts: Dict[str, torch.Tensor],
                      p: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """SLA outcome of a batch of scenarios (every ``p`` leaf ``(S,)``
    float32; ``consts`` float32 scalars on the same device)."""
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
    preempt_fit = preempt_resident <= oc_cap + 1e-6

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
    ao_ok = ao_short <= 1e-6

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
    rl_ok = (rl_down <= 1e-6) & (rl_done_s <= _RL_RTO_S)

    # surviving-region utilization at the post-migration peak
    busy = (ao * mult * 0.62 + am_in_burst * 0.0
            + am_stranded * 0.62 * mult + preempt_resident * 0.35)
    util_peak = busy / torch.clamp(stateless, min=1.0)
    util_ok = util_peak <= _QOS_EVICT

    # availability estimate: AO shortfall bites immediately; unrestored RL
    # degrades the fraction of critical flows that depend on it; every
    # critical service the propagation says breaks is down for the window
    crit = torch.clamp(ao + am, min=1.0)
    rl_exposure = 0.1 * rl_down / torch.clamp(rl, min=1.0)
    window_frac = torch.clamp(_div(rl_done_s, _RL_RTO_S), max=1.0)
    dep_broken = p["dep_broken_frac"]
    dep_ok = dep_broken <= 0.0
    availability = (_BASE_AVAILABILITY
                    - 0.5 * ao_short / crit
                    - rl_exposure * window_frac
                    - 0.5 * dep_broken
                    - torch.where(util_ok, 0.0, 1e-4))
    availability = torch.clamp(availability, 0.0, 1.0)
    sla_ok = (ao_ok & rl_ok & preempt_fit & dep_ok
              & (am_done_s <= 30.0 * 60.0)
              & (burst_full_s <= 20.0 * 60.0) & util_ok)
    # cascading dependency storm: the storm's dark set re-breaks
    # ``storm_broken_frac`` of criticals with pulse amplitude
    # ``storm_refrac``; the closed form charges the exposure once
    if "storm_refrac" in p:
        storm_frac = p.get("storm_broken_frac", 0.0)
        storm_exposure = storm_frac * p["storm_refrac"]
        availability = torch.clamp(availability - 0.5 * storm_exposure,
                                   0.0, 1.0)
        storm_ok = storm_exposure <= 1e-6
        sla_ok = sla_ok & storm_ok
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
