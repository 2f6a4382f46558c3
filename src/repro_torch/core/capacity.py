"""Cluster capacity model: hosts, resource pools, placement, overcommit.

Implements the paper's §4.4 partitioning: each host advertises
``stateless.cpu`` (physical) plus ``overcommit.cpu`` (extended resource =
(factor-1) x physical), so preemptible pods schedule into reserved failover
headroom without interfering with critical placement.  Also the §4.5 batch
clusters that convert to "burst" capacity, and the §4.6 cloud pool with
quota + provisioning-latency semantics.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.core.tiers import (QOS_COOL_UTILIZATION, QOS_EVICT_UTILIZATION,
                              FailureClass, Tier, o_max)

# region-sizing constants shared with the analytic scenario model
DEFAULT_SLACK = 1.06               # fragmentation slack on steady sizing
BATCH_CORES_PER_HOST = 120.0
BATCH_BURST_HEADROOM = 1.35        # burst sized to hold (AM + RL) * this
BATCH_PREEMPTIBLE_FRACTION = 0.9


CLOUD_RATE_FLOOR = 10.0            # min cloud provisioning rate (cores/s)
CLOUD_RATE_RL_DIVISOR = 1200.0     # rate scales with the RL footprint


def default_cloud_quota(rl_cores: float) -> float:
    """Cloud quota a region is provisioned with (§4.6 sizing rule).
    Pure arithmetic — safe to call on jax tracers (scenario model)."""
    return 0.5 * rl_cores + 100.0


def default_cloud_rate(rl_cores: float) -> float:
    """Cloud provisioning rate (cores/s) for a region's RL footprint."""
    return max(CLOUD_RATE_FLOOR, rl_cores / CLOUD_RATE_RL_DIVISOR)


@dataclasses.dataclass
class PoolState:
    """Aggregate view of one scheduling pool (cores)."""
    capacity: float
    used: float = 0.0

    @property
    def free(self) -> float:
        return self.capacity - self.used

    def alloc(self, cores: float) -> bool:
        if cores > self.free + 1e-9:
            return False
        self.used += cores
        return True

    def release(self, cores: float):
        self.used = max(0.0, self.used - cores)


@dataclasses.dataclass
class Cluster:
    """A (region-local) cluster of identical hosts with two CPU pools."""
    name: str
    n_hosts: int
    cores_per_host: float
    overcommit_factor: float = 1.5
    mem_per_core_gb: float = 8.0

    def __post_init__(self):
        phys = self.n_hosts * self.cores_per_host
        self.stateless = PoolState(capacity=phys)
        self.overcommit = PoolState(
            capacity=phys * (self.overcommit_factor - 1.0))

    @property
    def physical_cores(self) -> float:
        return self.n_hosts * self.cores_per_host

    @property
    def advertised_cores(self) -> float:
        return self.stateless.capacity + self.overcommit.capacity

    def utilization(self, demand_fraction: float = 1.0) -> float:
        """Fraction of physical cores busy given current placements and a
        demand level (0..1) applied to allocated cores."""
        busy = (self.stateless.used + self.overcommit.used) * demand_fraction
        return min(1.0, busy / max(1.0, self.physical_cores))


@dataclasses.dataclass
class BatchCluster:
    """Batch (analytics/ML) cluster convertible to burst capacity (§4.5)."""
    name: str
    n_hosts: int
    cores_per_host: float
    preemptible_fraction: float = BATCH_PREEMPTIBLE_FRACTION
    converted: bool = False
    burst: Optional[PoolState] = None

    @property
    def convertible_cores(self) -> float:
        return self.n_hosts * self.cores_per_host * self.preemptible_fraction

    def convert(self) -> PoolState:
        self.converted = True
        self.burst = PoolState(capacity=self.convertible_cores)
        return self.burst

    def release(self):
        self.converted = False
        self.burst = None


@dataclasses.dataclass
class CloudPool:
    """On-demand cloud capacity with quota and slow provisioning (§4.6)."""
    quota_cores: float = 100_000.0
    provision_rate_cores_per_s: float = 300.0   # tens of thousands over ~minutes
    provisioned: float = 0.0
    used: float = 0.0

    def provision_time(self, cores: float) -> float:
        grant = min(cores, self.quota_cores - self.provisioned)
        return grant / self.provision_rate_cores_per_s

    def provision(self, cores: float) -> float:
        grant = min(cores, self.quota_cores - self.provisioned)
        self.provisioned += grant
        return grant

    def release_all(self):
        self.provisioned = 0.0
        self.used = 0.0


def safe_overcommit_bound(mem_per_host_core: float = 8.0,
                          mem_per_service_core: float = 4.0,
                          alpha_m: float = 0.75,
                          alpha_c: float = 0.90) -> float:
    """O_max from §4.4 — the memory-ratio ceiling on oversubscription."""
    return o_max(mem_per_host_core, mem_per_service_core, alpha_m, alpha_c)


@dataclasses.dataclass
class RegionCapacity:
    """All capacity in one region: steady-state + batch + cloud."""
    name: str
    steady: Cluster
    batch: BatchCluster
    cloud: CloudPool

    @classmethod
    def for_fleet(cls, name: str, fleet: "object",
                  overcommit_factor: float = 1.5,
                  slack: float = DEFAULT_SLACK,
                  model: str = "ufa") -> "RegionCapacity":
        """Size a region for a fleet (a dict of ServiceSpecs, or a
        ``FleetState`` whose class totals reduce in one pass).

        model="legacy": every tier gets a dedicated 2x buffer
            -> stateless = 2 * total_demand, no overcommit pool.
        model="ufa":   Always-On keeps a 2x buffer, Active-Migrate keeps 1x
            (its failover lands in burst), preemptible classes run in the
            overcommit pool -> stateless = 2*AO + AM.
        """
        if hasattr(fleet, "class_core_totals"):      # FleetState fast path
            ao, am, rl, tm = fleet.class_core_totals()
        else:
            ao = am = rl = tm = 0.0
            for s in fleet.values():
                fc = s.failure_class
                if fc == FailureClass.ALWAYS_ON:
                    ao += s.cores
                elif fc == FailureClass.ACTIVE_MIGRATE:
                    am += s.cores
                elif fc == FailureClass.RESTORE_LATER:
                    rl += s.cores
                else:
                    tm += s.cores
        if model == "legacy":
            stateless = 2.0 * (ao + am + rl + tm) * slack
            factor = 1.0
        else:
            stateless = (2.0 * ao + am) * slack
            factor = overcommit_factor
            # the overcommit pool must hold all preemptible demand
            assert stateless * (factor - 1.0) >= (rl + tm), (
                stateless, factor, rl + tm)
        n_hosts = max(4, math.ceil(stateless / 100.0))
        # burst must absorb AM (MBB) + RL (restore): batch sized accordingly
        batch_cores = (am + rl) * BATCH_BURST_HEADROOM \
            / BATCH_PREEMPTIBLE_FRACTION
        batch_hosts = max(2, math.ceil(batch_cores / BATCH_CORES_PER_HOST))
        return cls(
            name=name,
            steady=Cluster(f"{name}-steady", n_hosts=n_hosts,
                           cores_per_host=100.0, overcommit_factor=factor),
            batch=BatchCluster(f"{name}-batch", n_hosts=batch_hosts,
                               cores_per_host=BATCH_CORES_PER_HOST),
            cloud=CloudPool(quota_cores=default_cloud_quota(rl),
                            provision_rate_cores_per_s=default_cloud_rate(rl)),
        )


def provisioning_multiple(fleet_cores_steady: float,
                          region_physical: float) -> float:
    """Global provisioned-to-needed ratio (2x legacy -> 1.3x UFA goal)."""
    return 2 * region_physical / max(1.0, fleet_cores_steady)
