"""Service tiers, failure-behavior classes, and SLA/RTO tables.

Encodes the paper's Tables 1 and 4:

  - Tiers T0 (most critical) .. T5 (least critical), plus NP (non-production).
  - Failure classes: Always-On, Active-Migrate, Restore-Later, Terminate.
  - Default tier -> failure-class mapping used by UFA.
  - Baseline fleet core counts per tier (Table 1) used to synthesize a
    paper-scale fleet for the benchmarks.
"""

from __future__ import annotations

import enum
from typing import Dict


class Tier(enum.IntEnum):
    """Business-criticality tier. Lower value = higher priority."""
    T0 = 0   # Infrastructure and critical applications
    T1 = 1   # Critical trip flow
    T2 = 2   # Business critical applications
    T3 = 3   # Internal tools critical to applications
    T4 = 4   # Internal tools used by employees
    T5 = 5   # Test versions and the rest
    NP = 6   # Non-production (staging, shadow, ...)

    @property
    def is_critical(self) -> bool:
        return self in (Tier.T0, Tier.T1, Tier.T2)


class FailureClass(enum.Enum):
    """Behavior during a (peak) regional failover — paper Table 4."""
    ALWAYS_ON = "always_on"          # in-place expand into failover buffer; secs RTO
    ACTIVE_MIGRATE = "active_migrate"  # make-before-break live migration; secs RTO
    RESTORE_LATER = "restore_later"  # break-before-make; <= 1 hour RTO
    TERMINATE = "terminate"          # down until failback

    @property
    def preemptible(self) -> bool:
        return self in (FailureClass.RESTORE_LATER, FailureClass.TERMINATE)

    @property
    def survives_failover(self) -> bool:
        return self in (FailureClass.ALWAYS_ON, FailureClass.ACTIVE_MIGRATE)


# Default tier -> failure class mapping (paper §4: "typically T0/T1 Always-On,
# T2 Active-Migrate, T3-T5 Restore-Later, NP Terminate").
DEFAULT_CLASS_OF_TIER: Dict[Tier, FailureClass] = {
    Tier.T0: FailureClass.ALWAYS_ON,
    Tier.T1: FailureClass.ALWAYS_ON,
    Tier.T2: FailureClass.ACTIVE_MIGRATE,
    Tier.T3: FailureClass.RESTORE_LATER,
    Tier.T4: FailureClass.RESTORE_LATER,
    Tier.T5: FailureClass.RESTORE_LATER,
    Tier.NP: FailureClass.TERMINATE,
}

# Recovery-time objectives in (simulated) seconds — paper Table 4 + §3.
RTO_SECONDS: Dict[FailureClass, float] = {
    FailureClass.ALWAYS_ON: 1.0,          # sub-second to seconds
    FailureClass.ACTIVE_MIGRATE: 60.0,    # secs (migration window)
    FailureClass.RESTORE_LATER: 3600.0,   # up to 1 hour
    FailureClass.TERMINATE: float("inf"),  # restored only at failback
}

# Paper Table 1 — baseline steady-state CPU cores per tier (global).
BASELINE_CORES: Dict[Tier, int] = {
    Tier.T0: 201_000,
    Tier.T1: 3_030_000,
    Tier.T2: 400_000,
    Tier.T3: 254_000,
    Tier.T4: 23_100,
    Tier.T5: 22_100,
    Tier.NP: 249_000,
}

# Paper Table 3 — number of services per tier.
SERVICES_PER_TIER: Dict[Tier, int] = {
    Tier.T0: 96,
    Tier.T1: 607,
    Tier.T2: 561,
    Tier.T3: 1550,
    Tier.T4: 283,
    Tier.T5: 882,
    Tier.NP: 18_000,
}

TOTAL_BASELINE_CORES = sum(BASELINE_CORES.values())  # ~4.18M globally

# Provisioning multipliers (paper §3 goal state).
LEGACY_PROVISIONING = 2.0
UFA_PROVISIONING = 1.3

# Peak / full failover definitions (paper §2).
PEAK_TRAFFIC_FRACTION = 0.85    # riders-on-trip >= 85% of weekly peak
FULL_FAILOVER_CITY_FRACTION = 0.50  # > 50% of cities fail over

# QoS controller thresholds (paper §4.4).
QOS_EVICT_UTILIZATION = 0.75
QOS_COOL_UTILIZATION = 0.70

# Overcommit constants (paper §4.4).
MEM_PER_HOST_CORE_GB = 8.0      # M_h
MEM_PER_SERVICE_CORE_GB = 4.0   # M_s
SAFE_MEM_FRACTION = 0.75        # alpha_m
SAFE_CPU_FRACTION = 0.90        # alpha_c


def o_max(m_h: float = MEM_PER_HOST_CORE_GB, m_s: float = MEM_PER_SERVICE_CORE_GB,
          alpha_m: float = SAFE_MEM_FRACTION, alpha_c: float = SAFE_CPU_FRACTION
          ) -> float:
    """Maximum achievable overcommit O_max = (M_h/M_s) * (alpha_m/alpha_c)."""
    return (m_h / m_s) * (alpha_m / alpha_c)
