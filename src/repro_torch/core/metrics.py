"""Availability / utilization / cores-returned accounting (paper §8).

Pulls together the fleet + orchestration models into the quantities the
paper reports: request availability through a failover window (Fig 8),
regional CPU utilization (Fig 10), fleet utilization growth (Fig 11), and
the phased cores-returned schedule (Table 5).
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, List, Optional, Tuple

from repro_torch.core.capacity import RegionCapacity
from repro_torch.core.omg import Orchestrator
from repro_torch.core.service import ServiceSpec
from repro_torch.core.tiers import BASELINE_CORES, FailureClass, Tier

BASELINE_AVAILABILITY = 0.9997   # ambient (paper Fig 8)


def availability_during_failover(fleet: Dict[str, ServiceSpec],
                                 orch: Orchestrator,
                                 n_samples: int = 48, seed: int = 3
                                 ) -> List[Tuple[float, float]]:
    """Core-flow availability sampled through the failover window.

    A critical request succeeds unless (a) ambient noise, (b) a fail-close
    dependency on a currently-down service fires, or (c) Always-On capacity
    is short (only if the orchestrator reported a shortfall).
    """
    rng = random.Random(seed)
    tl = orch.timeline
    out: List[Tuple[float, float]] = []
    unsafe = [(s, d) for s in fleet.values()
              if s.failure_class.survives_failover
              for d in s.unsafe_deps()]
    crit_cores = sum(s.cores for s in fleet.values()
                     if s.failure_class.survives_failover)
    if not tl.t:
        return [(0.0, BASELINE_AVAILABILITY)]
    t_end = tl.t[-1]
    rl_down_windows = []
    for i, t in enumerate(tl.t):
        down = tl.series.get("rl_not_bursted", [0] * len(tl.t))[i]
        rl_down_windows.append((t, down))

    # sample times are nondecreasing and rl_down_windows is time-ascending,
    # so one merged sweep replaces the per-sample rescan: advance a shared
    # pointer to the last window at or before t (O(n+m) total, same
    # last-match semantics as the scan it replaced)
    n_win = len(rl_down_windows)
    j = -1
    for i in range(n_samples):
        t = t_end * i / max(1, n_samples - 1)
        avail = BASELINE_AVAILABILITY + rng.gauss(0, 2e-5)
        # fail-close cascade: weight by affected caller cores
        while j + 1 < n_win and rl_down_windows[j + 1][0] <= t:
            j += 1
        down_now = rl_down_windows[j][1] if j >= 0 else 0.0
        if down_now > 0 and unsafe:
            affected = sum(s.cores for s, d in unsafe
                           if fleet.get(d) is not None
                           and fleet[d].failure_class.preemptible)
            avail -= 0.9 * affected / max(1.0, crit_cores)
        if orch.report is not None and not orch.report.always_on_ok:
            avail -= 0.05
        out.append((t, max(0.0, min(1.0, avail))))
    return out


def regional_utilization_series(orch: Orchestrator, demand_level: float = 0.565
                                ) -> List[Tuple[float, float]]:
    """Fig 10: physical-core utilization of the surviving region.  At the
    failover peak the paper reports ~50.2% average."""
    tl = orch.timeline
    out = []
    for i, t in enumerate(tl.t):
        live_steady = tl.series["steady_used"][i] + tl.series["overcommit_used"][i]
        phys = orch.region.steady.physical_cores
        out.append((t, min(1.0, demand_level * live_steady / max(1.0, phys))))
    return out


# ---------------------------------------------------------------------------
# Phased rollout (Table 5, Fig 11)
# ---------------------------------------------------------------------------

# (phase label, class freed, cores returned) — straight from Table 5
TABLE5_PHASES: List[Tuple[str, str, int]] = [
    ("Terminate class", "terminate", 263_000),
    ("Tier4/5 Restore-Later class", "restore_later", 62_000),
    ("Tier3 Restore-Later class", "restore_later", 159_000),
    ("Tier2+ Active-Migrate class", "active_migrate", 92_000),
    ("Tier1+ Active-Migrate class", "active_migrate", 455_000),
]

TOTAL_RETURNED = sum(c for _, _, c in TABLE5_PHASES)      # 1.031M
BBM_CLASSES = {"terminate", "restore_later"}


def phased_rollout(baseline_cores: float = 4.18e6,
                   months: int = 11,
                   demand_growth: float = 0.17,
                   start_utilization: float = 0.20
                   ) -> Dict[str, object]:
    """Reproduces Table 5 + Fig 11: cores returned per phase, BBM/MBB split,
    and fleet utilization trajectory 20% -> ~31%."""
    busy0 = baseline_cores * start_utilization
    returned = 0.0
    series = []
    per_phase = []
    for i, (label, cls, cores) in enumerate(TABLE5_PHASES):
        returned += cores
        frac = (i + 1) / len(TABLE5_PHASES)
        busy = busy0 * (1.0 + demand_growth * frac)
        provisioned = baseline_cores - returned
        series.append((frac * months, busy / provisioned))
        per_phase.append({"phase": label, "class": cls, "cores": cores,
                          "cumulative": int(returned),
                          "utilization": busy / provisioned})
    bbm = sum(c for _, cls, c in TABLE5_PHASES if cls in BBM_CLASSES)
    mbb = TOTAL_RETURNED - bbm
    return {
        "per_phase": per_phase,
        "total_returned": TOTAL_RETURNED,
        "bbm_cores": bbm, "mbb_cores": mbb,
        "bbm_fraction": bbm / TOTAL_RETURNED,
        "mbb_fraction": mbb / TOTAL_RETURNED,
        "utilization_series": series,
        "final_utilization": series[-1][1],
        "provisioning_multiple_before": 2.0,
        "provisioning_multiple_after": 2.0 * (baseline_cores - TOTAL_RETURNED)
        / baseline_cores,
    }


def failover_minutes_history() -> Dict[int, float]:
    """Fig 2: yearly full-peak failover minutes (~<20h/yr on average, 0.23%
    of the year at the 2021 anomaly, declining trend)."""
    return {2020: 540.0, 2021: 1210.0, 2022: 420.0, 2023: 260.0}


def failover_counts_history() -> Dict[int, int]:
    """Fig 3: yearly regional failover counts (declining 2020-2023)."""
    return {2020: 24, 2021: 16, 2022: 13, 2023: 11}
