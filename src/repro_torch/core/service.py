"""Service / workload model and paper-scale fleet synthesis.

A ``ServiceSpec`` is the UFA unit of management: a service-environment with a
tier, a failure class, a replica footprint and RPC dependencies.  The fleet
synthesizer reproduces the paper's shape: per-tier service counts (Table 3),
per-tier core budgets (Table 1) and tier-biased cross-tier call volumes
(Table 2), at a configurable scale factor so tests run in milliseconds and
benchmarks at paper scale.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, List, Optional, Tuple

from repro_torch.core.tiers import (BASELINE_CORES, DEFAULT_CLASS_OF_TIER,
                              SERVICES_PER_TIER, FailureClass, Tier)


@dataclasses.dataclass
class ServiceSpec:
    name: str
    tier: Tier
    failure_class: FailureClass
    cores_per_replica: float
    replicas: int                      # per region, steady state
    mem_per_core_gb: float = 4.0
    deps: List[str] = dataclasses.field(default_factory=list)
    # per-dependency behavior when the callee is unavailable:
    # True = fail-open (degrades gracefully), False = fail-close (UNSAFE)
    fail_open: Dict[str, bool] = dataclasses.field(default_factory=dict)
    # ML-workload annotation (examples / serving integration)
    arch_id: Optional[str] = None

    @property
    def cores(self) -> float:
        return self.cores_per_replica * self.replicas

    def unsafe_deps(self) -> List[str]:
        return [d for d in self.deps if not self.fail_open.get(d, True)]


# Table 2, collapsed to P(callee_tier | caller_tier) — used to synthesize a
# call graph whose cross-tier volume distribution matches the paper's.
_T = list(Tier)
_TABLE2 = {  # rows: caller, cols: callee (requests, arbitrary units)
    Tier.T0: [47.1, 940, 2300, 1820, 144, 100, 1770],
    Tier.T1: [10.7, 21800, 2240, 387, 6.07, 70.4, 18600],
    Tier.T2: [25.3, 2020, 663, 77.0, 0.0309, 1.17, 2700],
    Tier.T3: [7.95, 288, 119, 16.9, 0.192, 6.09, 1060],
    Tier.T4: [0.788, 11.5, 0.599, 0.228, 1.19, 0.0121, 22.1],
    Tier.T5: [0.29, 76.1, 0.266, 0.849, 0.0013, 4.52, 14.1],
    Tier.NP: [107, 1530, 471, 126, 12.8, 18.3, 3130],
}


def synthesize_fleet(scale: float = 0.02, seed: int = 0,
                     unsafe_fraction: float = 0.08,
                     mean_deps: float = 6.0,
                     demand_fraction: float = 0.25,
                     as_arrays: bool = False,
                     unsafe_chain_fraction: float = 0.0):
    """Builds a fleet whose tier structure matches Tables 1-3.

    scale: fraction of the paper's service counts (0.02 -> ~440 services).
    unsafe_fraction: fraction of *tier-inverted* edges that are fail-close
    (the defects UFA's tooling must find before oversubscription is safe).
    demand_fraction: Table 1 reports *global, 2x-provisioned allocations*;
    per-region steady-state demand is allocation/2 (strip the failover
    buffer) /2 (each region serves half the cities) = 0.25.
    as_arrays: return a struct-of-arrays ``FleetState`` instead of a dict
    of ServiceSpecs — the fast path that makes scale=1.0 (~22k services)
    synthesize in a fraction of a second (array-native RNG; same tier
    structure, different draw order than the object path).
    unsafe_chain_fraction: fraction of critical->critical edges that are
    fail-close *relay* edges — harmless alone, but they carry breakage
    multiple hops up the call graph (see ``repro_torch.graph``); 0.0 keeps the
    seed's one-hop fleet shape and RNG stream.
    """
    if as_arrays:
        from repro_torch.core.fleet_state import synthesize_fleet_state
        return synthesize_fleet_state(
            scale=scale, seed=seed, unsafe_fraction=unsafe_fraction,
            mean_deps=mean_deps, demand_fraction=demand_fraction,
            unsafe_chain_fraction=unsafe_chain_fraction)
    rng = random.Random(seed)
    fleet: Dict[str, ServiceSpec] = {}
    by_tier: Dict[Tier, List[str]] = {t: [] for t in _T}

    for tier in _T:
        n = max(2, int(round(SERVICES_PER_TIER[tier] * scale)))
        tier_cores = BASELINE_CORES[tier] * scale * demand_fraction
        # skewed footprint: few heavy services, many light (lognormal)
        weights = [rng.lognormvariate(0, 1.2) for _ in range(n)]
        wsum = sum(weights)
        for i in range(n):
            name = f"{tier.name.lower()}-svc-{i:04d}"
            cores = tier_cores * weights[i] / wsum
            options = [c for c in (0.5, 1.0, 2.0, 4.0) if c <= 2 * cores]
            cores_per_replica = rng.choice(options or [0.5])
            replicas = max(1, int(round(cores / cores_per_replica)))
            fleet[name] = ServiceSpec(
                name=name, tier=tier,
                failure_class=DEFAULT_CLASS_OF_TIER[tier],
                cores_per_replica=cores_per_replica, replicas=replicas)
            by_tier[tier].append(name)

    # dependency edges, callee tier ~ Table 2 row of the caller tier
    for name, spec in fleet.items():
        row = _TABLE2[spec.tier]
        total = sum(row)
        n_deps = max(0, int(rng.gauss(mean_deps, 2)))
        for _ in range(n_deps):
            r = rng.uniform(0, total)
            acc = 0.0
            callee_tier = _T[-1]
            for t, w in zip(_T, row):
                acc += w
                if r <= acc:
                    callee_tier = t
                    break
            candidates = by_tier[callee_tier]
            callee = rng.choice(candidates)
            if callee == name or callee in spec.deps:
                continue
            spec.deps.append(callee)
            # tier-inverted edges (critical -> preemptible) may be fail-close
            inverted = (spec.failure_class.survives_failover and
                        fleet[callee].failure_class.preemptible)
            # critical -> critical relay edges (multi-hop chains); the
            # nested guard keeps the RNG stream untouched when the chain
            # fraction is 0.0 (seed-pinned fleets stay identical)
            chain = (unsafe_chain_fraction > 0.0 and not inverted
                     and spec.failure_class.survives_failover
                     and fleet[callee].failure_class.survives_failover)
            if inverted and rng.random() < unsafe_fraction:
                spec.fail_open[callee] = False
            elif chain and rng.random() < unsafe_chain_fraction:
                spec.fail_open[callee] = False
            else:
                spec.fail_open[callee] = True
    return fleet


def apply_ufa_target_classes(fleet: Dict[str, ServiceSpec]) -> int:
    """Paper Table 5 end-state classification: the "Tier1+ Active-Migrate"
    rollout phase (455K cores returned) moved T1 off the dedicated 2x
    buffer.  Re-class T1 Always-On -> Active-Migrate (T0 keeps its 2x
    buffer); returns the number of re-classed services."""
    n = 0
    for s in fleet.values():
        if s.tier == Tier.T1 and s.failure_class == FailureClass.ALWAYS_ON:
            s.failure_class = FailureClass.ACTIVE_MIGRATE
            n += 1
    return n


def fleet_cores(fleet: Dict[str, ServiceSpec]) -> Dict[Tier, float]:
    out = {t: 0.0 for t in _T}
    for s in fleet.values():
        out[s.tier] += s.cores
    return out


def tier_inverted_edges(fleet: Dict[str, ServiceSpec]) -> List[Tuple[str, str]]:
    """(caller, callee) edges from surviving classes into preemptible ones."""
    out = []
    for s in fleet.values():
        if not s.failure_class.survives_failover:
            continue
        for d in s.deps:
            # callee may have been re-classed; look up live
            out.append((s.name, d))
    return out


def unsafe_edges(fleet: Dict[str, ServiceSpec]) -> List[Tuple[str, str]]:
    out = []
    for s in fleet.values():
        for d in s.unsafe_deps():
            out.append((s.name, d))
    return out
