"""Validation drills (paper §5): dependency-safety certification and UFA
failover certification.

Dependency safety: graduated traffic blackholing (0% -> 100%) toward
Restore-Later/Terminate services; a critical service is certified only if
its error rate stays at baseline under complete dependency isolation.
Whether a service breaks under the blackhole comes from the graph
engine's *multi-hop* fixed-point propagation (``repro_torch.graph``):
fail-close chains relay failure any number of hops up the call graph, so a critical
service with no direct unsafe dependency still fails the drill if a
critical callee of it breaks.  The graduated error-rate model is then
vectorized over the whole fleet at once — one (steps x services) pass
certifies every critical service simultaneously at paper scale.

Failover certification: runs the end-to-end OMG workflow at peak and
non-peak and checks every class SLA; its availability verdict uses the
same propagation engine.

Host copy of ``repro/core/drills.py``.  The functions that certify
through the propagation kernel take ``device=`` (default: the CUDA
card) and pass it to ``graph.certify``.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.capacity import RegionCapacity
from repro_torch.core.fleet_state import RL, FleetState
from repro_torch.core.omg import FailoverReport, Orchestrator
from repro_torch.core.service import ServiceSpec
from repro_torch.core.tiers import RTO_SECONDS, FailureClass

BLACKHOLE_STEPS = (0.0, 0.1, 0.25, 0.5, 0.75, 1.0)
BASELINE_ERROR = 0.0003


@dataclasses.dataclass
class CertResult:
    service: str
    certified: bool
    failing_deps: List[str]
    max_error_rate: float


def _error_rate_under_blackhole(spec: ServiceSpec,
                                fleet: Dict[str, ServiceSpec],
                                fraction: float, rng: random.Random,
                                baseline: float = BASELINE_ERROR) -> float:
    """Scalar reference of the error model (kept for spot checks): caller
    error rate when `fraction` of traffic to preemptible callees is
    blackholed — fail-open deps degrade gracefully; fail-close propagate."""
    err = max(0.0, rng.gauss(baseline, 1e-4))
    for callee in spec.deps:
        c = fleet.get(callee)
        if c is None or not c.failure_class.preemptible:
            continue
        if not spec.fail_open.get(callee, True):
            err += fraction * 0.9      # hard failure propagates
    return min(1.0, err)


def _blackhole_worst(breaks: np.ndarray, seed: int,
                     error_budget: float) -> np.ndarray:
    """Worst observed error rate per caller over the graduated blackhole
    steps, with production semantics: the drill aborts at the first step
    whose error exceeds the budget.  ``breaks`` is the per-caller break
    indicator (>=1.0 where the multi-hop propagation says the service
    breaks under a full blackhole, 0.0 where it degrades gracefully)."""
    rng = np.random.default_rng(seed)
    fracs = np.asarray(BLACKHOLE_STEPS)
    n = len(breaks)
    noise = np.clip(rng.normal(BASELINE_ERROR, 1e-4, (len(fracs), n)),
                    0.0, None)
    errs = np.minimum(1.0, noise + fracs[:, None] * 0.9
                      * breaks[None, :])
    exceeded = errs > error_budget
    aborted = exceeded.any(axis=0)
    first = np.argmax(exceeded, axis=0)
    return np.where(aborted, errs[first, np.arange(n)], errs.max(axis=0))


def dependency_safety_certification(fleet: Dict[str, ServiceSpec],
                                    seed: int = 0,
                                    error_budget: float = 0.002,
                                    device=None
                                    ) -> Dict[str, CertResult]:
    """Graduated blackholing for every critical service (one vectorized
    pass over the whole fleet, multi-hop via the graph engine)."""
    from repro_torch.graph import CallGraph, certify
    graph = CallGraph.from_specs(fleet)
    cert = certify(graph, device=device)   # dark = every preemptible one
    worst = _blackhole_worst(cert.broken_critical.astype(float), seed,
                             error_budget)

    broken = {graph.names[i] for i in np.flatnonzero(cert.broken)}
    results: Dict[str, CertResult] = {}
    for i, (name, spec) in enumerate(fleet.items()):
        if not spec.failure_class.survives_failover:
            continue
        # the fail-close deps that actually carried the failure in
        # (multi-hop: a broken *critical* callee counts too)
        failing = [d for d in spec.unsafe_deps() if d in broken]
        results[name] = CertResult(service=name,
                                   certified=bool(worst[i] <= error_budget),
                                   failing_deps=failing,
                                   max_error_rate=float(worst[i]))
    return results


def certify_fleet_state(fs: FleetState, seed: int = 0,
                        error_budget: float = 0.002,
                        device=None) -> Dict[str, object]:
    """Array-native blackhole certification over a ``FleetState`` (requires
    edge arrays): multi-hop propagation decides who breaks, the graduated
    error model decides who gets flagged.  Returns summary counts + the
    flagged-caller mask."""
    from repro_torch.graph import CallGraph, certify
    assert fs.edges is not None, "FleetState synthesized without edges"
    graph = CallGraph.from_fleet_state(fs)
    cert = certify(graph, device=device)
    worst = _blackhole_worst(cert.broken_critical.astype(float), seed,
                             error_budget)
    crit = fs.survives
    flagged = crit & (worst > error_budget)
    e = fs.edges
    unsafe_edge = (~e.fail_open) & (fs.fclass[e.dst] >= RL)
    return {
        "n_critical": int(np.count_nonzero(crit)),
        "n_certified": int(np.count_nonzero(crit & ~flagged)),
        "n_flagged": int(np.count_nonzero(flagged)),
        "flagged_mask": flagged,
        "unsafe_edges": int(np.count_nonzero(
            unsafe_edge & fs.survives[e.src])),
        # multi-hop extras: criticals broken only through relay chains,
        # and how many propagation rounds the fixed point took
        "n_multi_hop": int(np.count_nonzero(cert.multi_hop)),
        "propagation_rounds": cert.rounds,
    }


def remediate(fleet: Dict[str, ServiceSpec],
              edges: Set[Tuple[str, str]],
              strategy: str = "fail_open") -> int:
    """Apply the paper's remediation strategies to detected unsafe edges:
    code-level fail-open conversion (default), or up-tiering the callee."""
    n = 0
    for caller, callee in edges:
        spec = fleet.get(caller)
        if spec is None or callee not in spec.fail_open:
            continue
        if spec.fail_open[callee]:
            continue
        if strategy == "fail_open":
            spec.fail_open[callee] = True
        elif strategy == "up_tier":
            target = fleet[callee]
            target.failure_class = FailureClass.ACTIVE_MIGRATE
        n += 1
    return n


@dataclasses.dataclass
class FailoverCertification:
    peak_report: FailoverReport
    classes_ok: Dict[str, bool]
    availability_ok: bool
    certified: bool


def failover_certification(fleet: Dict[str, ServiceSpec],
                           scale: float = 1.0,
                           overcommit_factor: float = 1.5,
                           device=None) -> FailoverCertification:
    """End-to-end drill: full-peak failover with all cities moved."""
    region = RegionCapacity.for_fleet("drill-region", fleet,
                                      overcommit_factor=overcommit_factor)
    orch = Orchestrator(fleet, region, scale=scale)
    rep = orch.failover(tv_failover=1.0)   # full peak
    classes_ok = {
        "always_on": rep.always_on_ok,
        "active_migrate": (rep.am_migrated_at_s or 1e18) <= 30 * 60,
        "restore_later": rep.rl_rto_met,
        "burst_under_20min": (rep.burst_full_at_s or 1e18) <= 20 * 60,
    }
    # availability: no critical service may break — multi-hop — when the
    # preempted (blackholed) services go dark
    from repro_torch.graph import CallGraph, certify
    dep_cert = certify(CallGraph.from_specs(fleet), device=device)
    availability_ok = dep_cert.ok and rep.always_on_ok
    orch.failback()
    return FailoverCertification(
        peak_report=rep, classes_ok=classes_ok,
        availability_ok=availability_ok,
        certified=availability_ok and all(classes_ok.values()))
