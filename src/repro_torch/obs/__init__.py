"""repro_torch.obs — the failover observability plane.

Zero-dependency instrumentation substrate for the UFA repro: a labeled
metrics registry ([`registry`](registry.py)), Chrome-trace span/event
tracing for the discrete-event orchestration ([`trace`](trace.py)),
multi-window multi-burn-rate SLO monitors ([`slo`](slo.py)), JAX-aware
pipeline profiling ([`profiler`](profiler.py)) and Prometheus/JSONL
export ([`export`](export.py)).

Importing this package pulls in **no** jax/numpy — ``slo``/``profiler``
are imported explicitly by consumers that already depend on jax.  Core
hot paths call the module-level helpers below, which no-op on a single
bool when the plane is off::

    from repro_torch import obs
    ...
    if obs.enabled():                       # one branch per call
        obs.inc("ufa_ingest_records_total", n, backend="numpy")
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from .registry import (Counter, Gauge, Histogram, Metric, Registry,
                       default_registry, disable, enable, enabled)
from .trace import Tracer, get_tracer, set_tracer, validate_chrome_trace

__all__ = [
    "Counter", "Gauge", "Histogram", "Metric", "Registry", "Tracer",
    "default_registry", "enable", "disable", "enabled",
    "get_tracer", "set_tracer", "validate_chrome_trace",
    "CATALOG", "inc", "set_gauge", "observe", "value", "describe",
]

# ---------------------------------------------------------------------------
# Metric catalogue — every metric the instrumented stack emits, with its
# kind, help string and label names.  One authoritative place so call
# sites stay one-liners and the README table is generated, not drifted.
# ---------------------------------------------------------------------------

# name -> (kind, help, label names, histogram buckets or None)
CATALOG: Dict[str, Tuple[str, str, Tuple[str, ...],
                         Optional[Tuple[float, ...]]]] = {
    # -- telemetry ingest / detection (core/dependency.py) --------------
    "ufa_ingest_records_total": (
        "counter", "RPC telemetry records ingested", ("backend",), None),
    "ufa_ingest_batches_total": (
        "counter", "ingest_batch calls", ("backend",), None),
    "ufa_ingest_records_per_s": (
        "gauge", "throughput of the most recent ingest_batch call",
        (), None),
    "ufa_detect_runs_total": (
        "counter", "fail-close detection passes", (), None),
    "ufa_detect_edges_flagged": (
        "gauge", "edges flagged fail-close by the latest detection pass",
        (), None),
    # -- fused sweep engine (core/sweep_engine.py) ----------------------
    "ufa_sweep_runs_total": (
        "counter", "SweepEngine.run calls", (), None),
    "ufa_sweep_scenarios_total": (
        "counter", "scenarios evaluated by the fused sweep engine",
        (), None),
    "ufa_sweep_scenarios_per_s": (
        "gauge", "throughput of the most recent SweepEngine.run call",
        (), None),
    "ufa_sweep_run_seconds": (
        "histogram", "SweepEngine.run wall time", (), None),
    "ufa_sweep_padding_waste_ratio": (
        "gauge", "fraction of the padded mega-batch that was padding "
        "in the most recent run", (), None),
    "ufa_sweep_compiled_variants": (
        "gauge", "programs resident in the sweep engine jit cache",
        (), None),
    "ufa_sweep_compile_misses_total": (
        "counter", "jit cache misses (new compiled variants) observed "
        "across SweepEngine.run calls", (), None),
    # -- temporal kernel (core/timeline_sim.py) -------------------------
    "ufa_timeline_scenarios_total": (
        "counter", "scenarios evaluated by sweep_timeline", (), None),
    "ufa_timeline_scenarios_per_s": (
        "gauge", "throughput of the most recent sweep_timeline call",
        (), None),
    # -- hardening planner / regression gate (graph/planner.py) ---------
    "ufa_planner_rounds_total": (
        "counter", "hardening-planner greedy rounds", (), None),
    "ufa_planner_hardened_edges_total": (
        "counter", "edges hardened by plan_hardening", (), None),
    "ufa_planner_broken_critical": (
        "gauge", "critical services still reachable by failure "
        "propagation after the latest planner round", (), None),
    "ufa_gate_checks_total": (
        "counter", "dependency regression-gate checks", ("verdict",),
        None),
    "ufa_gate_violations": (
        "gauge", "unsafe critical-path edges found by the latest gate "
        "check", (), None),
    # -- orchestrator / event loop (core/omg.py, core/events.py) --------
    "ufa_orch_events_total": (
        "counter", "discrete events fired by the orchestration event "
        "loop", ("label",), None),
    "ufa_orch_envs_total": (
        "counter", "service environments acted on during failover",
        ("action",), None),
    # -- SLO monitor (obs/slo.py) ---------------------------------------
    "ufa_slo_alerts_total": (
        "counter", "burn-rate alerts raised", ("rule",), None),
    "ufa_slo_scenarios_alerting": (
        "gauge", "scenarios alerting in the latest monitored ensemble",
        (), None),
    # -- chaos campaigns (chaos/campaign.py, chaos/report.py) -----------
    "ufa_chaos_rounds_total": (
        "counter", "chaos-campaign search rounds executed", (), None),
    "ufa_chaos_evals_total": (
        "counter", "engine scenario-evaluations submitted by chaos "
        "campaigns", (), None),
    "ufa_chaos_rays_localized": (
        "gauge", "fault-severity rays whose SLA frontier the latest "
        "campaign localized to tolerance", (), None),
    "ufa_chaos_frontier_severity": (
        "gauge", "localized frontier severity of a fault-severity ray "
        "in the latest campaign", ("ray",), None),
    "ufa_chaos_speedup_vs_grid": (
        "gauge", "engine-evaluation savings of the latest campaign vs "
        "an exhaustive per-ray grid at the same resolution", (), None),
    # -- serving plane (serving/scheduler.py, serving/failover.py,
    #    serving/workload.py) ---------------------------------------------
    "ufa_serving_requests_total": (
        "counter", "request-plane final verdicts by tier and outcome",
        ("tier", "outcome"), None),
    "ufa_serving_retries_total": (
        "counter", "bounded request retries scheduled (backoff + jitter)",
        ("tier",), None),
    "ufa_serving_request_latency_s": (
        "histogram", "end-to-end request latency in simulated seconds",
        ("tier",), (1.0, 5.0, 15.0, 30.0, 60.0, 120.0, 300.0, 600.0,
                    1800.0, 3600.0)),
    "ufa_serving_replicas_active": (
        "gauge", "replica target actuated by the failover bridge",
        ("tier",), None),
    "ufa_serving_queue_depth": (
        "gauge", "scheduler queue depth at the latest drill step",
        ("tier",), None),
    # -- profiler / bench -----------------------------------------------
    "ufa_phase_seconds": (
        "histogram", "wall time of named pipeline phases", ("phase",),
        None),
    "ufa_bench_us_per_call": (
        "gauge", "benchmark harness rows (microseconds per call)",
        ("name",), None),
}


def describe(name: str) -> Tuple[str, str, Tuple[str, ...]]:
    kind, help_, labels, _ = CATALOG[name]
    return kind, help_, labels


def _metric(name: str) -> Metric:
    reg = default_registry()
    m = reg.get(name)
    if m is not None:
        return m
    kind, help_, labels, buckets = CATALOG.get(
        name, ("gauge", "", (), None))
    if kind == "counter":
        return reg.counter(name, help_, labels)
    if kind == "histogram":
        return reg.histogram(name, help_, labels, buckets=buckets)
    return reg.gauge(name, help_, labels)


# ---------------------------------------------------------------------------
# Hot-path helpers: free when the plane is off (one bool check, no
# allocation), catalogue-driven when it is on.
# ---------------------------------------------------------------------------

def inc(name: str, v: float = 1.0, /, **labels):
    if not enabled():
        return
    m = _metric(name)
    (m.labels(**labels) if labels else m).inc(v)


def set_gauge(name: str, v: float, /, **labels):
    if not enabled():
        return
    m = _metric(name)
    (m.labels(**labels) if labels else m).set(v)


def observe(name: str, v: float, /, **labels):
    if not enabled():
        return
    m = _metric(name)
    (m.labels(**labels) if labels else m).observe(v)


def value(name: str, /, **labels) -> float:
    reg = default_registry()
    if reg.get(name) is None:
        return 0.0                  # never touched (e.g. plane was off)
    return reg.value(name, **labels)
