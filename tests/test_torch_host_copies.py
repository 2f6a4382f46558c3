"""The port's host copies against the reference on the CPU, on the inputs
of ``tests/test_ufa_core.py`` and ``tests/test_qos_drills_edges.py``:
``core.metrics``, ``core.eviction`` (the QoS sweep on both populations,
``failover_eviction_trace`` at a small ``n_hosts``), ``core.canary``,
``core.drills`` (certification through the propagation kernel's plain
version, ``device="cpu"``) and ``obs.export`` (the Prometheus and JSONL
round trip and the validator CLI).  Every output is exact."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import canary as ref_canary  # noqa: E402
from repro.core import drills as ref_drills  # noqa: E402
from repro.core import eviction as ref_ev  # noqa: E402
from repro.core import metrics as ref_metrics  # noqa: E402
from repro.core.capacity import RegionCapacity as RefRegion  # noqa: E402
from repro.core.fleet_state import FleetState as RefFleetState  # noqa: E402
from repro.core.omg import Orchestrator as RefOrch  # noqa: E402
from repro.core.service import ServiceSpec as RefSpec  # noqa: E402
from repro.core.service import synthesize_fleet as ref_synth  # noqa: E402
from repro.core.service import unsafe_edges as ref_unsafe  # noqa: E402
from repro.core.tiers import FailureClass as RefFC, Tier as RefTier  # noqa: E402
from repro.obs import export as ref_export  # noqa: E402
from repro.obs.registry import Registry as RefRegistry  # noqa: E402
from repro_torch.core import canary, drills, eviction, metrics  # noqa: E402
from repro_torch.core.capacity import RegionCapacity  # noqa: E402
from repro_torch.core.fleet_state import FleetState  # noqa: E402
from repro_torch.core.omg import Orchestrator  # noqa: E402
from repro_torch.core.service import ServiceSpec  # noqa: E402
from repro_torch.core.service import synthesize_fleet, unsafe_edges  # noqa: E402
from repro_torch.core.tiers import FailureClass, Tier  # noqa: E402
from repro_torch.obs import export  # noqa: E402
from repro_torch.obs.registry import Registry  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _plain(x):
    """A result with enums by value and dataclasses as dicts, so the two
    packages' outputs compare with ``==``."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {_plain(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tolist())
    if hasattr(x, "value") and hasattr(type(x), "__members__"):
        return x.value
    return x


# ---------------------------------------------------------------------------
# core.metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale,seed", [(0.02, 1), (0.05, 3)])
def test_metrics_match_reference(scale, seed):
    rfleet, pfleet = ref_synth(scale=scale, seed=seed), \
        synthesize_fleet(scale=scale, seed=seed)
    rorch = RefOrch(rfleet, RefRegion.for_fleet("r", rfleet), scale=scale)
    porch = Orchestrator(pfleet, RegionCapacity.for_fleet("r", pfleet),
                         scale=scale)
    # before the failover: no timeline yet
    assert metrics.availability_during_failover(pfleet, porch) == \
        ref_metrics.availability_during_failover(rfleet, rorch)
    rorch.failover()
    porch.failover()
    for n in (2, 48, 64):
        assert metrics.availability_during_failover(
            pfleet, porch, n_samples=n, seed=seed) == \
            ref_metrics.availability_during_failover(
                rfleet, rorch, n_samples=n, seed=seed)
    assert metrics.regional_utilization_series(porch) == \
        ref_metrics.regional_utilization_series(rorch)
    assert metrics.regional_utilization_series(porch, 0.7) == \
        ref_metrics.regional_utilization_series(rorch, 0.7)
    assert _plain(metrics.phased_rollout()) == \
        _plain(ref_metrics.phased_rollout())
    assert metrics.failover_minutes_history() == \
        ref_metrics.failover_minutes_history()
    assert metrics.failover_counts_history() == \
        ref_metrics.failover_counts_history()
    assert metrics.BASELINE_AVAILABILITY == ref_metrics.BASELINE_AVAILABILITY


# ---------------------------------------------------------------------------
# core.eviction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_hosts,seed", [(400, 7), (2_000, 1), (40_000, 7)])
def test_failover_eviction_trace_matches(n_hosts, seed):
    assert eviction.failover_eviction_trace(n_hosts=n_hosts, seed=seed) == \
        ref_ev.failover_eviction_trace(n_hosts=n_hosts, seed=seed)


def _hot_hosts(mod):
    hosts = mod.make_host_population(20, seed=1, critical_fill=0.5,
                                     preempt_fill=0.4)
    for h in hosts:
        for p in h.pods:
            p.utilization = 0.9
    return hosts


def test_qos_controller_object_path_matches():
    rh, ph = _hot_hosts(ref_ev), _hot_hosts(eviction)
    assert _plain(ph) == _plain(rh)
    rq, pq = ref_ev.QoSController(rh), eviction.QoSController(ph)
    assert pq.sweep(now=0.0) == rq.sweep(now=0.0) > 0
    assert pq.evictions == rq.evictions
    assert _plain(ph) == _plain(rh)
    # placement prefers the least utilised host
    rp = rq.place(ref_ev.HostPod("new", 4.0, True, 0.3))
    pp = pq.place(eviction.HostPod("new", 4.0, True, 0.3))
    assert (rp is None) == (pp is None)
    assert rp is None or rp.hid == pp.hid


def _arrays(mod, pod_cores, pod_util, pod_pre, n_hosts=1, pod_host=None):
    n = len(pod_cores)
    return mod.HostArrays(
        host_cores=np.full(n_hosts, 100.0),
        pod_host=(np.zeros(n, np.int32) if pod_host is None
                  else np.asarray(pod_host, np.int32)),
        pod_cores=np.asarray(pod_cores, float),
        pod_util=np.asarray(pod_util, float),
        pod_pre=np.asarray(pod_pre, bool), alive=np.ones(n, bool))


@pytest.mark.parametrize("case", [
    # tests/test_qos_drills_edges.py's populations
    dict(pod_cores=[40, 40, 20], pod_util=[0.9, 0.9, 0.8],
         pod_pre=[False, False, False]),
    dict(pod_cores=[30, 20, 20, 20, 10], pod_util=[1.0, 1.0, 1.0, 0.9, 0.5],
         pod_pre=[False, True, True, True, True]),
    dict(pod_cores=[20, 10], pod_util=[0.5, 0.4], pod_pre=[True, True]),
    dict(pod_cores=[30, 25, 20, 15, 20, 10],
         pod_util=[1.0, 1.0, 1.0, 0.8, 0.5, 0.4],
         pod_pre=[False, True, True, True, True, False], n_hosts=2,
         pod_host=[0, 0, 0, 0, 1, 1]),
])
def test_qos_controller_array_path_matches(case):
    ra, pa = _arrays(ref_ev, **case), _arrays(eviction, **case)
    rq, pq = ref_ev.QoSController(ra), eviction.QoSController(pa)
    for now in (0.0, 1.0):
        assert pq.sweep(now=now) == rq.sweep(now=now)
    assert pq.evictions == rq.evictions
    assert np.array_equal(pa.alive, ra.alive)
    assert np.array_equal(pa.utilization(), ra.utilization())


@pytest.mark.parametrize("n_hosts,seed", [(1, 3), (300, 0)])
def test_make_host_arrays_and_sweep_match(n_hosts, seed):
    ra = ref_ev.make_host_arrays(n_hosts=n_hosts, seed=seed)
    pa = eviction.make_host_arrays(n_hosts=n_hosts, seed=seed)
    assert _plain(pa) == _plain(ra)
    for h in (ra, pa):
        h.pod_util[:] = np.minimum(1.0, h.pod_util * 2.5)
    rq, pq = ref_ev.QoSController(ra), eviction.QoSController(pa)
    assert pq.sweep(now=0.0) == rq.sweep(now=0.0)
    assert pq.evictions == rq.evictions
    assert np.array_equal(pa.alive, ra.alive)


# ---------------------------------------------------------------------------
# core.canary
# ---------------------------------------------------------------------------

def test_canary_gate_matches():
    rfleet, pfleet = ref_synth(scale=0.05, seed=3), \
        synthesize_fleet(scale=0.05, seed=3)
    assert ref_drills.remediate(rfleet, set(ref_unsafe(rfleet))) == \
        drills.remediate(pfleet, set(unsafe_edges(pfleet)))
    rg = ref_canary.CanaryRegressionGate(rfleet, seed=0)
    pg = canary.CanaryRegressionGate(pfleet, seed=0)
    crit = next(n for n, s in rfleet.items()
                if s.failure_class.survives_failover)
    pre = next(n for n, s in rfleet.items() if s.failure_class.preemptible)
    for dep in ((crit, None), (crit, (pre, False)), (crit, (pre, True)),
                (pre, None), ("no-such-service", None)):
        want = rg.evaluate(ref_canary.Deployment(*dep))
        got = pg.evaluate(canary.Deployment(*dep))
        assert _plain(got) == _plain(want), dep
    assert _plain(pg.rolled_back) == _plain(rg.rolled_back)
    for n, rate in ((48_000, 6e-5), (2_000, 1e-2)):
        assert _plain(pg.run_window(n, rate)) == \
            _plain(rg.run_window(n, rate))


# ---------------------------------------------------------------------------
# core.drills
# ---------------------------------------------------------------------------

def _chain_fleet(spec, tier, fc, remediated=False):
    """``tests/test_qos_drills_edges.py``'s relay chain a -> b -> c, with
    ``d`` a critical caller of ``c`` through a fail-open edge."""
    c = spec("c", tier.T3, fc.RESTORE_LATER, 1.0, 4)
    b = spec("b", tier.T2, fc.ACTIVE_MIGRATE, 1.0, 4, deps=["c"],
             fail_open={"c": remediated})
    a = spec("a", tier.T1, fc.ALWAYS_ON, 1.0, 4, deps=["b"],
             fail_open={"b": False})
    d = spec("d", tier.T1, fc.ALWAYS_ON, 1.0, 4, deps=["c"],
             fail_open={"c": True})
    return {"a": a, "b": b, "c": c, "d": d}


def _fleets(kind):
    if kind == "synthesized":
        return ref_synth(scale=0.05, seed=3), synthesize_fleet(scale=0.05,
                                                               seed=3)
    remediated = kind == "chain remediated"
    return (_chain_fleet(RefSpec, RefTier, RefFC, remediated),
            _chain_fleet(ServiceSpec, Tier, FailureClass, remediated))


@pytest.mark.parametrize("kind", ["chain", "chain remediated", "synthesized"])
def test_drills_match_reference(kind):
    rfleet, pfleet = _fleets(kind)
    for seed in (0, 2):
        want = ref_drills.dependency_safety_certification(rfleet, seed=seed)
        got = drills.dependency_safety_certification(pfleet, seed=seed,
                                                     device="cpu")
        assert _plain(got) == _plain(want)
    rfs = RefFleetState.from_specs(rfleet, with_edges=True)
    pfs = FleetState.from_specs(pfleet, with_edges=True)
    assert _plain(drills.certify_fleet_state(pfs, seed=1, device="cpu")) == \
        _plain(ref_drills.certify_fleet_state(rfs, seed=1))
    if kind == "chain":
        assert not got["a"].certified and got["d"].certified


def test_failover_certification_matches():
    rfleet, pfleet = _fleets("synthesized")
    want = ref_drills.failover_certification(rfleet, scale=0.05)
    got = drills.failover_certification(pfleet, scale=0.05, device="cpu")
    # the report's timeline holds NaN where a series has no value yet
    np.testing.assert_equal(_plain(got), _plain(want))
    with pytest.raises(AssertionError):
        drills.certify_fleet_state(FleetState.from_specs(pfleet),
                                   device="cpu")


# ---------------------------------------------------------------------------
# obs.export
# ---------------------------------------------------------------------------

def _registry(cls):
    reg = cls()
    c = reg.counter("rt_total", 'help with "quotes"\nand newline',
                    labels=("backend",))
    c.labels(backend="numpy").inc(5)
    c.labels(backend='we"ird\\nm\ne').inc(2)
    reg.gauge("rt_gauge").set(2.5)
    reg.gauge("rt_inf").set(float("inf"))
    h = reg.histogram("rt_seconds", buckets=(0.5, 2.0))
    h.observe(0.1)
    h.observe(1.0)
    return reg


def test_prometheus_and_jsonl_round_trip(tmp_path):
    text = export.to_prometheus(_registry(Registry))
    assert text == ref_export.to_prometheus(_registry(RefRegistry))
    assert export.validate_prometheus(text) == []
    assert export.parse_prometheus(text) == ref_export.parse_prometheus(text)
    bad = text.replace("# TYPE rt_gauge gauge\n", "") + "bad line{\n"
    assert export.validate_prometheus(bad) == \
        ref_export.validate_prometheus(bad)
    path = export.write_prometheus(str(tmp_path / "m.prom"),
                                   _registry(Registry))
    with open(path) as f:
        assert f.read() == text
    p = tmp_path / "m.jsonl"
    export.write_jsonl(str(p), _registry(Registry), meta={"run": 1})
    export.write_jsonl(str(p), _registry(Registry), meta={"run": 2})
    lines = p.read_text().strip().splitlines()
    assert len(lines) == 2
    snap = json.loads(lines[1])
    snap.pop("ts_unix")
    ref_p = tmp_path / "ref.jsonl"
    ref_export.write_jsonl(str(ref_p), _registry(RefRegistry),
                           meta={"run": 2})
    want = json.loads(ref_p.read_text())
    want.pop("ts_unix")
    assert snap == want


def test_export_cli_validates(tmp_path):
    prom = export.write_prometheus(str(tmp_path / "m.prom"),
                                   _registry(Registry))
    bad = tmp_path / "bad.prom"
    bad.write_text("no_type_line 1\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    ok = subprocess.run([sys.executable, "-m", "repro_torch.obs.export",
                         "--validate", prom], env=env, cwd=ROOT,
                        capture_output=True, text=True, timeout=120)
    assert ok.returncode == 0 and "prometheus OK" in ok.stdout
    fail = subprocess.run([sys.executable, "-m", "repro_torch.obs.export",
                           "--validate", str(bad)], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert fail.returncode == 1 and "PROM INVALID" in fail.stdout
