"""The port's SLO burn-rate monitor and profiler on the CPU against the
reference: ``sweep_alerts`` against the float64 ``alerts_np`` (exact
alert verdicts, times and rules, ``burn_peak`` within one float32 ulp)
and against the reference's jitted float32 ``sweep_alerts`` (alert,
time and rule), on ``tests/test_obs.py``'s five hand-made traces and on
a 256-scenario sweep's availability traces; the metering;
``alert_quality`` and ``monitor_orchestrator``; the profiler's phases,
its device synchronisation and its recording shims."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as ref_obs  # noqa: E402
from repro.core import scenarios as ref_sc  # noqa: E402
from repro.core.capacity import RegionCapacity as RefRegion  # noqa: E402
from repro.core.omg import Orchestrator as RefOrch  # noqa: E402
from repro.core.service import synthesize_fleet as ref_synth  # noqa: E402
from repro.obs import profiler as ref_prof  # noqa: E402
from repro.obs import slo as ref_slo  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.convert import from_reference_arrays  # noqa: E402
from repro_torch.core import timeline_sim as port_tl  # noqa: E402
from repro_torch.core.capacity import RegionCapacity  # noqa: E402
from repro_torch.core.omg import Orchestrator  # noqa: E402
from repro_torch.core.service import synthesize_fleet  # noqa: E402
from repro_torch.obs import profiler as port_prof  # noqa: E402
from repro_torch.obs import slo as port_slo  # noqa: E402


@pytest.fixture
def port_obs():
    """The port's default registry on and empty for one test."""
    obs.default_registry().reset()
    obs.enable()
    yield obs
    obs.disable()
    obs.default_registry().reset()


@pytest.fixture
def both_obs(port_obs):
    ref_obs.default_registry().reset()
    ref_obs.enable()
    yield ref_obs, port_obs
    ref_obs.disable()
    ref_obs.default_registry().reset()


def _trace(dips, n=240, dt=30.0):
    """``tests/test_obs.py``'s traces: 1.0 except ``[i0, i1)`` at ``a``."""
    ts = np.arange(n) * dt
    avail = np.ones(n)
    for i0, i1, a in dips:
        avail[i0:i1] = a
    return avail, ts


HAND_MADE = {
    "clean": [],
    "deep sustained dip": [(10, 120, 0.99)],
    "short sharp spike": [(5, 12, 0.95)],
    "mild burn, never alerts": [(0, 240, 0.9995)],
    "late dip": [(200, 240, 0.98)],
}


def _hold(got, avail, ts, i):
    """Row ``i`` of the port's output against ``alerts_np`` on its
    trace; returns the smallest distance of a rolling burn from its
    threshold (the margin the float32 reference needs to agree)."""
    want = ref_slo.alerts_np(avail, ts)
    assert bool(got["alert"][i]) == bool(want["alert"])
    assert got["t_first_alert"][i] == np.float32(want["t_first_alert"])
    assert got["rule_first_alert"][i] == want["rule_first_alert"]
    peak = np.float32(want["burn_peak"])
    assert abs(got["burn_peak"][i] - peak) <= np.spacing(peak)
    burn = (1.0 - np.asarray(avail, np.float64)) / (1.0 - port_slo.DEFAULT_TARGET)
    dt = float(ts[1] - ts[0])
    gap = np.inf
    for lk, sk, thr in port_slo.rule_steps(port_slo.DEFAULT_RULES, dt):
        for k in (lk, sk):
            gap = min(gap, np.abs(ref_slo._rolling_mean_np(burn, k)
                                  - thr).min())
    return gap


def _dtypes(out, n):
    assert out["alert"].dtype == np.bool_ and out["alert"].shape == (n,)
    assert out["t_first_alert"].dtype == np.float32
    assert out["rule_first_alert"].dtype == np.int32
    assert out["burn_peak"].dtype == np.float32


@pytest.mark.parametrize("name", sorted(HAND_MADE))
def test_sweep_alerts_hand_made_traces(name):
    traces = {k: _trace(v)[0] for k, v in HAND_MADE.items()}
    ts = _trace([])[1]
    names = sorted(traces)
    stack = np.stack([traces[k] for k in names])
    got = port_slo.sweep_alerts(stack, ts, device="cpu")
    _dtypes(got, len(names))
    i = names.index(name)
    _hold(got, traces[name], ts, i)
    ref = ref_slo.sweep_alerts(stack, ts)
    for k in ("alert", "t_first_alert", "rule_first_alert"):
        assert got[k][i] == ref[k][i], k
    # a tensor input and a float32 time grid give the same verdicts
    again = port_slo.sweep_alerts(torch.from_numpy(stack),
                                  ts.astype(np.float32), device="cpu")
    for k, v in got.items():
        assert np.array_equal(again[k], v), k


@pytest.fixture(scope="module")
def sweep_traces():
    """The availability traces of a 256-scenario sweep on a small fleet
    (the port's traces, bit-identical to the reference's run op by op,
    ``tests/test_torch_traces.py``)."""
    ref = ref_synth(scale=0.03, seed=11, as_arrays=True)
    ref.apply_ufa_target_classes()
    fields = {f.name: getattr(ref, f.name)
              for f in dataclasses.fields(ref) if f.name != "edges"}
    fields["edges"] = dataclasses.asdict(ref.edges)
    fs = from_reference_arrays(fleet=fields, device="cpu")["fleet"]
    grid = ref_sc.scenario_grid()
    n = len(grid["traffic_mult"])
    grid["dep_broken_frac"] = np.resize([0.0, 0.0, 0.01, 0.04], n)
    grid["storm_refrac"] = np.resize([0.0, 0.1, 0.3], n)
    grid["storm_broken_frac"] = np.resize([0.0, 0.02], n)
    res = port_tl.sweep_timeline(port_tl.config_for_fleet(fs), grid=grid,
                                 return_traces=True, device="cpu")
    return res["trace_availability"], res["t"], res["avail_ok"]


def test_sweep_alerts_sweep_traces_exact(sweep_traces):
    avail, ts, _ = sweep_traces
    got = port_slo.sweep_alerts(avail, ts, device="cpu")
    _dtypes(got, len(avail))
    assert got["alert"].any() and not got["alert"].all()
    assert set(got["rule_first_alert"][got["alert"]]) == {0, 1}
    gap = min(_hold(got, avail[i], ts, i) for i in range(len(avail)))
    print(f"smallest distance of a rolling burn to a threshold: {gap:.6g}")
    assert gap > 0
    ref = ref_slo.sweep_alerts(avail, ts)
    for k in ("alert", "t_first_alert", "rule_first_alert"):
        assert np.array_equal(got[k], ref[k]), k


@pytest.mark.parametrize("with_time", [False, True])
def test_alert_quality_matches_reference(sweep_traces, with_time):
    avail, ts, avail_ok = sweep_traces
    out = port_slo.sweep_alerts(avail, ts, device="cpu")
    t = out["t_first_alert"] if with_time else None
    got = port_slo.alert_quality(out["alert"], ~avail_ok, t)
    assert got == ref_slo.alert_quality(out["alert"], ~avail_ok, t)
    assert got["n_alerts"] > 0 and got["n_violations"] > 0


def test_sweep_alerts_metering(both_obs):
    r_obs, p_obs = both_obs
    avail, ts = _trace([(10, 120, 0.99)])
    late, _ = _trace([(200, 240, 0.98)])
    stack = np.stack([avail, np.ones_like(avail), late, avail])
    got = port_slo.sweep_alerts(stack, ts, device="cpu")
    ref_slo.sweep_alerts(stack, ts)
    assert int(got["alert"].sum()) == 3
    assert p_obs.value("ufa_slo_scenarios_alerting") == 3.0
    for rule in port_slo.DEFAULT_RULES:
        n = int((got["rule_first_alert"]
                 == port_slo.DEFAULT_RULES.index(rule)).sum())
        assert p_obs.value("ufa_slo_alerts_total", rule=rule.name) == n
        assert n == r_obs.value("ufa_slo_alerts_total", rule=rule.name)
    # the trace sweep meters its scenarios
    assert p_obs.value("ufa_slo_scenarios_alerting") == \
        r_obs.value("ufa_slo_scenarios_alerting")


def test_rules_and_rolling_mean_copies():
    assert port_slo.DEFAULT_RULES == tuple(
        port_slo.BurnRateRule(r.long_s, r.short_s, r.burn)
        for r in ref_slo.DEFAULT_RULES)
    assert [r.name for r in port_slo.DEFAULT_RULES] == \
        [r.name for r in ref_slo.DEFAULT_RULES]
    for dt in (30.0, 7.5, 600.0):
        assert port_slo.rule_steps(port_slo.DEFAULT_RULES, dt) == \
            ref_slo.rule_steps(ref_slo.DEFAULT_RULES, dt)
    x = np.random.default_rng(0).random(50)
    for k in (1, 3, 50, 80):
        assert np.array_equal(port_slo._rolling_mean_np(x, k),
                              ref_slo._rolling_mean_np(x, k))
    # windows longer than the trace: every mean is a partial prefix
    avail, ts = _trace([(0, 10, 0.99)], n=12)
    got = port_slo.sweep_alerts(avail, ts, device="cpu")
    _hold(got, avail, ts, 0)


def test_monitor_orchestrator_matches_reference(both_obs):
    r_obs, p_obs = both_obs
    rfleet = ref_synth(scale=0.02, seed=1)
    pfleet = synthesize_fleet(scale=0.02, seed=1)
    rorch = RefOrch(rfleet, RefRegion.for_fleet("r", rfleet), scale=0.02)
    porch = Orchestrator(pfleet, RegionCapacity.for_fleet("r", pfleet),
                         scale=0.02)
    rorch.failover()
    porch.failover()
    want = ref_slo.monitor_orchestrator(rfleet, rorch, n_samples=48)
    got = port_slo.monitor_orchestrator(pfleet, porch, n_samples=48)
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert np.array_equal(got[k], w), k
        else:
            assert got[k] == w, k
    assert p_obs.value("ufa_slo_scenarios_alerting") == \
        r_obs.value("ufa_slo_scenarios_alerting")


def test_profiler_phases_sync_and_shims(port_obs, monkeypatch):
    tr = obs.Tracer()
    prof = port_prof.Profiler(tr)
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: calls.append(dev))
    cpu = {"a": torch.zeros(3), "b": [torch.ones(2), (torch.ones(1), 4)]}
    with prof.phase("unit-test-phase", sync=cpu):
        pass
    assert calls == []                        # CPU tensors: nothing to wait
    assert prof.phases["unit-test-phase"] >= 0.0
    labels = {r["labels"]["phase"] for r in obs.default_registry().collect()
              if r["name"] == "ufa_phase_seconds"}
    assert "unit-test-phase" in labels
    assert any(e["ph"] == "X" and e["name"] == "unit-test-phase"
               for e in tr.to_chrome()["traceEvents"])
    # a CUDA tensor's device is synchronised once (a stand-in for the
    # card: only ``.device`` is read)
    class FakeCuda(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)
    fake = torch.zeros(2).as_subclass(FakeCuda)
    port_prof._synchronize({"x": [fake, fake], "y": torch.zeros(1)})
    assert calls == [torch.device("cuda", 0)]
    # deliberately not ported: jit_cache_watch (no jit cache) and the
    # throughput / padding_waste shims (the engines set their gauges),
    # and the typing names the port does not use; the port's own helpers
    assert [n for n in dir(ref_prof) if not n.startswith("__")
            and n not in ("jax", "throughput", "padding_waste",
                          "Callable", "Optional")] == \
        [n for n in dir(port_prof) if not n.startswith("__")
         and n not in ("_leaves", "_synchronize")]
    assert [n for n in dir(ref_prof.Profiler) if not n.startswith("__")
            and n != "jit_cache_watch"] == \
        [n for n in dir(port_prof.Profiler) if not n.startswith("__")]


def test_trace_sweep_meters(port_obs):
    fs = synthesize_fleet(scale=0.02, seed=1, as_arrays=True)
    grid = ref_sc.scenario_grid(traffic_mult=(2.0,), burst_delay_s=(270.0,))
    port_tl.sweep_timeline(port_tl.config_for_fleet(fs), grid=grid,
                           return_traces=True, device="cpu")
    assert obs.value("ufa_timeline_scenarios_total") == 16
    assert obs.value("ufa_timeline_scenarios_per_s") > 0
