"""The port's serving plane on the CPU (``repro_torch.serving`` and
``repro_torch.launch.serve``) against the reference's ``repro.serving``.

Each test of ``tests/test_serving_failover.py`` is mirrored on the port
(the request-plane state machine, scheduler-level accounting, aging,
§4.2 availability, trace-actuation parity, ``bind`` against
``drive_trace``, the end-to-end drill's SLA contracts, determinism and
the oracle's grid contract; the request campaign is in
``test_torch_serving_campaign.py``).  On top, reference parity:

  - the port's drill on the reference's weights (``init_params`` at
    ``PRNGKey(0)``, carried across by ``convert.params_from_reference``)
    equals ``repro.serving.run_drill(DrillSpec())`` exactly: every
    ``TierVerdict`` field, ``sla_ok``, ``users_served``, the actuation
    log, the availability traces and the grid;
  - one engine wave decodes the reference's tokens exactly, its logits
    within rtol 1e-5 (plus 1e-5 of max|logit| near zero);
  - the retry backoff and jitter sequence equals the reference's for the
    same seed;
  - the serve CLI on ``--device cpu`` prints the reference CLI's output.
"""

import contextlib
import io
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import serving as ref_serving  # noqa: E402
from repro.core import tiers as ref_tiers  # noqa: E402
from repro.models import LMConfig as RefLMConfig  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro.serving import workload as ref_workload  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core.tiers import FailureClass, RTO_SECONDS, Tier  # noqa: E402
from repro_torch.core.timeline_sim import (default_ts,  # noqa: E402
                                           simulate_timeline)
from repro_torch.models import LMConfig, init_params  # noqa: E402
from repro_torch.serving import (DrillSpec, FailoverBridge,  # noqa: E402
                                 Request, ServingEngine, TieredScheduler,
                                 TierPolicy, drill_oracle, run_drill,
                                 tier_live_fractions)
from repro_torch.serving.workload import _sim_for, pool_for  # noqa: E402

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file's tiny decode steps (the drills
    run thousands; more threads only contend with the other workers),
    restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_SF = dict(name="sf", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
           d_head=16, d_ff=128, vocab_size=128, tie_embeddings=True)
CFG = LMConfig(**_SF)
PARAMS = init_params(CFG, 0, device=CPU)
RTO = RTO_SECONDS[FailureClass.RESTORE_LATER]


def _engine(**kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_seq", 32)
    return ServingEngine(CFG, PARAMS, **kw)


def _req(rid, tier, plen=4, new=2):
    return Request(rid, tier=tier, prompt=list(range(plen)),
                   max_new_tokens=new)


def _serve_all(sched, t0=0.0, dt=1.0, max_rounds=200):
    t = t0
    for _ in range(max_rounds):
        t += dt
        busy = sched.tick(now=t)
        if not busy and not sched._q and not sched._retry:
            return t
    raise AssertionError("scheduler did not drain")


def _small_spec():
    """The reference test's cheaper drill: coarser steps, thinner load,
    short decodes."""
    return DrillSpec(horizon_s=7200.0, n_steps=48, ticks_per_step=4,
                     crit_rps=0.03, pre_rps=0.02, max_new_tokens=2,
                     seed=11)


@pytest.fixture(scope="module")
def drill():
    """The port's ``DrillSpec()`` drill on the CPU with the metrics
    registry on, and the registry's values the SLA test reads."""
    spec = DrillSpec()
    reg = obs.enable()
    reg.reset()
    try:
        rep = run_drill(spec, device=CPU)
        seen = {
            "crit_served": obs.value("ufa_serving_requests_total",
                                     tier=rep.crit.tier, outcome="served"),
            "pre_rejected": obs.value("ufa_serving_requests_total",
                                      tier=rep.pre.tier, outcome="rejected"),
            "pre_retries": obs.value("ufa_serving_retries_total",
                                     tier=rep.pre.tier)}
    finally:
        obs.disable()
    return rep, seen


# ---------------------------------------------------------------------------
# request-plane hardening: the per-request state machine
# ---------------------------------------------------------------------------

def test_fail_fast_rejects_blocked_tier_at_scheduler():
    e = _engine()
    sched = TieredScheduler({"e": e})
    sched.block_tier(Tier.T5, now=10.0)
    r = _req(0, Tier.T5)
    sched.submit(r, now=10.0)
    assert r.state == "rejected" and r.fail_reason == "rejected"
    assert sched.counters["rejected"][Tier.T5] == 1
    assert e.counters["rejected"][Tier.T5] == 0
    assert sched.queue_depth(Tier.T5) == 0


def test_queue_bound_sheds_overload():
    sched = TieredScheduler({"e": _engine()},
                            policies={Tier.T5: TierPolicy(queue_bound=2)})
    rs = [_req(i, Tier.T5) for i in range(3)]
    for r in rs:
        sched.submit(r, now=0.0)
    assert [r.state for r in rs] == ["queued", "queued", "failed"]
    assert rs[2].fail_reason == "shed"
    assert sched.counters["shed"][Tier.T5] == 1


def test_deadline_expiry_is_lazy_and_counted():
    sched = TieredScheduler({"e": _engine()},
                            policies={Tier.T1: TierPolicy(deadline_s=5.0)})
    r = _req(0, Tier.T1)
    sched.submit(r, now=0.0)
    sched.tick(now=100.0)
    assert r.state == "failed" and r.fail_reason == "deadline"
    assert sched.counters["deadline"][Tier.T1] == 1
    assert sched.counters["served"][Tier.T1] == 0


def test_retry_budget_exhaustion_marks_failed():
    e = _engine()
    sched = TieredScheduler({"e": e},
                            policies={Tier.T3: TierPolicy(max_retries=0)})
    r = _req(0, Tier.T3)
    sched.submit(r, now=0.0)
    sched.tick(now=1.0)
    assert r.state == "running"
    sched.absorb_preempted(e, e.preempt())
    assert r.state == "failed" and r.fail_reason == "retry_exhausted"
    assert sched.counters["retry_exhausted"][Tier.T3] == 1
    assert e.counters["restored"][Tier.T3] == 1


def test_preempt_hold_restore_roundtrip():
    e = _engine()
    sched = TieredScheduler({"e": e}, seed=3)
    r = _req(0, Tier.T3)
    sched.submit(r, now=0.0)
    sched.tick(now=1.0)
    assert r.state == "running"

    sched.block_tier(Tier.T3, now=2.0)
    assert r.state == "preempted"
    assert sched.preempted_pending(Tier.T3) == 1
    assert sched.counters["preempted"][Tier.T3] == 1
    assert sched.availability(Tier.T3) == 0.0
    assert e.availability(Tier.T3) == 0.0

    sched.restore_tier(Tier.T3, now=100.0)
    assert sched.preempted_pending(Tier.T3) == 0
    assert sched.counters["requeued"][Tier.T3] == 1
    assert r.attempts == 1
    _serve_all(sched, t0=100.0, dt=10.0)
    assert r.state == "done"
    assert len(r.output) == r.max_new_tokens
    assert sched.availability(Tier.T3) == 1.0
    assert e.availability(Tier.T3) == 1.0


def test_retry_backoff_is_exponential_with_jitter():
    pol = TierPolicy(backoff_base_s=10.0, backoff_mult=2.0, jitter_frac=0.1)
    assert pol.backoff(1, 0.0) == 10.0
    assert pol.backoff(2, 0.0) == 20.0
    assert pol.backoff(3, 1.0) == pytest.approx(44.0)


@pytest.mark.parametrize("seed", [0, 3, 2 ** 31 + 7])
def test_retry_backoff_sequence_equals_reference(seed):
    """Requeue one request until its budget runs out, in the port's and
    the reference's scheduler with the same seed: the same ready times
    (backoff times one jitter draw each), bit for bit, and the same
    verdict once the retries are spent."""
    def ready_times(sched_cls, policy_cls, req_cls, tier):
        sched = sched_cls({}, seed=seed, policies={
            tier: policy_cls(max_retries=6, backoff_base_s=7.0,
                             backoff_mult=1.5, jitter_frac=0.3)})
        r = req_cls(0, tier=tier, prompt=[1, 2], max_new_tokens=1)
        out = []
        for k in range(7):
            sched._requeue(r, 100.0 * k)
            out.append(sched._retry[-1][0] if r.state == "queued"
                       else r.fail_reason)
            sched._retry.clear()
        return out

    got = ready_times(TieredScheduler, TierPolicy, Request, Tier.T5)
    want = ready_times(ref_serving.TieredScheduler, ref_serving.TierPolicy,
                       ref_serving.Request, ref_tiers.Tier.T5)
    assert got == want
    assert got[-1] == "retry_exhausted"


# ---------------------------------------------------------------------------
# scheduler-level failover accounting, aging, engine availability
# ---------------------------------------------------------------------------

def test_enter_failover_charges_rejections_to_scheduler():
    engines = {"e0": _engine(), "e1": _engine()}
    sched = TieredScheduler(engines)
    for i in range(4):
        sched.submit(_req(i, Tier.T5), now=0.0)
    sched.submit(_req(9, Tier.T1), now=0.0)
    sched.enter_failover(now=1.0)
    assert sched.counters["rejected"][Tier.T5] == 4
    for e in engines.values():
        assert e.counters["rejected"][Tier.T5] == 0
    assert sched.queue_depth(Tier.T1) == 1
    _serve_all(sched, t0=1.0)
    assert sched.counters["served"][Tier.T1] == 1


@pytest.mark.parametrize("aging_rounds,starved", [(2, False), (0, True)])
def test_starvation_aging_promotes_ancient_low_tier(aging_rounds, starved):
    sched = TieredScheduler({"e": _engine(max_batch=1)},
                            aging_rounds=aging_rounds)
    ancient = _req(0, Tier.T5)
    sched.submit(ancient, now=0.0)
    for i in range(40):
        sched.submit(_req(100 + i, Tier.T0), now=float(i))
        sched.tick(now=float(i))
    assert ancient.state == ("queued" if starved else "done")


def test_engine_availability_counts_unrestored_preemptions():
    e = _engine()
    done = [_req(i, Tier.T5) for i in range(3)]
    e.admit(done)
    while e.decode_round():
        pass
    assert e.availability(Tier.T5) == 1.0
    lost = _req(9, Tier.T5)
    e.admit([lost])
    e.preempt()
    assert e.availability(Tier.T5) == pytest.approx(0.75)
    e.restored_credit(lost)
    assert e.availability(Tier.T5) == 1.0


# ---------------------------------------------------------------------------
# timeline-trace ⇄ replica-actuation parity, both drive modes
# ---------------------------------------------------------------------------

def test_trace_actuation_parity_with_timeline_kernel(drill):
    rep, _ = drill
    spec = rep.spec
    cfg, sim = _sim_for(spec.scale, spec.fleet_seed, spec.horizon_s,
                        spec.n_steps, spec.traffic_mult, CPU)
    _, groups = pool_for(spec, CPU)
    expected, cur = [], {g.tier: g.base for g in groups}
    for i in range(spec.n_steps):
        frac = tier_live_fractions(sim, cfg, i)
        for g in groups:
            tgt = FailoverBridge.target_for(g, float(frac[g.tier]))
            if tgt != cur[g.tier]:
                expected.append((float(sim["t"][i]), g.tier, tgt))
                cur[g.tier] = tgt
    assert rep.actuation_log == expected
    pre_targets = [tgt for _, t, tgt in rep.actuation_log
                   if t == spec.pre_tier]
    assert pre_targets[0] == 0 and pre_targets[-1] > 0
    assert any(tgt > spec.crit_replicas for _, t, tgt in rep.actuation_log
               if t == spec.crit_tier)


def test_orchestrator_bind_matches_trace_drive():
    from repro_torch.core.capacity import RegionCapacity
    from repro_torch.core.omg import Orchestrator
    from repro_torch.core.service import synthesize_fleet

    spec = DrillSpec()
    engines, groups = pool_for(spec, CPU)

    def fresh_bridge():
        for e in engines.values():
            e.reset()
        return FailoverBridge(TieredScheduler(engines), groups)

    fleet = synthesize_fleet(scale=spec.scale, seed=spec.fleet_seed)
    orch = Orchestrator(fleet, RegionCapacity.for_fleet("r", fleet))
    cfg = orch.timeline_config()

    trace = fresh_bridge()
    sim = simulate_timeline(cfg, ts=default_ts(spec.horizon_s, spec.n_steps),
                            device=CPU)
    trace.drive_trace(sim, cfg)

    live = fresh_bridge()
    live.bind(orch)
    orch.failover(tv_failover=1.0)

    def targets(bridge, tier):
        out = []
        for _, t, tgt in bridge.log:
            if t == tier and (not out or out[-1] != tgt):
                out.append(tgt)
        return out

    for g in groups:
        assert targets(live, g.tier) == targets(trace, g.tier), g.tier
        assert live.active_count(g.tier) == trace.active_count(g.tier)


# ---------------------------------------------------------------------------
# the end-to-end drill: differentiated SLAs, determinism, the oracle
# ---------------------------------------------------------------------------

def test_live_drill_end_to_end_differentiated_slas(drill):
    rep, seen = drill
    spec = rep.spec
    crit, pre = rep.crit, rep.pre

    assert rep.sla_ok
    assert crit.availability >= spec.avail_slo
    assert not crit.slo_alert
    assert crit.p99_s <= spec.crit_p99_slo_s
    assert crit.rejected == crit.shed == crit.retry_exhausted == 0

    assert pre.rejected > 0
    assert pre.preempted > 0 and pre.requeued > 0
    assert pre.availability < crit.availability
    assert np.isfinite(pre.time_to_restore_s)
    assert 0.0 < pre.time_to_restore_s <= RTO
    assert pre.slo_alert
    assert pre.served > 0

    assert seen["crit_served"] == crit.served
    assert seen["pre_rejected"] == pre.rejected
    assert seen["pre_retries"] == pre.requeued

    assert rep.avail_trace[spec.pre_tier].shape == (spec.n_steps,)
    assert rep.avail_trace[spec.pre_tier].min() < spec.avail_slo


def test_live_drill_is_bit_deterministic():
    spec = _small_spec()
    a, b = run_drill(spec, device=CPU), run_drill(spec, device=CPU)
    assert a.sla_ok == b.sla_ok and a.users_served == b.users_served
    assert a.actuation_log == b.actuation_log
    for t in a.tiers:
        assert a.tiers[t].as_dict() == b.tiers[t].as_dict()
        np.testing.assert_array_equal(a.avail_trace[t], b.avail_trace[t])


def test_request_fault_families_registered_globally():
    from repro_torch.chaos.faults import (FAMILIES, FAULT_LIBRARY,
                                          REQUEST_FAMILIES)
    assert REQUEST_FAMILIES == ("arrival_spike", "retry_storm")
    for name in REQUEST_FAMILIES:
        assert name in FAULT_LIBRARY
        assert name not in FAMILIES
    assert FAULT_LIBRARY["arrival_spike"].knob == "arrival_mult"
    assert FAULT_LIBRARY["retry_storm"].knob == "retry_storm"


def test_drill_oracle_grid_contract():
    oracle = drill_oracle(_small_spec(), device=CPU)
    ok, res = oracle({"arrival_mult": np.array([1.0]),
                      "retry_storm": np.array([0.0])})
    assert ok.shape == (1,) and bool(ok[0])
    for k in ("sla_ok", "crit_availability", "crit_p99_s", "pre_restore_s"):
        assert res[k].shape == (1,)
    assert res["crit_availability"][0] >= 0.9997


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_drill(_small_spec())
    with pytest.raises(RuntimeError, match="CUDA"):
        drill_oracle(_small_spec())
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--requests", "1"])


# ---------------------------------------------------------------------------
# reference parity
# ---------------------------------------------------------------------------

def _verdicts(rep):
    return {int(t): v.as_dict() for t, v in rep.tiers.items()}


def test_drill_equals_reference_on_its_weights():
    """The port's drill with the reference's weights in every pooled
    engine gives the reference drill's verdicts, counters, actuation and
    traces exactly: host arithmetic on the same counters and sim times."""
    spec = DrillSpec()
    engines, _ = pool_for(spec, CPU)
    ref_params = ref_init_params(RefLMConfig(**ref_workload._LM),
                                 jax.random.PRNGKey(0))
    ported = params_from_reference(ref_params, device=CPU)
    saved = {n: e.params for n, e in engines.items()}
    try:
        for e in engines.values():
            e.params = ported
        got = run_drill(spec, device=CPU)
    finally:
        for n, e in engines.items():
            e.params = saved[n]
    want = ref_serving.run_drill(ref_serving.DrillSpec())
    assert _verdicts(got) == _verdicts(want)
    assert got.sla_ok == want.sla_ok
    assert got.users_served == want.users_served
    assert ([(t, int(tier), n) for t, tier, n in got.actuation_log]
            == [(t, int(tier), n) for t, tier, n in want.actuation_log])
    assert sorted(map(int, got.avail_trace)) == \
        sorted(map(int, want.avail_trace))
    for t in got.avail_trace:
        np.testing.assert_array_equal(got.avail_trace[t],
                                      want.avail_trace[int(t)])
    np.testing.assert_array_equal(got.ts, want.ts)
    assert got.render() == want.render()


def test_engine_wave_decodes_reference_tokens():
    """One wave of three requests (5-token prompts, 6 new tokens) through
    the port's engine and the reference's on the same weights: every
    step's logits within rtol 1e-5 (plus 1e-5 of max|logit|), the greedy
    tokens equal."""
    ref_cfg = RefLMConfig(**_SF)
    ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    port = ServingEngine(CFG, params_from_reference(ref_params, device=CPU),
                         max_batch=4, max_seq=32)
    ref = ref_serving.ServingEngine(ref_cfg, ref_params, max_batch=4,
                                    max_seq=32)

    def wave(req_cls, tier):
        return [req_cls(i, tier=tier, prompt=[(7 * i + j) % 128
                                              for j in range(5)],
                        max_new_tokens=6) for i in range(3)]

    got, want = wave(Request, Tier.T1), wave(ref_serving.Request,
                                             ref_tiers.Tier.T1)
    port.admit(got)
    ref.admit(want)
    steps = 0
    while True:
        lw = np.asarray(ref._last_logits, np.float32)
        np.testing.assert_allclose(port._last_logits.numpy(), lw, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(lw).max()))
        more_port, more_ref = port.decode_round(), ref.decode_round()
        assert more_port == more_ref
        steps += 1
        if not more_ref:
            break
    assert steps == 6
    assert [r.output for r in got] == [r.output for r in want]
    assert port.tokens_decoded == ref.tokens_decoded == 18


def _cli_output(main, argv):
    buf = io.StringIO()
    saved = sys.argv
    sys.argv = ["serve"] + argv
    try:
        with contextlib.redirect_stdout(buf):
            main()
    finally:
        sys.argv = saved
    return buf.getvalue()


def test_serve_cli_prints_the_reference_table():
    """``python -m repro_torch.launch.serve --device cpu`` against the
    reference CLI: the same header, failover line, tokens decoded and
    per-tier counter table (the counters do not depend on the weights)."""
    from repro.launch import serve as ref_serve
    from repro_torch.launch import serve
    argv = ["--arch", "llama3.2-3b", "--requests", "32", "--failover-at",
            "16"]
    got = _cli_output(serve.main, argv + ["--device", "cpu"])
    want = _cli_output(ref_serve.main, argv)
    assert got == want
    assert "-- failover injected after 16 submissions --" in got
    assert "tokens decoded:" in got
