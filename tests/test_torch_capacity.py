"""The port's soft relaxation, capacity optimizer, AdamW and overcommit
simulator on the CPU against the reference, on the same fleet (the
reference's optimizer fleet: scale 0.02, seed 7, UFA target classes)
and the same inputs.

Grades.  Booleans, failure counts and recommendations exact; soft
verdicts and the soft loss rtol 1e-5; design constants, CEM scores and
other floats float32-tight (rtol 1e-6, ``t_availability_mean`` 1e-5 as
in ``test_torch_timeline``); gradients against ``jax.grad`` rtol 1e-4
and against central differences the reference's 0.08.

At tau 1 the reference's own gradient of ``t_availability_mean`` in the
eviction-order and promotion knobs is float32 cancellation noise (the
forward-mode tangent of the availability series is exactly zero there,
reverse mode gives ~1e-8), which the availability sigmoid's
1 / (2e-5 tau) lifts into those components of the loss's gradient; at
tau 1 the ``jax.grad`` comparison holds the knobs whose gradient is
not that noise (buffer, overcommit, ramp), and every knob at tau 0.1 and
0.03, where the noise no longer reaches the loss."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import overcommit_sim as ref_oc  # noqa: E402
from repro.core.fleet_state import FleetState as RefFleetState  # noqa: E402
from repro.core.scenarios import FleetAggregates as RefAgg  # noqa: E402
from repro.core.scenarios import scenario_grid  # noqa: E402
from repro.core.service import apply_ufa_target_classes as ref_apply  # noqa: E402
from repro.core.service import synthesize_fleet as ref_synth  # noqa: E402
from repro.core.sweep_engine import SweepEngine as RefEngine  # noqa: E402
from repro.core.sweep_engine import bucket_shape  # noqa: E402
from repro.core.timeline_sim import config_for_fleet as ref_config  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.optim import capacity as rc  # noqa: E402
from repro_torch.core import overcommit_sim as port_oc  # noqa: E402
from repro_torch.core.fleet_state import FleetState  # noqa: E402
from repro_torch.core.scenarios import FleetAggregates  # noqa: E402
from repro_torch.core.service import apply_ufa_target_classes  # noqa: E402
from repro_torch.core.service import synthesize_fleet  # noqa: E402
from repro_torch.core.sweep_engine import SweepEngine  # noqa: E402
from repro_torch.core.timeline_sim import config_for_fleet  # noqa: E402
from repro_torch.optim import adamw as port_adamw  # noqa: E402
from repro_torch.optim import capacity as pc  # noqa: E402

from test_torch_timeline import AVAIL_MEAN_RTOL, F32_TIGHT  # noqa: E402

SOFT_RTOL = 1e-5
GRAD_RTOL = 1e-4
FD_TOL = 0.08
SCALE, SEED = 0.02, 7
KNOBS = dict(buffer=0.6, promote=(0.4, 0.3, 0.2), overcommit=1.4, ramp=0.9,
             evict_lambda=0.2)


@pytest.fixture(scope="module")
def fleets():
    rf = ref_synth(scale=SCALE, seed=SEED)
    ref_apply(rf)
    pf = synthesize_fleet(scale=SCALE, seed=SEED)
    apply_ufa_target_classes(pf)
    return RefFleetState.from_specs(rf), FleetState.from_specs(pf)


@pytest.fixture(scope="module")
def engines(fleets):
    rfs, pfs = fleets
    return (RefEngine(RefAgg.from_fleet_state(rfs), ref_config(rfs),
                      reducer="scan"),
            SweepEngine(FleetAggregates.from_fleet_state(pfs),
                        config_for_fleet(pfs), device="cpu"))


@pytest.fixture(scope="module")
def opt_inputs(fleets):
    rfs, pfs = fleets
    ref = (rc.DesignBase.from_fleet_state(rfs).as_arrays(),
           rc._grid_cols(rc.certification_grid()),
           jnp.asarray(rc.default_ts(), jnp.float32))
    port = (pc.DesignBase.from_fleet_state(pfs).as_arrays("cpu"),
            pc._grid_cols(pc.certification_grid(), "cpu"),
            torch.from_numpy(pc.default_ts().astype(np.float32)))
    return ref, port


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(got, want, rtol, what):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, what
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin), what
    assert np.array_equal(got[~fin], want[~fin]), what
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=0,
                               err_msg=what)


# ---------------------------------------------------------------------------
# the soft relaxation through the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tau", [0.5, 0.05, 1e-3])
def test_soft_engine_run_matches_reference(engines, tau):
    reng, peng = engines
    grid = scenario_grid(evict_fraction=(1.0, 0.7))
    want, got = reng.run(grid, soft_tau=tau), peng.run(grid, soft_tau=tau)
    assert set(got) == set(want)
    for k, w in want.items():
        if k in grid:
            continue
        g = got[k]
        assert g.dtype == w.dtype, k
        rtol = (AVAIL_MEAN_RTOL if k == "t_availability_mean"
                else SOFT_RTOL if w.dtype.kind == "f" else 0)
        if w.dtype.kind != "f":
            assert np.array_equal(g, w), k
        else:
            _close(g, w, rtol, k)


def test_low_tau_soft_reproduces_hard_verdicts(engines):
    """At tau 1e-3 every indicator saturates: the soft verdicts,
    thresholded at 0.5, are the hard booleans on the default grid."""
    _, peng = engines
    hard = peng.run()
    soft = peng.run(soft_tau=1e-3)
    n_bool = 0
    for k in hard:
        if hard[k].dtype == bool:
            n_bool += 1
            assert soft[k].dtype == np.float32, k
            assert ((soft[k] >= 0.5) == hard[k]).all(), k
    assert n_bool >= 10
    # the availability margins the check rests on: the soft integral is
    # summed in the scan's order and the hard one by the reduction
    margin = np.abs(hard["t_availability_mean"] - (0.9997 - 5e-5))
    assert margin.min() > 3e-6


def test_soft_runs_leave_hard_path_bit_identical(engines):
    _, peng = engines
    before = peng.run()
    peng.run(soft_tau=0.5)
    after = peng.run()
    for k in before:
        np.testing.assert_array_equal(before[k], after[k], err_msg=k)


def test_zero_eviction_deltas_are_bitwise_noop(engines):
    _, peng = engines
    grid = scenario_grid()
    n = len(next(iter(grid.values())))
    plain = peng.run(grid)
    padded = peng.run(dict(grid, rl_evict_delta=np.zeros(n),
                           tm_evict_delta=np.zeros(n)))
    for k in plain:
        np.testing.assert_array_equal(plain[k], padded[k], err_msg=k)


# ---------------------------------------------------------------------------
# designs, the soft loss and its gradient
# ---------------------------------------------------------------------------

def test_design_and_consts_match_reference(opt_inputs):
    (rb, rcols, _), (pb, pcols, _) = opt_inputs
    for name in ("legacy", "ufa", "mid"):
        if name == "mid":
            kr, kp = rc.make_knobs(**KNOBS), pc.make_knobs(**KNOBS,
                                                           device="cpu")
        else:
            kr = getattr(rc, f"{name}_knobs")()
            kp = getattr(pc, f"{name}_knobs")("cpu")
        for k in kr:
            _close(kp[k], kr[k], 0, k)
        dr, dp = rc.knob_design(rb, kr), pc.knob_design(pb, kp)
        assert set(dr) == set(dp)
        for k in dr:
            _close(dp[k], dr[k], F32_TIGHT, k)
        assert pc.provisioning(dp) == pytest.approx(rc.provisioning(dr),
                                                    rel=F32_TIGHT)
        cr, cp = rc.design_consts(dr), pc.design_consts(dp)
        for part in ("a", "t"):
            assert set(cr[part]) == set(cp[part])
            for k in cr[part]:
                assert cp[part][k].dtype == torch.float32, k
                _close(cp[part][k], cr[part][k], F32_TIGHT, k)
        pr, pp = rc._design_params(dr, rcols), pc._design_params(dp, pcols)
        for k in pr:
            _close(pp[k], pr[k], F32_TIGHT, k)
    assert pc.provisioning(pc.knob_design(pb, pc.ufa_knobs("cpu"))) < 1.1
    assert pc.provisioning(pc.knob_design(pb, pc.legacy_knobs("cpu"))) > 1.8


@pytest.mark.parametrize("tau", [None, 0.5])
def test_fused_verdicts_one_scenario(opt_inputs, tau):
    """``sweep_engine._fused_verdicts`` (one scenario, the optimizer's
    per-design constants) against the reference's, hard and soft."""
    from repro.core.sweep_engine import _fused_verdicts as ref_fv
    from repro_torch.core.sweep_engine import _fused_verdicts
    (rb, rcols, rts), (pb, pcols, pts) = opt_inputs
    dr = rc.knob_design(rb, rc.make_knobs(**KNOBS))
    dp = pc.knob_design(pb, pc.make_knobs(**KNOBS, device="cpu"))
    pr, pp = rc._design_params(dr, rcols), pc._design_params(dp, pcols)
    for i in (0, 17, 47):
        want = ref_fv(rc.design_consts(dr), {k: v[i] for k, v in pr.items()},
                      rts, True, None if tau is None else jnp.float32(tau))
        got = _fused_verdicts(pc.design_consts(dp),
                              {k: v[i] for k, v in pp.items()}, pts, True,
                              None if tau is None else torch.tensor(tau))
        assert set(got) == set(want)
        for k, w in want.items():
            w = np.asarray(w)
            if w.dtype.kind != "f":
                assert np.array_equal(_np(got[k]), w), (i, k)
            else:
                rtol = (AVAIL_MEAN_RTOL if k == "t_availability_mean"
                        else SOFT_RTOL)
                _close(got[k], w, rtol, f"{i} {k}")


def test_eviction_deltas_conserve_budget():
    e = torch.tensor([0.3, 0.7, 1.0])
    for lam in (-1.0, -0.4, 0.0, 0.5, 1.0):
        design = {"rl": torch.tensor(1500.0), "tm": torch.tensor(400.0),
                  "evict_lambda": torch.tensor(lam)}
        d_rl, d_tm = pc.eviction_deltas(design, e)
        want = rc.eviction_deltas({k: jnp.asarray(v.numpy())
                                   for k, v in design.items()},
                                  jnp.asarray(e.numpy()))
        _close(d_rl, want[0], F32_TIGHT, "d_rl")
        _close(d_tm, want[1], F32_TIGHT, "d_tm")
        budget = 1500.0 * d_rl.numpy() + 400.0 * d_tm.numpy()
        np.testing.assert_allclose(budget, 0.0, atol=1e-3)
        for d in (d_rl, d_tm):
            assert ((e + d >= -1e-6) & (e + d <= 1 + 1e-6)).all()


def _loss_and_grad(opt_inputs, tau):
    (rb, rcols, rts), (pb, pcols, pts) = opt_inputs
    kr, kp = rc.make_knobs(**KNOBS), pc.make_knobs(**KNOBS, device="cpu")
    lr_, gr = jax.value_and_grad(rc.soft_loss)(
        kr, rb, rcols, rts, jnp.float32(tau), jnp.float32(200.0))
    lp, gp = pc._soft_loss_grad(kp, pb, pcols, pts, torch.tensor(tau),
                                torch.tensor(200.0))
    return (float(lr_), gr), (float(lp), gp)


@pytest.mark.parametrize("tau", [1.0, 0.1, 0.03])
def test_soft_loss_and_grad_match_jax(opt_inputs, tau):
    (lr_, gr), (lp, gp) = _loss_and_grad(opt_inputs, tau)
    assert lp == pytest.approx(lr_, rel=SOFT_RTOL)
    assert set(gp) == set(gr)
    keys = ("buffer", "overcommit", "ramp") if tau == 1.0 else tuple(gr)
    for k in keys:
        np.testing.assert_allclose(_np(gp[k]), np.asarray(gr[k]),
                                   rtol=GRAD_RTOL, atol=1e-12, err_msg=k)
    assert abs(float(gp["buffer"])) > 1e-3          # real signal


def _fd(f, knobs, key, idx, eps):
    def bump(s):
        k2 = dict(knobs)
        k2[key] = knobs[key].clone()
        if idx is None:
            k2[key] = k2[key] + s
        else:
            k2[key][idx] += s
        return k2
    return (f(bump(eps)) - f(bump(-eps))) / (2.0 * eps)


def test_grad_matches_finite_differences(opt_inputs):
    """The autograd gradient through the FULL soft pipeline (analytic +
    timeline) matches central differences on the buffer fraction and the
    three promotion flows, at tau 1 (``tests/test_capacity_opt.py``)."""
    _, (pb, pcols, pts) = opt_inputs
    tau, pen = torch.tensor(1.0), torch.tensor(200.0)
    knobs = pc.make_knobs(**KNOBS, device="cpu")
    _, g = pc._soft_loss_grad(knobs, pb, pcols, pts, tau, pen)
    f = lambda k: float(pc.soft_loss(k, pb, pcols, pts, tau, pen))
    for key, idx in (("buffer", None), ("promote", 0), ("promote", 1),
                     ("promote", 2)):
        a = float(g[key]) if idx is None else float(g[key][idx])
        n = _fd(f, knobs, key, idx, eps=0.05)
        assert abs(a - n) <= FD_TOL * max(abs(n), abs(a), 1e-3), \
            (key, idx, a, n)


def test_grad_ramp_matches_fd_analytic(opt_inputs):
    """The burst-ramp knob on the analytic stage, where the path is
    smooth."""
    from repro_torch.core.scenarios import scenario_outcome
    _, (pb, pcols, _) = opt_inputs
    tau = torch.tensor(1.0)

    def loss(knobs):
        design = pc.knob_design(pb, knobs)
        consts = pc.design_consts(design)
        out = scenario_outcome(consts["a"], pc._design_params(design, pcols),
                               tau)
        return (100.0 * (1.0 - out["sla_ok"].mean())
                + 10.0 * (1.0 - out["rl_ok"].mean()))

    knobs = pc.make_knobs(buffer=0.1, promote=(0.05, 0.05, 0.05),
                          overcommit=1.2, ramp=0.7, evict_lambda=0.3,
                          device="cpu")
    leaves = {k: v.clone().requires_grad_(True) for k, v in knobs.items()}
    (a,) = torch.autograd.grad(loss(leaves), [leaves["ramp"]])
    n = _fd(lambda k: float(loss(k)), knobs, "ramp", None, eps=0.05)
    assert abs(float(a)) > 1e-4
    assert abs(float(a) - n) <= FD_TOL * max(abs(n), abs(float(a)))


# ---------------------------------------------------------------------------
# CEM, the optimizer, verification, hardening weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pop_seed", [3, 11])
def test_cem_scores_on_reference_population(opt_inputs, pop_seed):
    """The reference's population through the port's slab: failure
    counts exact, scores float32-tight; the padding mask keeps the
    padded rows (copies of the last scenario) out of the score."""
    (rb, rcols, rts), (pb, _, pts) = opt_inputs
    n = len(next(iter(rcols.values())))
    shape = bucket_shape(n)
    total = shape[0] * shape[1]
    assert total > n                            # padding rows exist
    mean = rc._flatten_knobs(rc.legacy_knobs())
    pop = mean[None, :] + 1.5 * jax.random.normal(
        jax.random.PRNGKey(pop_seed), (24, 7), jnp.float32)
    pch = {k: jnp.concatenate([v, jnp.repeat(v[-1:], total - n)]
                              ).reshape(shape) for k, v in rcols.items()}
    mask = jnp.zeros(total, jnp.float32).at[:n].set(1.0).reshape(shape)
    want = np.asarray(rc._cem_scores(pop, rb, pch, mask, rts,
                                     jnp.float32(10.0)))
    pmask = torch.tensor(np.asarray(mask))
    pchunks = {k: torch.tensor(np.asarray(v)) for k, v in pch.items()}
    got = pc._cem_scores(torch.tensor(np.asarray(pop)), pb, pchunks,
                         pmask, pts, torch.tensor(10.0)).numpy()
    _close(got, want, F32_TIGHT, "scores")
    mult = np.asarray(jax.vmap(lambda f: rc.knob_design(
        rb, rc._unflatten_knobs(f))["stateless"])(pop)) / float(rb["total"])
    fails_r = np.round((want - mult) * n / 10.0)
    fails_p = np.round((got - mult) * n / 10.0)
    assert np.array_equal(fails_p, fails_r)
    assert 0 < fails_r.max() <= n and fails_r.min() == 0
    # scoring the padded rows too would change the counts
    unmasked = pc._cem_scores(torch.tensor(np.asarray(pop)), pb,
                              pchunks, torch.ones_like(pmask), pts,
                              torch.tensor(10.0)).numpy()
    assert not np.array_equal(unmasked * total, got * n)


def test_adamw_matches_reference_step_by_step():
    rng = np.random.default_rng(0)
    shapes = {"w": (4, 3), "b": (3,), "s": (), "nested": {"u": (2, 2)}}

    def tree(fn, s=shapes):
        return {k: tree(fn, v) if isinstance(v, dict) else fn(v)
                for k, v in s.items()}
    p0 = tree(lambda sh: rng.standard_normal(sh).astype(np.float32))
    grads = [tree(lambda sh: (3.0 * rng.standard_normal(sh)).astype(
        np.float32)) for _ in range(5)]
    to_j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    to_t = lambda t: tree_t(t)

    def tree_t(t):
        return {k: tree_t(v) if isinstance(v, dict) else torch.from_numpy(
            np.asarray(v)) for k, v in t.items()}
    for kw in ({"lr": 0.05, "weight_decay": 0.1, "max_grad_norm": 1.0},
               {"lr": ref_adamw.cosine_schedule(0.1, 2, 5),
                "weight_decay": 0.0, "max_grad_norm": 50.0}):
        pkw = dict(kw)
        if callable(kw["lr"]):
            pkw["lr"] = port_adamw.cosine_schedule(0.1, 2, 5)
        ro, po = ref_adamw.make_optimizer(**kw), port_adamw.make_optimizer(
            **pkw)
        rp, pp = to_j(p0), to_t(p0)
        rs, ps = ro.init(rp), po.init(pp)
        for g in grads:
            rp, rs, rinfo = ro.update(to_j(g), rs, rp)
            pp, ps, pinfo = po.update(to_t(g), ps, pp)
            assert int(ps.step) == int(rs.step)
            _close(pinfo["grad_norm"], rinfo["grad_norm"], F32_TIGHT, "gn")
            _close(pinfo["lr"], rinfo["lr"], F32_TIGHT, "lr")
            for a, b in zip(jax.tree_util.tree_leaves(rp),
                            port_adamw._leaves(pp)):
                _close(b, a, 1e-5, "params")
            for a, b in zip(jax.tree_util.tree_leaves(rs.m),
                            port_adamw._leaves(ps.m)):
                _close(b, a, 1e-5, "m")
    bf = port_adamw.adamw_init(to_t(p0), state_dtype="bfloat16")
    assert bf.m["w"].dtype == torch.bfloat16 and bf.step.dtype == torch.int32


def test_optimizer_grad_improves_and_verifies(fleets):
    _, pfs = fleets
    res = pc.optimize_capacity(pfs, mode="grad", grad_steps=25,
                               taus=(1.0, 0.1, 0.03), device="cpu")
    assert res.improved
    assert res.provisioning_multiple <= 1.4
    v = res.verification
    assert v["all_ok"], v
    assert v["n_t_avail_ok"] == v["n_scenarios"]
    assert [h["phase"] for h in res.history] == ["grad"] * 3


def test_optimizer_cem_improves_and_verifies(fleets):
    _, pfs = fleets
    res = pc.optimize_capacity(pfs, mode="cem", cem_generations=5,
                               cem_population=24, seed=3, device="cpu")
    assert res.improved
    v = res.verification
    assert v["n_sla_ok"] == v["n_scenarios"], v
    assert v["n_t_sla_ok"] == v["n_scenarios"], v
    scores = [h["best_score"] for h in res.history]
    assert scores == sorted(scores, reverse=True)    # elitism


def test_verify_design_matches_reference(fleets, opt_inputs):
    (rb, _, _), (pb, _, _) = opt_inputs
    for kw in (None, KNOBS):
        kr = rc.ufa_knobs() if kw is None else rc.make_knobs(**kw)
        kp = (pc.ufa_knobs("cpu") if kw is None
              else pc.make_knobs(**kw, device="cpu"))
        want = rc.verify_design(rc.knob_design(rb, kr))
        got = pc.verify_design(pc.knob_design(pb, kp), device="cpu")
        for k in ("n_scenarios", "n_sla_ok", "n_t_sla_ok", "n_t_avail_ok",
                  "all_ok"):
            assert got[k] == want[k], k
        assert got["availability_min"] == pytest.approx(
            want["availability_min"], rel=F32_TIGHT)
        assert got["t_availability_mean_min"] == pytest.approx(
            want["t_availability_mean_min"], rel=AVAIL_MEAN_RTOL)
    assert pc.verify_design(pc.knob_design(pb, pc.ufa_knobs("cpu")),
                            device="cpu")["all_ok"]


def test_hardening_weights_match_reference():
    from repro.graph import CallGraph as RefGraph
    from repro_torch.graph import CallGraph, plan_hardening
    rf = ref_synth(scale=SCALE, seed=SEED, as_arrays=True)
    rf.apply_ufa_target_classes()
    pf = synthesize_fleet(scale=SCALE, seed=SEED, as_arrays=True)
    pf.apply_ufa_target_classes()
    rg, pg = RefGraph.from_fleet_state(rf), CallGraph.from_fleet_state(pf)
    for knobs in (None, KNOBS):
        want = rc.hardening_weights(
            rf, rg, knobs=None if knobs is None else rc.make_knobs(**knobs))
        got = pc.hardening_weights(
            pf, pg, knobs=None if knobs is None else pc.make_knobs(
                **knobs, device="cpu"), device="cpu")
        assert got.dtype == np.float32 and got.shape == (pf.n,)
        _close(got, want, GRAD_RTOL, "weights")
        assert (got >= 0).all()
        np.testing.assert_allclose(got[pg.critical].mean(), 1.0, rtol=1e-3)
    plan = plan_hardening(pg, service_weights=got, device="cpu")
    assert plan.certified


# ---------------------------------------------------------------------------
# the overcommit simulator
# ---------------------------------------------------------------------------

def _ref_draws(cfg):
    """The reference's realised draws (its ``_host_busy`` keys)."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(cfg.seed), 3)
    shape = (cfg.n_trials, cfg.n_hosts)
    return {"phase_u": np.asarray(jax.random.uniform(k1, (cfg.n_trials, 1))),
            "z_crit": np.asarray(jax.random.normal(k2, shape)),
            "z_pre": np.asarray(jax.random.normal(k3, shape))}


@pytest.mark.parametrize("cfg_kw", [
    {}, {"n_hosts": 64, "n_trials": 16, "seed": 5},
    {"n_hosts": 64, "n_trials": 16, "critical_fill": 0.95,
     "critical_demand_mean": 0.95, "preempt_demand_mean": 0.95,
     "max_violation_rate": 0.0},
])
def test_overcommit_rates_on_reference_draws(cfg_kw):
    rcfg = ref_oc.OvercommitSimConfig(**cfg_kw)
    pcfg = port_oc.OvercommitSimConfig(**cfg_kw)
    factors = ref_oc.factor_grid(1.0, 2.0, 0.05)
    assert np.array_equal(port_oc.factor_grid(1.0, 2.0, 0.05), factors)
    want = np.asarray(ref_oc._grid_violation_rates(rcfg,
                                                   jnp.asarray(factors)))
    draws = {k: torch.tensor(v) for k, v in _ref_draws(rcfg).items()}
    got = port_oc._grid_violation_rates(
        pcfg, torch.from_numpy(factors.astype(np.float32)), draws).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    busy_r = np.asarray(ref_oc._host_busy(jax.random.PRNGKey(rcfg.seed),
                                          rcfg, jnp.float32(1.5)))
    busy_p = port_oc._host_busy(pcfg, torch.tensor(1.5), draws).numpy()
    np.testing.assert_allclose(busy_p, busy_r, rtol=2e-6)
    # the recommendation from the same rates
    omax = port_oc.o_max()
    valid = (got <= pcfg.max_violation_rate) & (factors <= omax)
    rec = ref_oc.recommend_factor(rcfg)
    assert rec["safe"] == bool(valid.any())
    if rec["safe"]:
        assert rec["recommended"] == round(float(factors[valid][-1]), 3)


def test_recommend_factor_contracts():
    cfg = port_oc.OvercommitSimConfig(n_hosts=64, n_trials=16,
                                      critical_fill=0.95,
                                      critical_demand_mean=0.95,
                                      preempt_demand_mean=0.95,
                                      max_violation_rate=0.0)
    rec = port_oc.recommend_factor(cfg, grid_lo=1.2, grid_hi=1.6,
                                   grid_step=0.1, device="cpu")
    assert rec["safe"] is False and rec["recommended"] == 1.2
    ok = port_oc.recommend_factor(port_oc.OvercommitSimConfig(
        n_hosts=64, n_trials=16), device="cpu")
    assert ok["safe"] is True
    full = port_oc.recommend_factor(device="cpu")
    want = ref_oc.recommend_factor()
    assert full["factors"] == want["factors"]
    assert full["recommended"] == want["recommended"] == 1.5
    assert full["o_max"] == want["o_max"]
    again = port_oc.recommend_factor(device="cpu")
    assert again == full
    assert port_oc.violation_rate(port_oc.OvercommitSimConfig(), 1.5,
                                  device="cpu") == pytest.approx(
        full["violation_rates"][10])
    for lo, hi, step in ((1.0, 2.0, 0.05), (1.0, 1.3, 0.1),
                         (1.1, 1.66, 0.07), (1.0, 1.65, 0.05)):
        assert np.array_equal(port_oc.factor_grid(lo, hi, step),
                              ref_oc.factor_grid(lo, hi, step))
