"""The port's chaos campaigns on the CPU against the reference, on the
same fleets and the same inputs: the fault library and grid helpers,
the correlated sampler's statistical contracts, N-region topologies,
synthetic-oracle campaigns, the engine campaign on a hardened fleet with
its bit-exact replay, and sampled faults and topologies through the
engine.

Grades.  Host copies (library, grids, topologies, synthetic-oracle
reports) are exact, the report JSON byte-identical.  Engine campaigns:
statuses, brackets, probe rows, ``ok`` and every boolean verdict exact;
float verdicts rtol 1e-6 and ``t_availability_mean`` rtol 1e-5 (a
float32 sum in another order, ``test_torch_timeline.assert_grades``).
The sampler cannot reproduce ``jax.random``'s bits: it is held to the
contracts of ``tests/test_chaos.py`` (marginals, one draw a seed, rank
correlations, independence from the engine's stages), and given the
reference's realised severities the grid is exact."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import chaos as ref  # noqa: E402
from repro.chaos.faults import ray_severities as ref_ray_severities  # noqa: E402
from repro.core.scenarios import stage_seed  # noqa: E402
from repro.core.service import synthesize_fleet as ref_synth  # noqa: E402
from repro.graph import CallGraph as RefGraph  # noqa: E402
from repro.graph.planner import plan_hardening as ref_plan  # noqa: E402
from repro_torch import chaos as port  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.chaos.faults import ray_severities  # noqa: E402
from repro_torch.core.service import synthesize_fleet  # noqa: E402

from test_torch_timeline import AVAIL_MEAN_RTOL, F32_TIGHT  # noqa: E402

SEEDS = (0, 7, 12345, 2**20)
RAYS3 = ("preheat_stall", "burst_shortfall", "dependency_storm")


# ---------------------------------------------------------------------------
# fault library, grids, sampler
# ---------------------------------------------------------------------------

def test_library_and_exports_are_the_references():
    assert port.FAMILIES == ref.FAMILIES
    assert port.REQUEST_FAMILIES == ref.REQUEST_FAMILIES
    assert list(port.FAULT_LIBRARY) == list(ref.FAULT_LIBRARY)
    for name, fam in ref.FAULT_LIBRARY.items():
        mine = port.FAULT_LIBRARY[name]
        assert (mine.name, mine.knob, mine.base, mine.worst, mine.doc) == \
            (fam.name, fam.knob, fam.base, fam.worst, fam.doc)
    assert sorted(port.__all__) == sorted(ref.__all__)
    from repro.chaos import faults as rf
    from repro_torch.chaos import faults as pf
    assert pf.DEFAULT_CORR_PAIRS == rf.DEFAULT_CORR_PAIRS
    assert sorted(pf.__all__) == sorted(rf.__all__)


@pytest.mark.parametrize("seed", SEEDS)
def test_grid_helpers_equal_reference(seed):
    rng = np.random.default_rng(seed)
    sev = rng.random((33, len(ref.FAMILIES)))
    want = ref.severity_grid(sev)
    got = port.severity_grid(sev)
    assert list(got) == list(want)
    for k in want:
        assert np.array_equal(got[k], want[k]) and got[k].dtype == np.float64
    direction = {"traffic_spike": 1.0, "quota_shortfall": 0.75}
    s = rng.random(9)
    assert np.array_equal(ray_severities(direction, s),
                          ref_ray_severities(direction, s))
    pairs = {("evict_shortfall", "traffic_spike"): float(rng.random() * 0.5)}
    assert np.array_equal(port.correlation_matrix(pairs=pairs),
                          ref.correlation_matrix(pairs=pairs))
    assert np.array_equal(port.correlation_matrix(),
                          ref.correlation_matrix())


def test_validation_errors_are_the_references():
    with pytest.raises(np.linalg.LinAlgError):
        port.correlation_matrix(
            pairs={("evict_shortfall", "traffic_spike"): 1.2})
    with pytest.raises(ValueError):
        port.Ray("empty", {})
    with pytest.raises(KeyError):
        port.Ray("bad", {"not_a_family": 1.0})
    with pytest.raises(ValueError):
        port.Ray("bad", {"traffic_spike": 1.5})
    with pytest.raises(KeyError):
        ray_severities({"nope": 1.0}, [0.5])
    with pytest.raises(ValueError):
        port.severity_grid(np.zeros((2, 3)))
    with pytest.raises(ValueError):
        port.sample_faults(0, 4, corr=np.eye(3), device="cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_grid_from_reference_severities_is_exact(seed):
    """Given the reference's realised severities, the port's grid is the
    reference's grid bit for bit."""
    out = ref.sample_faults(seed, 256, max_severity=0.8)
    got = port.severity_grid(out["severity"], out["families"])
    for k, v in out["grid"].items():
        assert np.array_equal(got[k], v), k


@pytest.mark.parametrize("seed", SEEDS)
def test_sampler_marginals_and_reproducibility(seed):
    """Marginals Uniform(0, max_sev); one campaign seed reproduces the
    draw exactly; another seed draws another one."""
    out = port.sample_faults(seed, 4096, max_severity=0.8, device="cpu")
    sev = out["severity"]
    assert sev.shape == (4096, len(port.FAMILIES))
    assert sev.dtype == np.float64
    assert (sev >= 0.0).all() and (sev <= 0.8).all()
    # Uniform(0, 0.8): mean 0.4, sd 0.8/sqrt(12) ~ 0.23 -> sem ~ 0.0036
    np.testing.assert_allclose(sev.mean(axis=0), 0.4, atol=0.02)
    np.testing.assert_allclose(sev.std(axis=0), 0.8 / np.sqrt(12), atol=0.01)
    # each decile holds ~10% of the draws (uniform, not just centred)
    hist = np.stack([np.histogram(c, bins=10, range=(0, 0.8))[0]
                     for c in sev.T]) / len(sev)
    np.testing.assert_allclose(hist, 0.1, atol=0.025)
    again = port.sample_faults(seed, 4096, max_severity=0.8, device="cpu")
    assert np.array_equal(sev, again["severity"])
    other = port.sample_faults(seed + 1, 4096, max_severity=0.8,
                               device="cpu")
    assert not np.array_equal(sev, other["severity"])
    assert out["families"] == port.FAMILIES
    for k, v in port.severity_grid(sev).items():
        assert np.array_equal(out["grid"][k], v), k


def _spearman(a, b):
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    return float(np.corrcoef(ra, rb)[0, 1])


@pytest.mark.parametrize("seed", SEEDS)
def test_sampler_rank_correlations(seed):
    """The Gaussian copula's rank correlation is 6/pi asin(rho/2) for
    every requested pair; pairs with no requested correlation stay
    independent (n = 8192: one standard error ~0.011)."""
    out = port.sample_faults(seed, 8192, device="cpu")
    sev = out["severity"]
    idx = {name: j for j, name in enumerate(out["families"])}
    corr = port.correlation_matrix()
    for (a, b), rho in port.faults.DEFAULT_CORR_PAIRS.items():
        want = 6.0 / np.pi * np.arcsin(rho / 2.0)
        got = _spearman(sev[:, idx[a]], sev[:, idx[b]])
        assert abs(got - want) < 0.05, (a, b, got, want)
    for i in range(len(idx)):
        for j in range(i):
            if corr[i, j] == 0.0:
                assert abs(_spearman(sev[:, i], sev[:, j])) < 0.05, (i, j)


def test_sampler_stream_independent_of_engine_stages():
    """The sampler's generator is seeded from its own stage: a draw from
    the engine's stage seeds differs from it."""
    stages = ["faults", "sweep-engine", "blackhole-ensemble", "storm"]
    seeds = [stage_seed(12345, s) for s in stages]
    assert len(set(seeds)) == len(seeds)
    sev = port.sample_faults(12345, 64, device="cpu")["severity"]
    g = torch.Generator().manual_seed(stage_seed(12345, "faults"))
    z = torch.randn((64, len(port.FAMILIES)), generator=g)
    chol = torch.from_numpy(np.linalg.cholesky(
        port.correlation_matrix()).astype(np.float32))
    want = np.clip(torch.special.ndtr(z @ chol.T).numpy().astype(np.float64),
                   0.0, 1.0)
    assert np.array_equal(sev, want)
    g = torch.Generator().manual_seed(stage_seed(12345, "sweep-engine"))
    z = torch.randn((64, len(port.FAMILIES)), generator=g)
    assert not np.array_equal(
        sev, torch.special.ndtr(z @ chol.T).numpy().astype(np.float64))


# ---------------------------------------------------------------------------
# topologies (host copies)
# ---------------------------------------------------------------------------

def _topologies(seed):
    rng = np.random.default_rng(seed)
    uni = 3, [[bool(i == j) for j in range(3)] for i in range(3)], None
    pats = [[r in (a, b) for r in range(5)]
            for a in range(5) for b in range(a + 1, 5)]
    weights = tuple(float(w) for w in rng.random(5) + 0.2)
    degr = rng.random((10, 5)) * 0.6
    return [("uniform", uni[0], None, np.asarray(uni[1]), None),
            ("weighted", 5, weights, np.asarray(pats), degr)]


@pytest.mark.parametrize("seed", (0, 3))
def test_topologies_equal_reference(seed):
    for _, n, weights, failed, degr in _topologies(seed):
        if weights is None:
            rt, pt = ref.RegionTopology.uniform(n), port.RegionTopology.uniform(n)
        else:
            names = tuple(f"r{i}" for i in range(n))
            rt = ref.RegionTopology(weights=weights, names=names)
            pt = port.RegionTopology(weights=weights, names=names)
        assert rt.weights == pt.weights and rt.names == pt.names
        rgrid, rpid, rrid = ref.expand_failures(rt, failed, degr)
        pgrid, ppid, prid = port.expand_failures(pt, failed, degr)
        for k in rgrid:
            assert np.array_equal(rgrid[k], pgrid[k]), k
        assert np.array_equal(rpid, ppid) and np.array_equal(rrid, prid)
        rng = np.random.default_rng(seed + 1)
        res = {"sla_ok": rng.random(len(rpid)) < 0.8,
               "t_sla_ok": rng.random(len(rpid)) < 0.9,
               "availability": 0.999 + rng.random(len(rpid)) * 1e-3}
        want = ref.reduce_pattern_verdicts(res, rpid, rt, rrid)
        got = port.reduce_pattern_verdicts(res, ppid, pt, prid)
        for k in want:
            assert np.array_equal(want[k], got[k]), k
    with pytest.raises(ValueError):
        port.expand_failures(port.RegionTopology.uniform(2), [[True, True]])
    with pytest.raises(ValueError):
        port.RegionTopology(weights=(1.0,), names=("solo",))


# ---------------------------------------------------------------------------
# synthetic-oracle campaigns: byte-identical reports
# ---------------------------------------------------------------------------

def _threshold_oracle(thresholds):
    """Monotone synthetic oracle (``tests/test_chaos.py``'s): a row fails
    iff its strongest family severity reaches that family's threshold."""

    def oracle(grid):
        n = len(next(iter(grid.values())))
        ok = np.ones(n, bool)
        for i in range(n):
            worst_name, worst_s = None, 0.0
            for name in ref.FAMILIES:
                fam = ref.FAULT_LIBRARY[name]
                s = float(fam.severity(grid[fam.knob][i]))
                if s > worst_s:
                    worst_name, worst_s = name, s
            if worst_name is not None and worst_s >= thresholds[worst_name]:
                ok[i] = False
        return ok, {"sla_ok": ok}

    return oracle


@pytest.mark.parametrize("case", [
    (("traffic_spike", "quota_shortfall", "dependency_storm"),
     (0.31, 0.77, 0.052), 1 / 128, None),
    (("traffic_spike", "evict_shortfall", "burst_shortfall"),
     (0.5, 0.5, 0.5), 1 / 64, 1),
    (("preheat_stall", "region_degradation"), (0.9, 0.12), 1 / 256, 2),
    (None, None, 1 / 64, 3),
])
def test_synthetic_campaign_report_is_the_references(case):
    names, ts, tol, budget = case
    thresholds = dict.fromkeys(ref.FAMILIES, 2.0)
    if names is None:                   # default rays, every family fails
        thresholds.update({n: 0.1 + 0.1 * i
                           for i, n in enumerate(ref.FAMILIES)})
    else:
        thresholds.update(dict(zip(names, ts)))
    reports = []
    for pkg in (ref, port):
        rays = (None if names is None
                else [pkg.Ray(n, {n: 1.0}) for n in names])
        camp = pkg.Campaign(oracle=_threshold_oracle(thresholds), rays=rays,
                            tol=tol, round_budget=budget, seed=1)
        reports.append(camp.run())
    want, got = reports
    assert got.to_json(sort_keys=True) == want.to_json(sort_keys=True)
    assert got.render() == want.render()
    for r in want.rays:
        assert got.ray(r.name).frontier_knobs() == r.frontier_knobs()
    assert got.n_localized == want.n_localized > 0


def test_campaign_no_violation_degenerate_and_bad_config():
    rays = [port.Ray("traffic_spike", {"traffic_spike": 1.0})]
    ones = lambda g: (np.ones(len(next(iter(g.values()))), bool),
                      {"sla_ok": np.ones(len(next(iter(g.values()))), bool)})
    rep = port.Campaign(oracle=ones, rays=rays, seed=0).run()
    assert rep.rays[0].status == "no_violation" and rep.n_evals == 2
    zeros = lambda g: (np.zeros(len(next(iter(g.values()))), bool),
                       {"sla_ok": np.zeros(len(next(iter(g.values()))),
                                           bool)})
    rep = port.Campaign(oracle=zeros, rays=rays, seed=0).run()
    assert not rep.op_ok and rep.rays[0].status == "degenerate"
    assert rep.render()
    with pytest.raises(ValueError):
        port.Campaign(oracle=None, engine=None)
    with pytest.raises(ValueError):
        port.Campaign(oracle=lambda g: None, tol=0.0)
    with pytest.raises(ValueError):
        port.Campaign(oracle=lambda g: None, rays=[])


# ---------------------------------------------------------------------------
# engine campaigns on the hardened 0.05-scale fleet
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hardened():
    """The reference's test fleet (scale 0.05, seed 7, UFA target
    classes), hardened by the reference's planner; the port's own copy of
    the same fleet with the same fail-open edges."""
    fs = ref_synth(scale=0.05, seed=7, as_arrays=True)
    fs.apply_ufa_target_classes()
    graph = RefGraph.from_fleet_state(fs)
    plan = ref_plan(graph)
    fs.edges.fail_open[graph.input_edge_indices(plan.hardened_edges)] = True
    pfs = synthesize_fleet(scale=0.05, seed=7, as_arrays=True)
    pfs.apply_ufa_target_classes()
    pfs.edges.fail_open[:] = fs.edges.fail_open
    return fs, pfs


def _assert_same_report(got, want):
    assert (got.seed, got.tol, got.op_ok, got.n_evals, got.n_rounds,
            got.grid_equiv_evals) == (want.seed, want.tol, want.op_ok,
                                      want.n_evals, want.n_rounds,
                                      want.grid_equiv_evals)
    for g, w in zip(got.rays, want.rays):
        assert (g.name, g.status, g.lo, g.hi, g.frontier_severity,
                g.counterexample, g.n_probes, g.direction) == \
            (w.name, w.status, w.lo, w.hi, w.frontier_severity,
             w.counterexample, w.n_probes, w.direction)
    assert len(got.probe_log) == len(want.probe_log)
    for g, w in zip(got.probe_log, want.probe_log):
        assert (g["ray"], g["severity"], g["ok"], g["row"]) == \
            (w["ray"], w["severity"], w["ok"], w["row"])
        assert list(g["verdict"]) == list(w["verdict"])
        for k, v in w["verdict"].items():
            if isinstance(v, bool):
                assert g["verdict"][k] is v, k
            else:
                rtol = (AVAIL_MEAN_RTOL if k == "t_availability_mean"
                        else F32_TIGHT)
                np.testing.assert_allclose(g["verdict"][k], v, rtol=rtol,
                                           atol=0, err_msg=k)


@pytest.mark.parametrize("rays,tol", [(RAYS3, 1 / 32), (None, 1 / 256)])
def test_engine_campaign_equals_reference(hardened, rays, tol):
    fs, pfs = hardened
    kw = {"tol": tol, "seed": 11}
    want = ref.campaign_for_fleet(
        fs, rays=None if rays is None else
        [ref.Ray(n, {n: 1.0}) for n in rays], **kw).run()
    obs.default_registry().reset()
    obs.enable()
    try:
        camp = port.campaign_for_fleet(
            pfs, device="cpu", rays=None if rays is None else
            [port.Ray(n, {n: 1.0}) for n in rays], **kw)
        got = camp.run()
        assert obs.value("ufa_chaos_evals_total") == got.n_evals
        assert obs.value("ufa_chaos_rounds_total") == got.n_rounds
        assert obs.value("ufa_chaos_rays_localized") == got.n_localized
    finally:
        obs.disable()
    assert want.op_ok, "the hardened fleet passes its operating point"
    assert want.n_localized >= 2
    _assert_same_report(got, want)
    # one seed reproduces the whole campaign, byte for byte
    again = port.campaign_for_fleet(
        pfs, device="cpu", rays=camp.rays, **kw).run()
    assert again.to_json(sort_keys=True) == got.to_json(sort_keys=True)
    assert json.loads(got.to_json())["n_localized"] == got.n_localized


def test_verify_report_replays_and_detects_drift(hardened):
    _, pfs = hardened
    rays = [port.Ray(n, {n: 1.0}) for n in RAYS3]
    rep = port.campaign_for_fleet(pfs, seed=11, rays=rays, tol=1 / 32,
                                  device="cpu").run()
    fresh = port.campaign_for_fleet(pfs, seed=11, rays=rays, tol=1 / 32,
                                    device="cpu")
    out = port.verify_report(rep, fresh.engine)
    assert out["n_probes"] == rep.n_evals and not out["mismatches"]
    tampered = rep.probe_log[-1]["verdict"]
    for key in ("availability", "sla_ok"):
        orig = tampered[key]
        tampered[key] = (not orig) if isinstance(orig, bool) else orig + 0.5
        with pytest.raises(AssertionError):
            port.verify_report(rep, fresh.engine)
        tampered[key] = orig
    rep.probe_log[0]["ok"] = not rep.probe_log[0]["ok"]
    with pytest.raises(AssertionError):
        port.verify_report(rep, fresh.engine)
    rep.probe_log[0]["ok"] = not rep.probe_log[0]["ok"]
    assert not port.verify_report(rep, fresh.engine)["mismatches"]
    with pytest.raises(ValueError):
        port.verify_report(rep)


def _grades(got, want, keys):
    """Engine results at the grades above.  A float is also held within
    rtol of its column's largest magnitude: arbitrary sampled knobs make
    products inexact, and where the closed form subtracts two large
    terms (``ao_short_cores``: cores needed minus cores free) the
    reference's fused multiply-add (XLA's CPU code) rounds once where the
    port rounds twice, a difference of the operands' last bit."""
    for k in keys:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, k
        if w.dtype.kind != "f":
            assert np.array_equal(g, w), k
            continue
        fin = np.isfinite(w)
        assert np.array_equal(np.isfinite(g), fin), k
        assert np.array_equal(g[~fin], w[~fin]), k
        rtol = AVAIL_MEAN_RTOL if k == "t_availability_mean" else F32_TIGHT
        scale = float(np.abs(w[fin]).max()) if fin.any() else 0.0
        np.testing.assert_allclose(g[fin], w[fin], rtol=rtol,
                                   atol=rtol * scale, err_msg=k)


def test_sampled_faults_and_topologies_through_the_engine(hardened):
    """The reference's sampled faults and the two topologies through the
    port's engine and the reference's, with the same fleet and seed."""
    fs, pfs = hardened
    reng = ref.campaign_for_fleet(fs, seed=5).engine
    peng = port.campaign_for_fleet(pfs, seed=5, device="cpu").engine
    grid = ref.sample_faults(5, 600)["grid"]
    want, got = reng.run(grid), peng.run(grid)
    assert set(got) == set(want)
    _grades(got, want, [k for k in want if k not in grid])
    assert not want["sla_ok"].all() and want["t_sla_ok"].any()
    for _, n, weights, failed, degr in _topologies(9):
        if weights is None:
            topo = port.RegionTopology.uniform(n)
        else:
            topo = port.RegionTopology(
                weights=weights, names=tuple(f"r{i}" for i in range(n)))
        tgrid, pid, rid = port.expand_failures(topo, failed, degr)
        rw, pw = reng.run(tgrid), peng.run(tgrid)
        _grades(pw, rw, [k for k in rw if k not in tgrid])
        want = ref.reduce_pattern_verdicts(rw, pid, topo, rid)
        got = port.reduce_pattern_verdicts(pw, pid, topo, rid)
        assert np.array_equal(got["sla_ok"], want["sla_ok"])
        assert np.array_equal(got["worst_region"], want["worst_region"])
        np.testing.assert_allclose(got["availability"],
                                   want["availability"], rtol=1e-6)
