"""The port's per-step failover traces and the ``scenarios`` wrappers on
the CPU against the reference, on the same fleet and the same seeded
numpy inputs: ``sweep_timeline`` with and without traces,
``simulate_timeline`` at an orchestrator's snapshot times,
``timeline_verdicts``, the digests, and ``sweep_scenarios`` /
``sweep_with_dependency_ensemble``.

Grades (``test_torch_timeline.assert_grades``).  Against the reference
run op by op (its ``_schedule``, ``_instant`` and ``_finalize`` under
``jax.disable_jit()``, ``_carry0`` / ``_carry_step`` step by step),
every trace and summary key is exact but ``availability_mean``, a
float32 sum in another order (rtol 1e-5).  Against the compiled reference, booleans,
infinities and the integer-valued series are exact, and finite floats
are held to rtol 1e-6 (XLA's CPU code fuses multiply-adds)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import scenarios as ref_sc  # noqa: E402
from repro.core import timeline_sim as ref_tl  # noqa: E402
from repro.core.capacity import RegionCapacity as RefRegion  # noqa: E402
from repro.core.omg import Orchestrator as RefOrch  # noqa: E402
from repro.core.service import ServiceSpec as RefSpec  # noqa: E402
from repro.core.service import synthesize_fleet  # noqa: E402
from repro_torch.convert import from_reference_arrays  # noqa: E402
from repro_torch.core import scenarios as port_sc  # noqa: E402
from repro_torch.core import timeline_sim as port_tl  # noqa: E402
from repro_torch.core.capacity import RegionCapacity  # noqa: E402
from repro_torch.core.omg import Orchestrator  # noqa: E402
from repro_torch.core.service import ServiceSpec  # noqa: E402
from repro_torch.core.sweep_engine import CHUNK, SweepEngine  # noqa: E402
from repro_torch.core.tiers import FailureClass, Tier  # noqa: E402
from repro_torch.graph import CallGraph  # noqa: E402

from test_torch_timeline import assert_grades  # noqa: E402

# integer-valued trace series: exact against the compiled reference too
COUNT_SERIES = ("rl_bursted", "rl_not_bursted", "rl_t_steady", "terminated",
                "am_bursted")


@pytest.fixture(scope="module")
def fleets():
    ref = synthesize_fleet(scale=0.03, seed=11, as_arrays=True)
    ref.apply_ufa_target_classes()
    fields = {f.name: getattr(ref, f.name)
              for f in dataclasses.fields(ref) if f.name != "edges"}
    fields["edges"] = dataclasses.asdict(ref.edges)
    port = from_reference_arrays(fleet=fields, device="cpu")["fleet"]
    return ref, port, ref_tl.config_for_fleet(ref), \
        port_tl.config_for_fleet(port)


def _params(n, preheat, seed):
    """The default grid's axes tiled to ``n`` rows, every other axis at
    its default, plus seeded dependency and storm columns."""
    grid = ref_sc.scenario_grid(evict_fraction=(0.5, 1.0))
    p = {k: np.resize(np.asarray(v, np.float32), n) for k, v in grid.items()}
    defaults = ref_tl.default_scenario(burst_delay_s=preheat)
    for k in ref_tl.PARAM_KEYS:
        p.setdefault(k, np.full(n, defaults[k], np.float32))
    rng = np.random.default_rng(seed)
    p["dep_broken_frac"] = ((rng.random(n) < 0.25)
                            * rng.random(n) * 0.02).astype(np.float32)
    p["storm_refrac"] = np.resize(np.float32([0.0, 0.1, 0.3]), n)
    p["storm_broken_frac"] = (rng.random(n) * 0.01).astype(np.float32)
    return p


def _ref_op_by_op(cfg, p):
    """The reference's trace path run op by op: ``_schedule`` and
    ``_instant`` vmapped over every (scenario, step) pair under
    ``jax.disable_jit()``, the carry folded step by step through
    ``_carry_step`` (compiled once: its one float sum, ``avail_int``,
    feeds only ``availability_mean``), then ``_finalize``."""
    c = cfg.as_consts()
    ts = ref_tl.default_ts().astype(np.float32)
    n, T = len(p["traffic_mult"]), len(ts)
    with jax.disable_jit():
        tr = jax.vmap(lambda q, t: ref_tl._instant(
            c, q, ref_tl._schedule(c, q), t))(
            {k: np.repeat(v, T) for k, v in p.items()}, np.tile(ts, n))
        tr = {k: np.asarray(v).reshape((n, T) + v.shape[1:])
              for k, v in tr.items()}
        s = jax.vmap(lambda q: ref_tl._schedule(c, q))(p)
    tier_total = jnp.maximum(c["tier_class"].sum(axis=1), 1e-9)
    step = jax.jit(ref_tl._carry_step)
    carry = {k: jnp.broadcast_to(v, (n,) + v.shape)
             for k, v in ref_tl._carry0(ts).items()}
    for i in range(T):
        carry = step(carry, {k: tr[k][:, i] for k in (
            "availability", "util_model", "cloud_used", "tier_live")},
            ts[i], tier_total)
    carry["prev_t"] = jnp.broadcast_to(carry["prev_t"], (n,))
    with jax.disable_jit():
        summary = jax.vmap(lambda q, sch, cr: ref_tl._finalize(
            c, q, sch, cr, jnp.asarray(ts)))(p, s, carry)
    out = {k: np.asarray(v) for k, v in summary.items()}
    out["t"] = ref_tl.default_ts()
    out.update({f"trace_{k}": v for k, v in tr.items()})
    return out


def _exact_counts(got, want):
    for k in COUNT_SERIES:
        assert np.array_equal(got[f"trace_{k}"], want[f"trace_{k}"]), k


def test_traces_match_reference_op_by_op(fleets):
    """32 scenarios: every trace and summary key bit for bit, but the
    reordered ``availability_mean``."""
    _, _, cfg, pcfg = fleets
    p = _params(32, cfg.preheat_s, seed=1)
    want = _ref_op_by_op(cfg, p)
    got = port_tl.sweep_timeline(pcfg, grid=p, return_traces=True,
                                 device="cpu")
    assert_grades(got, want, fused=False)
    for k in want:
        if k.startswith("trace_"):
            assert got[k].shape == want[k].shape and got[k].dtype == np.float32
    assert got["trace_tier_live"].shape == (32, 240, 7)


@pytest.mark.parametrize("return_traces", [True, False])
def test_sweep_timeline_matches_compiled_reference(fleets, return_traces):
    _, _, cfg, pcfg = fleets
    p = _params(256, cfg.preheat_s, seed=2)
    want = ref_tl.sweep_timeline(cfg, grid=p, return_traces=return_traces)
    got = port_tl.sweep_timeline(pcfg, grid=p, return_traces=return_traces,
                                 device="cpu")
    assert_grades(got, want)
    if return_traces:
        _exact_counts(got, want)
    assert got["avail_ok"].any() and not got["sla_ok"].all()


def test_summary_bit_identical_with_and_without_traces(fleets):
    _, _, _, pcfg = fleets
    p = _params(300, pcfg.preheat_s, seed=3)
    on = port_tl.sweep_timeline(pcfg, grid=p, return_traces=True,
                                device="cpu")
    off = port_tl.sweep_timeline(pcfg, grid=p, device="cpu")
    assert set(on) == set(off) | {"t"} | {k for k in on
                                          if k.startswith("trace_")}
    for k, v in off.items():
        assert v.dtype == on[k].dtype and np.array_equal(v, on[k]), k


def test_chunking_at_one_past_a_chunk(fleets):
    """4,097 scenarios run as a chunk of 4,096 and one of a single row:
    the summary against the compiled reference, the rows around the seam
    and the last row's traces against the reference's on those rows."""
    _, _, cfg, pcfg = fleets
    n = CHUNK + 1
    p = _params(n, cfg.preheat_s, seed=4)
    got = port_tl.sweep_timeline(pcfg, grid=p, return_traces=True,
                                 device="cpu")
    assert got["trace_availability"].shape == (n, 240)
    assert got["trace_tier_live"].shape == (n, 240, 7)
    want = ref_tl.sweep_timeline(cfg, grid=p)
    assert_grades({k: v for k, v in got.items() if k in want}, want)
    seam = slice(CHUNK - 3, n)
    want_seam = ref_tl.sweep_timeline(
        cfg, grid={k: v[seam] for k, v in p.items()}, return_traces=True)
    assert_grades({k: (v if k == "t" else v[seam]) for k, v in got.items()},
                  want_seam)
    _exact_counts({k: (v if k == "t" else v[seam]) for k, v in got.items()},
                  want_seam)


def _mix_fleet(spec, tier, fclass, n_ao=3, n_am=2, n_rl=4, n_tm=2):
    """Small explicit fleet (``tests/test_timeline_sim.py``'s mix), built
    from one package's ``ServiceSpec``, ``Tier`` and ``FailureClass``."""
    fleet = {}

    def add(pfx, n, t, fc, cores):
        for i in range(n):
            name = f"{pfx}-{i}"
            fleet[name] = spec(name, t, fc, 1.0, int(cores * (i + 1)))
    add("ao", n_ao, tier.T0, fclass.ALWAYS_ON, 40)
    add("am", n_am, tier.T2, fclass.ACTIVE_MIGRATE, 20)
    add("rl", n_rl, tier.T3, fclass.RESTORE_LATER, 6)
    add("tm", n_tm, tier.NP, fclass.TERMINATE, 4)
    return fleet


@pytest.mark.parametrize("mix,params", [
    (dict(), {}),
    (dict(n_am=0), {"traffic_mult": 1.6, "evict_fraction": 0.75}),
    (dict(n_rl=0, n_tm=0, n_am=3), {"cloud_quota_frac": 0.0}),
    (dict(), {"burst_delay_s": 600.0, "dep_broken_frac": 0.1,
              "storm_refrac": 0.3, "storm_t0_s": 300.0}),
])
def test_simulate_timeline_at_orchestrator_snapshots(mix, params):
    """A traced ``Orchestrator.failover()``'s snapshot times (not
    uniform, with repeats) as the time grid, each package's orchestrator
    extracting its own config."""
    from repro.core import tiers as ref_tiers
    pfleet = _mix_fleet(ServiceSpec, Tier, FailureClass, **mix)
    rfleet = _mix_fleet(RefSpec, ref_tiers.Tier, ref_tiers.FailureClass,
                        **mix)
    rorch = RefOrch(rfleet, RefRegion.for_fleet("r", rfleet))
    porch = Orchestrator(pfleet, RegionCapacity.for_fleet("r", pfleet))
    rcfg, pcfg = rorch.timeline_config(), porch.timeline_config()
    rorch.failover(tv_failover=1.0)
    porch.failover(tv_failover=1.0)
    ts = rorch.timeline.as_arrays()["t"]
    assert np.array_equal(ts, porch.timeline.as_arrays()["t"])
    assert len(np.unique(np.diff(ts))) > 2
    want = ref_tl.simulate_timeline(rcfg, params=params, ts=ts)
    got = port_tl.simulate_timeline(pcfg, params=params, ts=ts,
                                    device="cpu")
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == np.shape(w), k
    assert_grades({k: np.atleast_1d(v) for k, v in got.items()},
                  {k: np.atleast_1d(v) for k, v in want.items()})
    _exact_counts({f"trace_{k}": got[k] for k in COUNT_SERIES},
                  {f"trace_{k}": want[k] for k in COUNT_SERIES})


def test_timeline_verdicts_one_scenario(fleets):
    _, _, cfg, pcfg = fleets
    ts = ref_tl.default_ts()
    for over in ({}, {"cloud_quota_frac": 0.0, "traffic_mult": 2.2}):
        q = ref_tl.default_scenario(burst_delay_s=cfg.preheat_s, **over)
        want = {k: np.asarray(v) for k, v in jax.jit(ref_tl.timeline_verdicts)(
            cfg.as_consts(), ref_tl._as_params(q),
            jnp.asarray(ts, jnp.float32)).items()}
        got = port_tl.timeline_verdicts(
            pcfg.as_consts("cpu"), port_tl._as_params(q, "cpu"),
            torch.from_numpy(ts.astype(np.float32)))
        got = {k: v.numpy() for k, v in got.items()}
        assert got["time_to_restore_s"].shape == (7,)
        assert_grades({k: np.atleast_1d(v) for k, v in got.items()},
                      {k: np.atleast_1d(v) for k, v in want.items()})
    # tau no longer raises: the soft relaxation matches the reference's
    for tau in (0.1, 1.0):
        want = jax.jit(ref_tl.timeline_verdicts)(
            cfg.as_consts(), ref_tl._as_params(q),
            jnp.asarray(ts, jnp.float32), jnp.asarray(tau, jnp.float32))
        got = port_tl.timeline_verdicts(
            pcfg.as_consts("cpu"), port_tl._as_params(q, "cpu"),
            torch.from_numpy(ts.astype(np.float32)),
            torch.tensor(tau, dtype=torch.float32))
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), np.asarray(v),
                                       rtol=1e-5, atol=1e-7, err_msg=k)


def test_digests_and_mask_exact(fleets):
    _, _, cfg, pcfg = fleets
    p = _params(256, cfg.preheat_s, seed=5)
    p["cloud_quota_frac"][::7] = 0.0           # some RL never restores
    res = ref_tl.sweep_timeline(cfg, grid=p)
    assert port_tl.summarize_timeline_sweep(res) == \
        ref_tl.summarize_timeline_sweep(res)
    got = port_tl.summarize_timeline_sweep(
        port_tl.sweep_timeline(pcfg, grid=p, device="cpu"))
    want = ref_tl.summarize_timeline_sweep(res)
    assert got.keys() == want.keys()
    for k in ("n_scenarios", "n_sla_ok", "n_rl_rto_met",
              "n_rl_never_restored"):
        assert got[k] == want[k], k
    assert want["n_rl_never_restored"] > 0
    grid = ref_sc.scenario_grid()
    assert np.array_equal(port_sc.operating_point_mask(grid),
                          ref_sc.operating_point_mask(grid))
    assert port_sc.operating_point_mask(grid).sum() == 1
    agg = ref_sc.FleetAggregates.from_fleet_state(fleets[0])
    for timeline in (None, cfg):
        r = ref_sc.sweep_scenarios(agg, grid, timeline=timeline)
        assert port_sc.summarize_sweep(r) == ref_sc.summarize_sweep(r)
        assert port_sc.scenario_records(r) == ref_sc.scenario_records(r)


@pytest.mark.parametrize("with_dep", [False, True])
def test_sweep_scenarios_analytic(fleets, with_dep):
    ref_fs, port_fs, _, pcfg = fleets
    grid = ref_sc.scenario_grid(evict_fraction=(0.5, 1.0))
    n = len(grid["traffic_mult"])
    dep = (np.random.default_rng(6).random(n) * 0.01 if with_dep else None)
    ragg = ref_sc.FleetAggregates.from_fleet_state(ref_fs)
    pagg = port_sc.FleetAggregates.from_fleet_state(port_fs)
    want = ref_sc.sweep_scenarios(ragg, grid, dep_broken_frac=dep)
    got = port_sc.sweep_scenarios(pagg, grid, dep_broken_frac=dep,
                                  device="cpu")
    assert_grades(got, want)
    # timeline= runs the fused engine
    eng = SweepEngine(pagg, pcfg, device="cpu").run(grid, dep_broken_frac=dep)
    fused = port_sc.sweep_scenarios(pagg, grid, dep_broken_frac=dep,
                                    timeline=pcfg, device="cpu")
    assert set(fused) == set(eng)
    for k in eng:
        assert np.array_equal(fused[k], eng[k]), k


@pytest.mark.parametrize("temporal", [False, True])
def test_sweep_with_dependency_ensemble(fleets, temporal):
    ref_fs, port_fs, _, _ = fleets
    grid = ref_sc.scenario_grid(traffic_mult=(1.8, 2.0),
                                evict_fraction=(0.25, 0.5, 1.0))
    got = port_sc.sweep_with_dependency_ensemble(
        port_fs, grid, seed=3, temporal=temporal, device="cpu")
    want = ref_sc.sweep_with_dependency_ensemble(ref_fs, grid, seed=3,
                                                 temporal=temporal)
    assert_grades(got, want, avail_mean_key="t_availability_mean")
    assert got["dep_n_broken_critical"].dtype == np.int32
    assert got["dep_n_broken_critical"].max() > 0
    if temporal:
        # the port's engine under the same stage seed, bit for bit
        eng = SweepEngine(port_sc.FleetAggregates.from_fleet_state(port_fs),
                          port_tl.config_for_fleet(port_fs),
                          graph=CallGraph.from_fleet_state(port_fs),
                          seed=port_sc.stage_seed(3, "sweep-engine"),
                          device="cpu").run(grid)
        assert set(eng) == set(got)
        for k in eng:
            assert np.array_equal(eng[k], got[k]), k
