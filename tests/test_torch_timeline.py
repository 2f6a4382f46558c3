"""The port's per-scenario math on the CPU against the reference: the
timeline configuration and constants, the closed-form analytic model,
and ``timeline_verdicts_batch`` (schedule + closed-form series + the
verdict reduction + ``_finalize``) on the default 256-scenario grid.

Grades (``assert_grades``).  Against the reference run op by op (JAX
eager, no XLA fusion) every output is exact except ``availability_mean``,
a float32 sum in another order, held to rtol=1e-5 as the reference's own
engine-level reducer test holds it; the test shows that no ``avail_ok``
verdict sits within that distance of its threshold.  Against the
reference's compiled program (``jit``), booleans, integer counts and
which floats are infinite stay exact, and finite floats are
float32-tight, rtol=1e-6: XLA's CPU code contracts ``a * b + c`` into
one fused multiply-add, which rounds once where the port's separate ops
round twice (at most 1.2e-7 relative on these grids)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import scenarios as ref_sc  # noqa: E402
from repro.core import timeline_sim as ref_tl  # noqa: E402
from repro.core.service import synthesize_fleet  # noqa: E402
from repro_torch.convert import from_reference_arrays  # noqa: E402
from repro_torch.core import scenarios as port_sc  # noqa: E402
from repro_torch.core import timeline_sim as port_tl  # noqa: E402

F32_TIGHT = 1e-6
AVAIL_MEAN_RTOL = 1e-5


def assert_grades(got, want, avail_mean_key="availability_mean",
                  fused=True):
    """Hold the port's outputs to the reference's.  ``fused``: ``want``
    comes from a compiled reference program (finite floats
    float32-tight); otherwise from an op-by-op run (floats exact).
    ``avail_mean_key`` is a reordered float32 sum either way."""
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        if w.dtype.kind != "f":
            assert np.array_equal(g, w), k
            continue
        finite = np.isfinite(w)
        assert np.array_equal(np.isfinite(g), finite), k
        assert np.array_equal(g[~finite], w[~finite]), k
        if k == avail_mean_key:
            np.testing.assert_allclose(g[finite], w[finite], atol=0,
                                       rtol=AVAIL_MEAN_RTOL, err_msg=k)
        elif fused:
            np.testing.assert_allclose(g[finite], w[finite], atol=0,
                                       rtol=F32_TIGHT, err_msg=k)
        else:
            assert np.array_equal(g, w), k


@pytest.fixture(scope="module")
def fleets():
    ref = synthesize_fleet(scale=0.03, seed=11, as_arrays=True)
    ref.apply_ufa_target_classes()
    fields = {f.name: getattr(ref, f.name)
              for f in dataclasses.fields(ref) if f.name != "edges"}
    fields["edges"] = dataclasses.asdict(ref.edges)
    port = from_reference_arrays(fleet=fields, device="cpu")["fleet"]
    return ref, port


def _params(grid, n, preheat, rng):
    p = {k: np.asarray(v, np.float32) for k, v in grid.items()}
    defaults = ref_tl.default_scenario(burst_delay_s=preheat)
    for k in ref_tl.PARAM_KEYS:
        p.setdefault(k, np.full(n, defaults[k], np.float32))
    p["dep_broken_frac"] = ((rng.random(n) < 0.25)
                            * rng.random(n) * 0.02).astype(np.float32)
    p["storm_refrac"] = np.resize(np.float32([0.0, 0.1, 0.3]), n)
    p["storm_broken_frac"] = (rng.random(n) * 0.01).astype(np.float32)
    return p


def test_timeline_config_and_consts_match(fleets):
    ref_fs, port_fs = fleets
    rc, pc = ref_tl.config_for_fleet(ref_fs), port_tl.config_for_fleet(port_fs)
    for f in dataclasses.fields(rc):
        assert np.array_equal(getattr(rc, f.name), getattr(pc, f.name)), f.name
    # and the converter carries a reference config over unchanged
    conv = from_reference_arrays(timeline=dataclasses.asdict(rc))["timeline"]
    assert dataclasses.asdict(conv).keys() == dataclasses.asdict(pc).keys()
    rk, pk = rc.as_consts(), conv.as_consts("cpu")
    assert set(rk) == set(pk)
    for k in rk:
        assert pk[k].dtype == torch.float32
        assert np.array_equal(np.asarray(rk[k]), pk[k].numpy()), k
    assert np.array_equal(port_tl.default_ts(), ref_tl.default_ts())
    assert port_tl.PARAM_KEYS == ref_tl.PARAM_KEYS
    assert port_tl.default_scenario() == ref_tl.default_scenario()


def test_analytic_outcome_matches_reference(fleets):
    ref_fs, port_fs = fleets
    grid = ref_sc.scenario_grid(evict_fraction=(0.25, 1.0))
    n = len(grid["traffic_mult"])
    p = _params(grid, n, 270.0, np.random.default_rng(0))
    ragg = ref_sc.FleetAggregates.from_fleet_state(ref_fs)
    pagg = port_sc.FleetAggregates.from_fleet_state(port_fs)
    assert dataclasses.asdict(ragg) == dataclasses.asdict(pagg)
    rconsts = ref_sc.analytic_consts(ragg)
    pconsts = from_reference_arrays(
        analytic={k: np.asarray(v) for k, v in rconsts.items()},
        device="cpu")["analytic"]
    for k, v in port_sc.analytic_consts(pagg, device="cpu").items():
        assert torch.equal(v, pconsts[k]), k
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    compiled = {k: np.asarray(v)
                for k, v in ref_sc._sweep_jit(rconsts, jp).items()}
    with jax.disable_jit():
        eager = {k: np.asarray(v) for k, v in jax.vmap(
            ref_sc._scenario_outcome, in_axes=(None, 0))(rconsts, jp).items()}
    got = {k: v.numpy() for k, v in port_sc.scenario_outcome(
        pconsts, {k: torch.from_numpy(v) for k, v in p.items()}).items()}
    assert_grades(got, eager, fused=False)
    assert_grades(got, compiled)


def test_timeline_verdicts_batch_matches_reference(fleets, monkeypatch):
    """The default 256-scenario grid with dependency and storm columns,
    against the reference's Pallas verdict reduction (interpret mode) run
    op by op and compiled, and against its sequential scan
    (``sweep_timeline``)."""
    monkeypatch.setenv("REPRO_UFA_KERNELS", "1")
    ref_fs, port_fs = fleets
    cfg = ref_tl.config_for_fleet(ref_fs)
    grid = ref_sc.scenario_grid()
    n = len(grid["traffic_mult"])
    p = _params(grid, n, cfg.preheat_s, np.random.default_rng(1))
    ts = ref_tl.default_ts()
    args = (cfg.as_consts(), {k: jnp.asarray(v) for k, v in p.items()},
            jnp.asarray(ts, jnp.float32))
    eager = {k: np.asarray(v)
             for k, v in ref_tl.timeline_verdicts_batch(*args).items()}
    pallas = {k: np.asarray(v) for k, v in
              jax.jit(ref_tl.timeline_verdicts_batch)(*args).items()}
    scan = ref_tl.sweep_timeline(cfg, grid=p, ts=ts)
    pcfg = port_tl.config_for_fleet(port_fs)
    got = port_tl.timeline_verdicts_batch(
        pcfg.as_consts("cpu"), {k: torch.from_numpy(v) for k, v in p.items()},
        torch.from_numpy(ts.astype(np.float32)))
    got = {k: v.numpy() for k, v in got.items()}
    assert_grades(got, eager, fused=False)
    assert_grades(got, pallas)
    assert_grades(got, scan)
    # the avail_ok verdicts are exact with room to spare: every scenario's
    # availability mean sits further from the threshold than the float32
    # difference between the two sums
    margin = np.abs(scan["availability_mean"].astype(np.float64)
                    - (ref_tl.BASE_AVAILABILITY - ref_tl.AVAIL_SLA_TOL))
    diff = np.abs(got["availability_mean"].astype(np.float64)
                  - scan["availability_mean"])
    assert (margin > diff).all()
    assert got["avail_ok"].any() and not got["avail_ok"].all()
