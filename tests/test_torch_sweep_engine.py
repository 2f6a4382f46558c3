"""The slice as a whole on the CPU: the port's ``SweepEngine.run``
against the reference's, fed the same fleet, with and without the
dependency stage, plus the engine's padding, dtype and API contracts.

Grades as in ``test_torch_timeline.assert_grades`` against a compiled
reference: booleans and int32 counts exact, finite floats float32-tight
(rtol=1e-6; the reference's compiled CPU program fuses multiply-adds,
while ``test_torch_timeline`` shows the port bit-exact against the
reference run op by op), ``t_availability_mean`` rtol=1e-5 (a float32
sum in another order)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.scenarios import FleetAggregates as RefAgg  # noqa: E402
from repro.core.scenarios import scenario_grid  # noqa: E402
from repro.core.service import synthesize_fleet  # noqa: E402
from repro.core.sweep_engine import SweepEngine as RefEngine  # noqa: E402
from repro.core.timeline_sim import config_for_fleet as ref_config  # noqa: E402
from repro.graph import CallGraph as RefGraph  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.convert import from_reference_arrays  # noqa: E402
from repro_torch.core import sweep_engine as port_se  # noqa: E402
from repro_torch.core.omg import Orchestrator  # noqa: E402
from repro_torch.core.capacity import RegionCapacity  # noqa: E402
from repro_torch.core.scenarios import FleetAggregates  # noqa: E402
from repro_torch.core.sweep_engine import (SweepEngine, bucket_shape,  # noqa: E402
                                           fused_sweep, tile_grid)
from repro_torch.core.timeline_sim import config_for_fleet  # noqa: E402
from repro_torch.graph import CallGraph  # noqa: E402

from test_torch_timeline import assert_grades  # noqa: E402

_ALLOWED = (np.float32, np.bool_, np.int32)


@pytest.fixture(scope="module")
def parts():
    """The reference's fleet and the port's copy of it (via the
    converter), each with its engine inputs."""
    ref = synthesize_fleet(scale=0.05, seed=7, as_arrays=True)
    ref.apply_ufa_target_classes()
    fields = {f.name: getattr(ref, f.name)
              for f in dataclasses.fields(ref) if f.name != "edges"}
    fields["edges"] = dataclasses.asdict(ref.edges)
    fs = from_reference_arrays(fleet=fields, device="cpu")["fleet"]
    ref_parts = (RefAgg.from_fleet_state(ref), ref_config(ref),
                 RefGraph.from_fleet_state(ref))
    port_parts = (FleetAggregates.from_fleet_state(fs), config_for_fleet(fs),
                  CallGraph.from_fleet_state(fs))
    return ref_parts, port_parts, fs


def _storm_grid():
    grid = scenario_grid(evict_fraction=(0.25, 0.5, 1.0))
    n = len(grid["traffic_mult"])
    grid["storm_refrac"] = np.resize(np.array([0.0, 0.1, 0.3]), n)
    return grid


def _port_grades(got, want):
    assert_grades(got, want, avail_mean_key="t_availability_mean")


def test_engine_with_dependency_and_storm_matches_reference(parts):
    (ragg, rcfg, rgraph), (agg, cfg, graph), _ = parts
    grid = _storm_grid()
    want = RefEngine(ragg, rcfg, graph=rgraph, seed=3).run(grid)
    eng = SweepEngine(agg, cfg, graph=graph, seed=3, device="cpu")
    got = eng.run(grid)
    _port_grades(got, want)
    # the stages did real work: nested dark sets, broken criticals, storms
    assert len(np.unique(got["dep_n_dark"])) == 3
    assert got["dep_n_broken_critical"].max() > 0
    assert (got["storm_broken_frac"] > 0).any() and not got["storm_ok"].all()
    # the composed host helpers agree with the in-pipeline stage
    frac, counts, n_dark = eng.dep_fractions(grid["evict_fraction"])
    assert np.array_equal(frac, got["dep_broken_frac"])
    assert np.array_equal(counts, got["dep_n_broken_critical"])
    assert np.array_equal(n_dark, got["dep_n_dark"])
    ref_eng = RefEngine(ragg, rcfg, graph=rgraph, seed=3)
    assert np.array_equal(eng.storm_fractions(grid["storm_refrac"]),
                          ref_eng.storm_fractions(grid["storm_refrac"]))


def test_engine_explicit_dep_frac_matches_reference(parts):
    (ragg, rcfg, _), (agg, cfg, _), _ = parts
    grid = scenario_grid(evict_fraction=(1.0, 0.5))
    n = len(grid["traffic_mult"])
    rng = np.random.default_rng(4)
    dep = (rng.random(n) < 0.3) * rng.random(n) * 0.01
    want = RefEngine(ragg, rcfg).run(grid, dep_broken_frac=dep)
    got = SweepEngine(agg, cfg, device="cpu").run(grid, dep_broken_frac=dep)
    _port_grades(got, want)
    analytic = SweepEngine(agg, cfg, device="cpu").run(grid, temporal=False)
    assert not any(k.startswith("t_") for k in analytic)
    want = RefEngine(ragg, rcfg).run(grid, temporal=False)
    _port_grades(analytic, want)


def test_multi_chunk_padding_matches_reference(parts):
    """A grid over several chunks (small chunk width), padded with its
    last scenario: padding never leaks into the verdicts."""
    (ragg, rcfg, rgraph), (agg, cfg, graph), _ = parts
    grid = tile_grid(_storm_grid(), 700)
    want = RefEngine(ragg, rcfg, graph=rgraph, chunk=256).run(grid)
    got = SweepEngine(agg, cfg, graph=graph, chunk=256,
                      device="cpu").run(grid)
    assert len(got["sla_ok"]) == 700
    _port_grades(got, want)


def test_output_dtypes_pinned(parts):
    _, (agg, cfg, graph), _ = parts
    grid = scenario_grid(evict_fraction=(1.0, 0.5))
    res = SweepEngine(agg, cfg, graph=graph, device="cpu").run(grid)
    for k, v in res.items():
        if k in grid:
            assert v is not None and np.array_equal(v, grid[k])
            continue
        assert v.dtype in _ALLOWED, (k, v.dtype)
    assert res["dep_n_dark"].dtype == np.int32
    assert res["t_time_to_restore_s"].shape == (512, 7)


def test_bucket_shape_and_tile_grid():
    assert bucket_shape(1) == (1, port_se.MIN_BUCKET)
    assert bucket_shape(257) == (1, 512)
    assert bucket_shape(port_se.CHUNK + 1) == (2, port_se.CHUNK)
    assert bucket_shape(65_536) == (16, port_se.CHUNK)
    assert bucket_shape(100_000) == (32, port_se.CHUNK)
    g = tile_grid(scenario_grid(), 1000)
    assert all(len(v) == 1000 for v in g.values())
    assert np.array_equal(g["traffic_mult"][256:512],
                          scenario_grid()["traffic_mult"])


def test_grid_validation_and_soft_tau(parts):
    _, (agg, cfg, _), _ = parts
    eng = SweepEngine(agg, cfg, device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        eng.run({"trafic_mult": np.ones(4)})
    with pytest.raises(ValueError, match="empty"):
        eng.run({})
    with pytest.raises(NotImplementedError, match="Queue A item 5"):
        eng.run(scenario_grid(), soft_tau=0.1)


def test_wrappers_and_metering(parts):
    _, (agg, cfg, graph), fs = parts
    grid = scenario_grid(evict_fraction=(1.0, 0.5))
    direct = SweepEngine(agg, cfg, graph=graph, seed=2, device="cpu").run(grid)
    via = fused_sweep(fs, grid, seed=2, device="cpu")
    assert set(via) == set(direct)
    for k in direct:
        assert np.array_equal(via[k], direct[k], equal_nan=True), k
    orch = Orchestrator(fs, RegionCapacity.for_fleet("r", fs))
    res = orch.sweep_engine(device="cpu").run(scenario_grid())
    assert len(res["t_sla_ok"]) == 256
    obs.enable()
    try:
        runs0 = obs.value("ufa_sweep_runs_total")
        n0 = obs.value("ufa_sweep_scenarios_total")
        SweepEngine(agg, cfg, device="cpu").run(tile_grid(grid, 300))
        assert obs.value("ufa_sweep_runs_total") == runs0 + 1
        assert obs.value("ufa_sweep_scenarios_total") == n0 + 300
        assert obs.value("ufa_sweep_padding_waste_ratio") == (512 - 300) / 512
        assert obs.value("ufa_sweep_scenarios_per_s") > 0
    finally:
        obs.disable()
