"""The port's certification, blast radius, ensembles and hardening
planner on the CPU, against the reference's ``repro.graph`` on the same
graph: the reference's ``fleet_graph`` (``scale=0.05, seed=7,
unsafe_chain_fraction=0.06``, relay chains included) carried over with
``repro_torch.convert``.

Grades: ``broken``, ``rounds``, unweighted radius counts, the
certification's fields, the plan's edges, trajectory and rounds, and the
gate's result are exact.  Weighted radius sums are float32 sums in
another order (rtol 1e-6); the weighted planner is held exact on
integer-valued weights, whose float32 sums are exact below 2^24."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.fleet_state import synthesize_fleet_state  # noqa: E402
from repro.graph import CallGraph as RefGraph  # noqa: E402
from repro.graph import planner as ref_planner  # noqa: E402
from repro.graph import propagation as ref_prop  # noqa: E402
from repro_torch.convert import from_reference_arrays  # noqa: E402
from repro_torch.graph import planner as port_planner  # noqa: E402
from repro_torch.graph import propagation as port_prop  # noqa: E402

CPU = "cpu"


def _convert(ref_graph):
    fields = {f.name: getattr(ref_graph, f.name)
              for f in dataclasses.fields(ref_graph)}
    return from_reference_arrays(graph=fields)["graph"]


@pytest.fixture(scope="module")
def graphs():
    fs = synthesize_fleet_state(scale=0.05, seed=7,
                                unsafe_chain_fraction=0.06)
    ref = RefGraph.from_fleet_state(fs)
    return ref, _convert(ref)


# ---------------------------------------------------------------------------
# propagation entry points
# ---------------------------------------------------------------------------


def test_propagate_many_and_propagate_exact(graphs):
    ref, port = graphs
    dark = np.random.default_rng(5).random((8, ref.n)) < 0.2
    want, want_rounds = ref_prop.propagate_many(ref, dark)
    got, rounds = port_prop.propagate_many(port, dark, device=CPU)
    assert got.dtype == bool and np.array_equal(got, np.asarray(want))
    assert rounds == int(want_rounds)
    assert np.array_equal(port_prop.propagate(port, dark[0], device=CPU),
                          ref_prop.propagate(ref, dark[0]))
    with pytest.raises(ValueError):
        port_prop.propagate_many(port, dark[:, :-1], device=CPU)


@pytest.mark.parametrize("dark", ["preemptible", "random"])
def test_certify_exact(graphs, dark):
    ref, port = graphs
    d = None if dark == "preemptible" else \
        np.random.default_rng(1).random(ref.n) < 0.3
    want = ref_prop.certify(ref, d)
    got = port_prop.certify(port, d, device=CPU)
    assert got.ok == want.ok
    for k in ("n_broken_critical", "n_critical", "n_dark", "rounds"):
        assert getattr(got, k) == getattr(want, k), k
    for k in ("broken", "broken_critical", "multi_hop"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    if d is None:
        assert not got.ok and got.rounds > 2    # relay chains: multi-hop


def test_blast_radius_exact(graphs):
    ref, port = graphs
    assert np.array_equal(port_prop.blast_radius(port, device=CPU),
                          ref_prop.blast_radius(ref))
    # more than one _CHUNK of sources, and a ragged last batch
    sources = np.arange(0, ref.n, 1)[:700]
    got = port_prop.blast_radius(port, sources=sources, device=CPU)
    assert got.dtype == np.int32
    assert np.array_equal(got, ref_prop.blast_radius(ref, sources=sources))
    assert not port_prop.blast_radius(port, sources=[], device=CPU).any()


def test_blackhole_ensemble_exact(graphs):
    ref, port = graphs
    for kw in ({"fractions": np.linspace(0, 1, 16)},
               {"n_scenarios": 24, "seed": 3},
               {"n_scenarios": 9, "kind": "grid"}):
        want = ref_prop.blackhole_ensemble(ref, **kw)
        got = port_prop.blackhole_ensemble(port, device=CPU, **kw)
        assert set(got) == set(want)
        for k, v in want.items():
            assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
            assert np.array_equal(got[k], v), k


def test_radius_counts_exact_and_weighted(graphs):
    ref, port = graphs
    sources = np.flatnonzero(ref.preemptible)[:300]
    ref_consts = ref_prop.edge_consts(ref)
    consts = port_prop.edge_consts(port, CPU)
    crit = torch.from_numpy(port.critical.copy())
    want = ref_prop.radius_counts(sources, ref.n, ref_consts,
                                  jnp.asarray(ref.critical))
    got = port_prop.radius_counts(sources, port.n, consts, crit)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    w = (np.random.default_rng(2).random(ref.n) * ref.critical).astype(
        np.float32)
    want_w = ref_prop.radius_counts(sources, ref.n, ref_consts,
                                    jnp.asarray(ref.critical),
                                    weights=jnp.asarray(w))
    got_w = port_prop.radius_counts(sources, port.n, consts, crit,
                                    weights=torch.from_numpy(w))
    assert got_w.dtype == np.float32
    np.testing.assert_allclose(got_w, want_w, rtol=1e-6)


def test_harden_consts_in_place_equals_rebuilt(graphs):
    _, port = graphs
    consts = port_prop.edge_consts(port, CPU)
    closed_idx = np.flatnonzero(~port.fail_open)
    pick = closed_idx[::3]
    out = port_prop.harden_consts(consts, pick)
    assert out is consts                      # flipped in place
    want = port_prop.edge_consts(port.harden(pick), CPU)
    for k in ("ell_dst", "ell_closed", "src", "ell_slot"):
        assert torch.equal(consts[k], want[k]), k


# ---------------------------------------------------------------------------
# the planner and the gate
# ---------------------------------------------------------------------------


def _same_plan(got, want):
    assert got.hardened_edges == want.hardened_edges
    assert got.hardened_edge_names == want.hardened_edge_names
    assert got.trajectory == want.trajectory
    assert got.rounds == want.rounds
    assert got.certified == want.certified
    assert np.array_equal(got.graph.fail_open, want.graph.fail_open)


@pytest.mark.parametrize("weighted", [False, True])
def test_plan_hardening_identical(graphs, weighted):
    ref, port = graphs
    weights = None
    if weighted:
        # integer-valued weights: float32 sums exact in any order
        weights = (np.random.default_rng(4).integers(1, 6, ref.n)
                   * ref.critical).astype(np.float32)
    want = ref_planner.plan_hardening(ref, batch=16,
                                      service_weights=weights)
    got = port_planner.plan_hardening(port, batch=16,
                                      service_weights=weights, device=CPU)
    assert want.certified and want.rounds >= 1 and want.n_hardened > 0
    _same_plan(got, want)
    assert port_prop.certify(got.graph, device=CPU).ok


def test_plan_hardening_max_rounds_and_stall(graphs, monkeypatch):
    ref, port = graphs
    want = ref_planner.plan_hardening(ref, batch=1, max_rounds=2)
    got = port_planner.plan_hardening(port, batch=1, max_rounds=2,
                                      device=CPU)
    _same_plan(got, want)
    assert got.rounds == 2 and not got.certified
    # an all-broken verdict on a graph with no fail-close edge left: no
    # frontier can relay it, and both planners refuse to loop on
    open_graph = port.harden(np.flatnonzero(~port.fail_open))
    ref_open = ref.harden(np.flatnonzero(~ref.fail_open))
    monkeypatch.setattr(port_planner, "fixed_point",
                        lambda dark, consts: (torch.ones_like(dark), 1))
    monkeypatch.setattr(ref_planner, "fixed_point",
                        lambda dark, consts: (jnp.ones_like(dark), 1))
    with pytest.raises(RuntimeError, match="stalled"):
        ref_planner.plan_hardening(ref_open)
    with pytest.raises(RuntimeError, match="stalled"):
        port_planner.plan_hardening(open_graph, device=CPU)


def test_regression_gate_identical(graphs):
    ref, port = graphs
    ref_h = ref_planner.plan_hardening(ref).graph
    port_h = port_planner.plan_hardening(port, device=CPU).graph
    assert np.array_equal(ref_h.fail_open, port_h.fail_open)
    crit = int(np.flatnonzero(ref_h.critical)[0])
    pre = int(np.flatnonzero(ref_h.preemptible)[0])
    pre2 = int(np.flatnonzero(ref_h.preemptible)[1])
    names = ref_h.names
    cases = [(None, None), (names[crit], names[pre]),
             (names[pre], names[pre2])]
    for caller, callee in cases:
        if caller is None:
            rb, pb = ref_h, port_h
        else:
            rb = ref_h.with_edge(caller, callee, fail_open=False)
            pb = port_h.with_edge(caller, callee, fail_open=False)
        want = ref_planner.regression_gate(ref_h, rb)
        got = port_planner.regression_gate(port_h, pb, device=CPU)
        assert (got.ok, got.new_unsafe_edges, got.violations) == \
            (want.ok, want.new_unsafe_edges, want.violations)
    assert not port_planner.regression_gate(
        port_h, port_h.with_edge(names[crit], names[pre]), device=CPU).ok


def test_graph_entry_points_raise_without_cuda(graphs, monkeypatch):
    _, port = graphs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dark = port.preemptible
    calls = [
        lambda: port_planner.plan_hardening(port),
        lambda: port_planner.regression_gate(port, port.with_edge(
            port.names[0], port.names[1])),
        lambda: port_prop.certify(port),
        lambda: port_prop.blast_radius(port),
        lambda: port_prop.blackhole_ensemble(port, n_scenarios=4),
        lambda: port_prop.propagate_many(port, dark[None, :]),
        lambda: port_prop.propagate(port, dark),
        lambda: port_prop.edge_consts(port),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


@pytest.mark.parametrize("scale,seed", [(0.02, 7), (0.02, 1), (0.02, 3),
                                        (0.05, 7), (0.05, 2), (0.05, 3)])
def test_plan_hardening_float_weights_from_hardening_weights(scale, seed):
    """The float-weight trap (ROADMAP, Known traps): the reference's
    ``hardening_weights`` output, float32 weights that are not integers,
    gives both planners the same edge sequence (float32 sums of the
    weighted blast radius are taken in another order in the port)."""
    from repro.core.service import synthesize_fleet as ref_synth
    from repro.optim.capacity import hardening_weights
    from repro_torch.core.service import synthesize_fleet
    from repro_torch.graph import CallGraph

    fs = ref_synth(scale=scale, seed=seed, as_arrays=True)
    fs.apply_ufa_target_classes()
    ref = RefGraph.from_fleet_state(fs)
    w = hardening_weights(fs, ref)
    assert w.dtype == np.float32 and not np.array_equal(w, np.round(w))
    pfs = synthesize_fleet(scale=scale, seed=seed, as_arrays=True)
    pfs.apply_ufa_target_classes()
    port = CallGraph.from_fleet_state(pfs)
    want = ref_planner.plan_hardening(ref, service_weights=w)
    got = port_planner.plan_hardening(port, service_weights=w, device=CPU)
    assert want.certified and want.n_hardened > 0
    _same_plan(got, want)
