"""The port's own spans and counters on the model path
(``repro_torch.obs.trace``): off by default and free of torch at import,
on under a ``torch.profiler`` or an attached ``Tracer``, nested as the
model's blocks are, exact counts of a hand-made routing, and the
``Tracer``'s host track on the profiler's clock."""

import dataclasses
import json
import os
import subprocess
import sys
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import models, obs
from repro_torch.configs import mamba2_780m, phi3_5_moe_42b_a6_6b
from repro_torch.models import layers as L
from repro_torch.obs import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = {"phi3.5-moe": phi3_5_moe_42b_a6_6b.REDUCED,
        "mamba2": mamba2_780m.REDUCED}
BLOCK = {"phi3.5-moe": ("moe", ["moe.route", "moe.positions", "moe.dispatch",
                                "moe.count", "moe.experts", "moe.combine"]),
         "mamba2": ("ssm", ["ssm.in_proj", "ssm.conv", "ssm.gates",
                            "ssm.scan", "ssm.out"])}


@pytest.fixture(autouse=True)
def clean():
    prev = obs.set_tracer(None)
    trace.reset_counters()
    yield
    obs.set_tracer(prev)
    trace.reset_counters()


def _model(name):
    torch.manual_seed(0)
    cfg = CFGS[name]
    params = models.init_params(cfg, 0, device="cpu")
    ids = torch.randint(0, cfg.vocab_size, (2, 16))
    return cfg, params, ids


@torch.no_grad()
def _step(cfg, params, ids):
    h, _ = models.forward(params, cfg, ids)
    return models.logits_fn(params, cfg, h[:, -1])


def _ranges(prof):
    """The program's ranges in a profiler's export, sorted by start."""
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                        f"ufa-spans-{os.getpid()}.json")
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            d = json.load(f)
    finally:
        os.remove(path)
    rs = [e for e in d["traceEvents"] if e.get("cat") == "user_annotation"
          and e["name"].startswith(trace.SPAN_PREFIX)]
    return sorted(rs, key=lambda e: (e["ts"], -e["dur"])), d


@pytest.mark.parametrize("name", sorted(CFGS))
def test_off_counts_nothing_and_spans_are_the_shared_null(name):
    cfg, params, ids = _model(name)
    assert not trace.tracing()
    _step(cfg, params, ids)
    assert trace.counters() == {}
    assert trace.span("model.forward", call=3) is trace.span("x")
    assert trace.span("x") is trace._NULL_SPAN
    trace.add("moe.rows_filled", 5)
    assert trace.counters() == {}


@pytest.mark.parametrize("name", sorted(CFGS))
def test_on_under_the_profiler_nested_as_the_blocks(name):
    cfg, params, ids = _model(name)
    want = _step(cfg, params, ids)
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    assert trace.tracing()
    got = _step(cfg, params, ids)
    prof.stop()
    assert not trace.tracing()
    assert torch.equal(got, want)            # tracing changes no number
    rs, _ = _ranges(prof)
    n = Counter(e["name"][len(trace.SPAN_PREFIX):] for e in rs)
    block, parts = BLOCK[name]
    L_ = cfg.n_layers
    assert n["model.forward"] == n["model.embed"] == n["model.head"] == 1
    assert n["model.final_norm"] == 1
    assert n["model.layer"] == n[block] == L_
    assert all(n[p] == L_ for p in parts), n

    def inside(inner, outer):
        return [o for o in outer if o["ts"] <= inner["ts"]
                and inner["ts"] + inner["dur"] <= o["ts"] + o["dur"]]

    by = {k: [e for e in rs if e["name"] == trace.SPAN_PREFIX + k]
          for k in n}
    for lay in by["model.layer"]:
        assert inside(lay, by["model.forward"])
    for b in by[block]:
        assert len(inside(b, by["model.layer"])) == 1
    for p in parts:
        for e in by[p]:
            assert len(inside(e, by[block])) == 1
    # the host time of a block holds its phases'
    dur = {k: sum(e["dur"] for e in v) for k, v in by.items()}
    assert dur[block] >= sum(dur[p] for p in parts)
    assert dur["model.forward"] >= dur["model.layer"] >= dur[block]


def _hand_routing(T, E, firsts, seconds):
    """x and a router whose top-2 of token t are firsts[t], seconds[t]."""
    x = torch.zeros((T, E))
    x[torch.arange(T), torch.tensor(firsts)] = 2.0
    x[torch.arange(T), torch.tensor(seconds)] = 1.0
    return x, 8.0 * torch.eye(E)


def _expected(firsts, seconds, capacity, start, n_local):
    """Placed and dropped slots of a local expert, in the slot-major
    order the queues fill in."""
    fill, placed, dropped = Counter(), 0, 0
    for e in list(firsts) + list(seconds):
        if not start <= e < start + n_local:
            continue
        if fill[e] < capacity:
            placed += 1
        else:
            dropped += 1
        fill[e] += 1
    return placed, dropped


@pytest.mark.parametrize("start,n_local", [(0, 4), (1, 2)])
def test_counters_exact_on_a_hand_made_routing(start, n_local):
    T, E, F, capacity = 6, 4, 8, 3
    firsts = [0, 0, 0, 0, 1, 2]
    seconds = [1, 1, 3, 2, 0, 1]        # expert 0: four slots, 1: four
    x, router = _hand_routing(T, E, firsts, seconds)
    g = torch.Generator().manual_seed(1)
    params = {"router": router,
              "w_gate": torch.randn((n_local, E, F), generator=g),
              "w_up": torch.randn((n_local, E, F), generator=g),
              "w_down": torch.randn((n_local, F, E), generator=g)}
    kw = dict(top_k=2, capacity=capacity, n_experts=E, expert_start=start,
              n_local_experts=n_local)
    y_off, _ = L.moe_apply_local(params, x, **kw)
    obs.set_tracer(obs.Tracer())
    y_on, _ = L.moe_apply_local(params, x, **kw)
    assert torch.equal(y_on, y_off)
    placed, dropped = _expected(firsts, seconds, capacity, start, n_local)
    assert dropped > 0
    assert trace.counters() == {"moe.slots_routed": T * 2,
                                "moe.slots_dropped": dropped,
                                "moe.rows_computed": n_local * capacity,
                                "moe.rows_filled": placed}
    L.moe_apply_local(params, x, **kw)          # totals add up
    assert trace.counters()["moe.rows_filled"] == 2 * placed
    trace.reset_counters()
    assert trace.counters() == {}


def test_tracer_host_track_on_the_profilers_clock():
    cfg, params, ids = _model("phi3.5-moe")
    _step(cfg, params, ids)
    tracer = obs.Tracer()
    obs.set_tracer(tracer)
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    _step(cfg, params, ids)
    prof.stop()
    obs.set_tracer(None)
    rs, pd = _ranges(prof)
    td = tracer.to_chrome()
    assert obs.validate_chrome_trace(td) == []
    mine = [e for e in td["traceEvents"] if e["ph"] == "X"]
    assert Counter(e["name"] for e in mine) == Counter(e["name"] for e in rs)
    # the n-th span of a name against the n-th range of that name
    shift = (td["baseTimeNanoseconds"] - pd["baseTimeNanoseconds"]) / 1e3
    for name in {e["name"] for e in rs}:
        ms = sorted(e["ts"] for e in mine if e["name"] == name)
        ps = sorted(e["ts"] for e in rs if e["name"] == name)
        for m, r in zip(ms, ps):
            assert abs(m + shift - r) < 1e3, (name, m + shift, r)  # 1 ms
    # ids, parents and the attrs a child carries
    by_id = {e["args"]["id"]: e for e in mine}
    fwd = next(e for e in mine if e["name"] == "ufa:model.forward")
    assert fwd["args"]["parent"] is None
    layers = [e for e in mine if e["name"] == "ufa:model.layer"]
    assert [e["args"]["layer"] for e in layers] == list(range(cfg.n_layers))
    for e in mine:
        if e is fwd or e["name"] == "ufa:model.head":
            continue
        assert e["args"]["call"] == fwd["args"]["call"]
        parent = by_id[e["args"]["parent"]]
        assert parent["ts"] <= e["ts"]
        if e["name"].startswith("ufa:moe"):
            assert e["args"]["layer"] in range(cfg.n_layers)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_a_recomputed_layer_counts_once(remat):
    """Training with a checkpointed layer runs its forward again in the
    backward pass: the spans show both runs, the counters the first."""
    cfg, params, ids = _model("phi3.5-moe")
    obs.set_tracer(obs.Tracer())
    _step(cfg, params, ids)
    want = trace.counters()
    trace.reset_counters()
    tracer = obs.Tracer()
    obs.set_tracer(tracer)
    cfg = dataclasses.replace(cfg, remat=remat)
    leaves = [t for t in _tensors(params) if t.is_floating_point()]
    for t in leaves:
        t.requires_grad_(True)
    h, aux = models.forward(params, cfg, ids)
    (h.float().square().mean() + aux).backward()
    assert trace.counters() == want
    moe = [e for e in tracer.to_chrome()["traceEvents"]
           if e.get("name") == "ufa:moe"]
    assert len(moe) == 2 * cfg.n_layers


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def test_tracer_durations_hold_through_a_wall_clock_step(monkeypatch):
    tracer = obs.Tracer()
    base = tracer.base_ns
    monkeypatch.setattr(trace.time, "time_ns", lambda: base - 10 ** 12)
    with tracer.span("phase"):
        pass
    monkeypatch.undo()
    (bar,) = [e for e in tracer.to_chrome()["traceEvents"] if e["ph"] == "X"]
    assert 0 <= bar["ts"] < 1e6 and 0 <= bar["dur"] < 1e6
    assert tracer.to_chrome()["baseTimeNanoseconds"] == base


def test_counters_sum_device_tensors_and_read_integers():
    obs.set_tracer(obs.Tracer())
    trace.add("a", torch.tensor(3))
    trace.add("a", torch.tensor(4))
    trace.add("b", 2)
    trace.add("c", torch.tensor(0.5))
    assert trace.counters() == {"a": 7, "b": 2, "c": 0.5}
    assert isinstance(trace.counters()["a"], int)


def test_import_of_obs_pulls_in_no_torch():
    code = ("import sys; import repro_torch.obs as o; "
            "assert not o.tracing(); "
            "assert o.span('x') is o.span('y'); "
            "assert 'torch' not in sys.modules, 'torch'; print('OK')")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ,
                                  PYTHONPATH=os.path.join(ROOT, "src")),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr
