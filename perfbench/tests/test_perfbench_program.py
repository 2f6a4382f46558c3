"""The readers of the program's own instrumentation (``pbharness/
program.py`` and the metric files that use it) and ``spans.py``'s view
of a trace with the program's ranges, on made-up traces and counters."""

import pytest

from pbharness import files, program, trace
from repro_torch import obs
from repro_torch.obs import trace as ptrace

import spans as spans_tool

NEW = ["moe_positions_ms.prefill", "moe_dispatch_ms.prefill",
       "moe_fill.prefill", "moe_drop_share.prefill", "ssd_conv_ms.prefill",
       "ssd_gates_ms.prefill"]
MOE = "repro_torch.models.layers.moe_apply_local"
B7 = "repro_torch.kernels.ops.grouped_matmul"
POS = "repro_torch.models.layers._expert_positions"
DISPATCH = "repro_torch.models.layers._moe_dispatch"


def rng(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "tid": tid}


def launch(corr, ts, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 1, "tid": tid, "args": {"correlation": corr}}


def kernel(corr, ts, dur, name="k"):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "tid": 7, "args": {"correlation": corr}}


def events(with_program=True):
    """Two steps: the benchmark's ranges around the MoE layer, B7 and the
    positions, the program's ranges inside them, kernels launched in
    each and gaps before some of them."""
    ev = []
    for s, t0 in enumerate((0, 1000)):
        c = 100 * s
        ev += [rng(trace.STEP, t0, 900), rng("pb:" + MOE, t0 + 10, 800),
               rng("pb:" + POS, t0 + 100, 100),
               rng("pb:" + DISPATCH, t0 + 300, 100),
               rng("pb:" + B7, t0 + 500, 200),
               launch(c + 1, t0 + 50), kernel(c + 1, t0 + 60, 30),
               launch(c + 2, t0 + 150), kernel(c + 2, t0 + 160, 40),
               launch(c + 3, t0 + 350), kernel(c + 3, t0 + 400, 50),
               launch(c + 4, t0 + 550), kernel(c + 4, t0 + 560, 100),
               launch(c + 5, t0 + 750), kernel(c + 5, t0 + 760, 20)]
        if with_program:
            ev += [rng("ufa:moe", t0 + 20, 780),
                   rng("ufa:moe.route", t0 + 30, 60),
                   rng("ufa:moe.positions", t0 + 90, 120),
                   rng("ufa:moe.dispatch", t0 + 290, 120),
                   rng("ufa:moe.experts", t0 + 490, 220),
                   rng("ufa:kernel.b7", t0 + 540, 20),
                   rng("ufa:moe.combine", t0 + 740, 40)]
    return ev


def view(ev, window_s=1.8):
    sp = trace.Spans([], trace.Patches())
    sp.calls.update({p: [{"args": [], "kwargs": {}}]
                     for p in (MOE, B7, POS, DISPATCH)})
    ctx = {"peaks": None, "count": None, "lm_config": None, "shapes": []}
    return trace.TraceView(ev, sp, 2, window_s, ctx)


def existing_metrics():
    return [m["name"] for m in files.manifest()["per_layer"]
            if m["name"] not in NEW]


def test_program_ranges_change_no_benchmark_reading():
    """busy, every range of the benchmark and every accepted metric read
    the same with the program's ranges in the trace, indexed or not."""
    bare = view(events(with_program=False))
    for v in (view(events()), view(spans_tool.program_events(
            events(), ptrace.SPAN_PREFIX, trace.PREFIX))):
        assert v.busy_s == bare.busy_s
        assert v.unattributed_s == bare.unattributed_s
        for path in (MOE, B7, POS, DISPATCH):
            assert v.span_device_s(path) == bare.span_device_s(path)
        for name in existing_metrics():
            read = files.load_module("metrics", name).read
            assert read(v) == read(bare), name


def test_program_spans_get_their_kernels_and_the_gaps():
    v = view(spans_tool.program_events(events(), ptrace.SPAN_PREFIX,
                                       trace.PREFIX))
    assert v.span_device_s("ufa:moe") == pytest.approx(2 * 240e-6)
    assert v.span_device_s("ufa:moe.route") == pytest.approx(2 * 30e-6)
    assert v.span_device_s("ufa:moe.experts") == pytest.approx(2 * 100e-6)
    assert v.span_device_s("ufa:kernel.b7") == pytest.approx(2 * 100e-6)
    gaps = dict(v.breakdown()["idle_gaps"])
    # each gap goes to the innermost range open at the launch that ends
    # it: the first of each step (and the 220 us between the steps) to
    # the program's route phase; those before the positions and dispatch
    # kernels to the benchmark's ranges opened inside the program's
    assert gaps == {"ufa:moe.route": pytest.approx(60e-6 + 280e-6),
                    POS: pytest.approx(2 * 70e-6),
                    DISPATCH: pytest.approx(2 * 200e-6),
                    "ufa:kernel.b7": pytest.approx(2 * 110e-6),
                    "ufa:moe.combine": pytest.approx(2 * 100e-6),
                    "after the last operation of a step":
                        pytest.approx(120e-6)}
    # the checks: the phases sum to the benchmark's MoE range
    got = spans_tool.checks(v, {}, ptrace.SPAN_PREFIX)
    assert got == [("moe: its phases / the benchmark's range",
                    pytest.approx(1.0), 0.02, True)]
    m = {"moe_positions_ms.prefill": {"value": 1.0},
         "moe_dispatch_ms.prefill": {"value": 2.0},
         "moe_route_ms.prefill": {"value": 2.5}}
    assert spans_tool.checks(v, m, ptrace.SPAN_PREFIX)[-1][-1] is False
    host = spans_tool.host_ms(events(), ptrace.SPAN_PREFIX, v.trace_window)
    assert host["ufa:moe.route"] == (pytest.approx(0.12), 2)


def test_phase_metrics_read_the_programs_functions():
    v = view(events())
    pos = files.load_module("metrics", "moe_positions_ms.prefill")
    disp = files.load_module("metrics", "moe_dispatch_ms.prefill")
    assert pos.read(v) == pytest.approx(1e3 * 40e-6)
    assert disp.read(v) == pytest.approx(1e3 * 50e-6)
    assert program.spans_ms(v, ["repro_torch.nothing.here"]) is None
    for name in ("ssd_conv_ms.prefill", "ssd_gates_ms.prefill"):
        assert files.load_module("metrics", name).read(v) is None


def test_a_phase_the_program_lost_is_said_and_read_as_nothing(
        capsys, monkeypatch):
    """A program with spans of its own that lacks a listed phase (renamed
    or fused) gets no part of the metric read: nothing, said on standard
    error.  An older program, with no spans of its own, gets the same
    nothing in silence."""
    lost = "repro_torch.models.layers.nope"
    assert program.present([DISPATCH, POS]) == [DISPATCH, POS]
    assert capsys.readouterr().err == ""
    assert program.present([DISPATCH, lost]) == []
    err = capsys.readouterr().err
    assert lost in err and DISPATCH in err
    monkeypatch.delattr(ptrace, "SPAN_PREFIX")
    assert program.present([DISPATCH, lost]) == []
    assert capsys.readouterr().err == ""


@pytest.fixture
def counted():
    prev = obs.set_tracer(obs.Tracer())
    ptrace.reset_counters()
    ptrace.add("moe.slots_routed", 16384)
    ptrace.add("moe.slots_dropped", 12)
    ptrace.add("moe.rows_computed", 20480)
    ptrace.add("moe.rows_filled", 16372)
    obs.set_tracer(prev)
    yield
    ptrace.reset_counters()


def test_counter_and_host_metrics(counted):
    """The counter metrics read their ratios.  The host's time a step has
    no metric: in a traced run it holds the profiler's cost, and where
    the card's launch queue is full it reads the card's pace."""
    assert not any(m["name"].startswith("host_ms")
                   for m in files.manifest()["per_layer"])
    v = view(events())
    fill = files.load_module("metrics", "moe_fill.prefill")
    drop = files.load_module("metrics", "moe_drop_share.prefill")
    assert fill.read(v) == pytest.approx(100 * 16372 / 20480)
    assert drop.read(v) == pytest.approx(100 * 12 / 16384)


@pytest.mark.parametrize("name", NEW)
def test_new_metrics_read_nothing_without_device_time(counted, name):
    v = view([e for e in events() if e.get("cat") != "kernel"])
    assert v.busy_s == 0
    assert files.load_module("metrics", name).read(v) is None
