"""One traced run of a cell, read through the program's own spans.

    python3 perfbench/spans.py --workload <cell> --seed <n> --seconds <s>

from the root of a checkout, on the CUDA card.  The run is ``run.py
--trace 1``'s (``core.run_cell``), and its result line comes last on
standard output as there.  Its trace is read with the program's
``ufa:`` ranges (``repro_torch.obs.trace.SPAN_PREFIX``) indexed beside
the benchmark's ``pb:`` ones, so every kernel is credited to each
program span open when it was launched and each idle gap to the
innermost range, the program's among them.  On standard error: device
and host milliseconds a step and calls a step of each program span,
the idle gaps by range, the program's counters, and the checks that
the program's phases add up to the layers the benchmark times.  The
result line is ``run.py``'s own: the program's ranges are indexed in a
second view of the same events, after the run.

A span's host milliseconds are its ranges' lengths in the profiler's
trace: they hold the profiler's own cost, and where the card's launch
queue is full the host waits inside whichever span launches next, so
they read the card's pace there rather than the host's.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent / "src"))
sys.path.insert(0, str(HERE))

# the program's phases that partition a layer the benchmark times
PARTS = {"moe": "repro_torch.models.layers.moe_apply_local",
         "ssm": "repro_torch.models.layers.ssm_apply"}


def program_events(events: list, span_prefix: str, prefix: str) -> list:
    """The profiler's events with the program's ranges renamed into the
    benchmark's prefix (``pb:ufa:moe``), so that ``TraceView`` indexes
    them as its own."""
    return [dict(e, name=prefix + e["name"])
            if e.get("cat") == "user_annotation"
            and str(e.get("name", "")).startswith(span_prefix) else e
            for e in events]


def host_ms(events: list, span_prefix: str, window) -> dict:
    """Host milliseconds (the ranges' lengths) and calls of each
    program range inside the traced steps' window."""
    ms, calls = defaultdict(float), defaultdict(int)
    lo, hi = window if window else (float("-inf"), float("inf"))
    for e in events:
        name = str(e.get("name", ""))
        if (e.get("cat") == "user_annotation" and name.startswith(span_prefix)
                and lo <= e["ts"] <= hi):
            ms[name] += e["dur"] / 1e3
            calls[name] += 1
    return {n: (ms[n], calls[n]) for n in ms}


def checks(view, metrics: dict, span_prefix: str) -> list:
    """(what, value, bound, holds) of the consistency checks: the
    program's phases of a layer against the benchmark's range around
    it (within 2%), and the phase metrics under the layer metrics that
    hold them."""
    out = []
    for block, path in PARTS.items():
        whole = view.span_device_s(path)
        if whole <= 0:
            continue
        parts = sum(s for n, s in view.device_s.items()
                    if n.startswith(f"{span_prefix}{block}.")
                    and "." not in n[len(span_prefix) + len(block) + 1:])
        out.append((f"{block}: its phases / the benchmark's range",
                    parts / whole, 0.02, abs(parts / whole - 1) <= 0.02))
    m = {k: v["value"] for k, v in metrics.items()}
    for parts, whole in ((("moe_positions_ms.prefill",
                           "moe_dispatch_ms.prefill"), "moe_route_ms.prefill"),
                         (("ssd_conv_ms.prefill", "ssd_gates_ms.prefill"),
                          "ssd_ms.prefill")):
        if all(k in m for k in parts + (whole,)):
            got = sum(m[k] for k in parts)
            out.append((" + ".join(parts) + " <= " + whole, got, m[whole],
                        got <= m[whole]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch
    from pbharness import core, trace
    from repro_torch.obs import trace as program

    if not torch.cuda.is_available():
        print("spans.py: needs a CUDA card", file=sys.stderr)
        return 2
    seen = []
    plain_view = trace.TraceView

    def keep(*a, **k):     # the run's own view, its arguments kept
        seen.append((a, k))
        return plain_view(*a, **k)

    trace.TraceView = keep
    try:
        result = core.run_cell(args.workload, args.seed, args.seconds, True,
                               "cuda", T0)
    finally:
        trace.TraceView = plain_view
    (events, *rest), kw = seen[0]
    v = plain_view(program_events(events, program.SPAN_PREFIX, trace.PREFIX),
                   *rest, **kw)
    host = host_ms(events, program.SPAN_PREFIX, v.trace_window)
    log = core.log
    log(f"program spans, a step of {v.steps}: device ms, host ms, calls")
    for name in sorted(set(host) | {n for n in v.device_s
                                    if n.startswith(program.SPAN_PREFIX)}):
        h, c = host.get(name, (0.0, 0))
        log(f"  {name:24s} {1e3 * v.device_s.get(name, 0.0) / v.steps:12.4f}"
            f" {h / v.steps:10.4f} {c / v.steps:8.1f}")
    log(f"idle gaps by the innermost range, s: "
        f"{v.breakdown()['idle_gaps']}")
    log(f"counters: {program.counters()}")
    for what, got, bound, holds in checks(v, result["metrics"],
                                          program.SPAN_PREFIX):
        log(f"check {what}: {got!r} against {bound!r}: "
            f"{'holds' if holds else 'FAILS'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
