"""Adversarial chaos campaign: hunt the SLA-violating frontier, on the
port (``examples/chaos_campaign.py`` of the reference).

Synthesizes and hardens a Tables-1-3 fleet (B2), then runs a chaos
campaign (``repro_torch.chaos``): bandit-allocated bisection along
fault-severity rays, every probe round one batched call into the fused
sweep engine (B1, B2).  Prints the frontier report, replays every probe
bit-exactly on an independent engine, and finishes with a correlated
Monte-Carlo fault sample scored in a single sweep.  The sample is drawn
by a ``torch.Generator`` on the device, so its lines (the violation
count and the mildest violating draw) differ from the reference's, which
draws with ``jax.random``, and between the card and the CPU.

  PYTHONPATH=src python -m repro_torch.examples.chaos_campaign
  # coarser/faster: localize to 1/32 with at most 8 bisection rounds
  PYTHONPATH=src python -m repro_torch.examples.chaos_campaign --tol 32 \\
      --max-rounds 8
  # with the observability plane on: Chrome trace + Prometheus snapshot
  PYTHONPATH=src python -m repro_torch.examples.chaos_campaign --trace \\
      --metrics-out
"""

import argparse
import time

from repro_torch.chaos import (FAULT_LIBRARY, campaign_for_fleet,
                               sample_faults, verify_report)
from repro_torch.core.service import synthesize_fleet
from repro_torch.examples.common import ObsPlane, add_device_arg
from repro_torch.graph import CallGraph, plan_hardening
from repro_torch.kernels.backend import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.05,
                    help="fleet synthesis scale (0.05 = paper bench fleet)")
    ap.add_argument("--seed", type=int, default=7,
                    help="ONE campaign seed: engine blackhole draws, "
                         "storm draws and fault sampling all derive "
                         "independent streams from it")
    ap.add_argument("--tol", type=float, default=64,
                    help="frontier resolution as 1/TOL severity units")
    ap.add_argument("--max-rounds", type=int, default=64,
                    help="bisection round cap")
    ap.add_argument("--round-budget", type=int, default=None,
                    help="max rays probed per round (bandit budget; "
                         "default probes every active ray)")
    ap.add_argument("--samples", type=int, default=512,
                    help="correlated Monte-Carlo faults scored at the end")
    ap.add_argument("--trace", nargs="?", const="chaos_trace.json",
                    default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON of the campaign "
                         "phases; open in https://ui.perfetto.dev")
    ap.add_argument("--metrics-out", nargs="?", const="metrics.prom",
                    default=None, metavar="PATH",
                    help="enable the metrics registry and write a "
                         "Prometheus snapshot (+ JSONL next to it)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    plane = ObsPlane(args.trace, args.metrics_out)

    fs = synthesize_fleet(scale=args.scale, seed=7, as_arrays=True)
    fs.apply_ufa_target_classes()
    graph = CallGraph.from_fleet_state(fs)
    with plane.phase("plan-hardening"):
        plan = plan_hardening(graph, device=dev)
    fs.edges.fail_open[graph.input_edge_indices(plan.hardened_edges)] = True
    print(f"fleet: {fs.n} service-environments, hardened "
          f"{plan.n_hardened} edges (certified={plan.certified})")

    tol = 1.0 / args.tol
    t0 = time.time()
    camp = campaign_for_fleet(fs, seed=args.seed, tol=tol,
                              max_rounds=args.max_rounds,
                              round_budget=args.round_budget,
                              profiler=plane.prof, device=dev)
    report = camp.run()
    dt = time.time() - t0
    print(f"\ncampaign: {report.n_evals} engine evals in {dt:.1f}s "
          f"({report.n_rounds} bisection rounds)\n")
    print(report.render())

    print("\n== frontier in knob coordinates ==")
    for r in report.rays:
        knobs = r.frontier_knobs()
        if knobs is None:
            continue
        active = {_knob_of(f): round(knobs[_knob_of(f)], 4)
                  for f in sorted(r.direction)}
        print(f"  {r.name:22s} severity {r.frontier_severity:.4f} -> "
              f"{active}")

    # bit-exact audit: replay every probe on an independent engine
    with plane.phase("chaos-verify"):
        fresh = campaign_for_fleet(fs, seed=args.seed, tol=tol, device=dev)
        audit = verify_report(report, fresh.engine)
    print(f"\nre-verification: {audit['n_probes']} probes replayed on an "
          f"independent engine, bit-identical")

    # correlated Monte-Carlo: joint fault draws (Gaussian copula — the
    # compound incidents the paper worries about), scored in ONE sweep
    with plane.phase("chaos-sample"):
        sample = sample_faults(args.seed, args.samples, device=dev)
        ok, _ = camp.oracle(sample["grid"])
    sev = sample["severity"]
    fail = ~ok
    print(f"\n== correlated Monte-Carlo ({args.samples} joint faults) ==")
    print(f"  SLA violations: {int(fail.sum())}/{args.samples} "
          f"({fail.mean():.1%})")
    if fail.any():
        mild = sev[fail].sum(axis=1).argmin()
        print("  mildest violating draw (severity per family):")
        for j, name in enumerate(sample["families"]):
            if sev[fail][mild, j] > 0.05:
                print(f"    {name:22s} {sev[fail][mild, j]:.3f}")

    plane.finish({"example": "chaos_campaign", "seed": args.seed})


def _knob_of(family: str) -> str:
    return FAULT_LIBRARY[family].knob


if __name__ == "__main__":
    main()
