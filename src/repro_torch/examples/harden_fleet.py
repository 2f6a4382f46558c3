"""Dependency-hardening campaign, end to end (paper §5-6), on the port
(``examples/harden_fleet.py`` of the reference).

Detect fail-close dependencies (runtime correlation, B3 on the card, plus
static analysis), build the call graph from the detections, propagate a
full blackhole through it (B2), plan hardening until the fleet certifies,
gate regressions, then certify the paper-scale fleet and run its
256-scenario blackhole ensemble and the dependency-closed scenario sweep.

  PYTHONPATH=src python -m repro_torch.examples.harden_fleet [--device cpu]
  # with host-phase tracing + a metrics snapshot:
  PYTHONPATH=src python -m repro_torch.examples.harden_fleet --trace \\
      --metrics-out
"""

import argparse
import time

import numpy as np

from repro_torch.core.dependency import runtime_analysis
from repro_torch.core.drills import remediate
from repro_torch.core.fleet_state import synthesize_fleet_state
from repro_torch.core.scenarios import (scenario_grid, summarize_sweep,
                                        sweep_with_dependency_ensemble)
from repro_torch.core.service import synthesize_fleet, unsafe_edges
from repro_torch.core.static_analysis import static_analysis
from repro_torch.examples.common import ObsPlane, add_device_arg
from repro_torch.graph import (CallGraph, blackhole_ensemble, certify,
                               plan_hardening, regression_gate)
from repro_torch.kernels.backend import resolve_device

SCALE = 0.15          # detection runs on the object fleet (IR + traces)
SEED = 7


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", nargs="?", const="harden_trace.json",
                    default=None, metavar="PATH",
                    help="write a Chrome trace of the pipeline's host "
                         "phases (open in https://ui.perfetto.dev)")
    ap.add_argument("--metrics-out", nargs="?", const="harden_metrics.prom",
                    default=None, metavar="PATH",
                    help="enable the metrics registry and write a "
                         "Prometheus snapshot (+ JSONL next to it)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    plane = ObsPlane(args.trace, args.metrics_out)

    # ---- detect ---------------------------------------------------------
    fleet = synthesize_fleet(scale=SCALE, seed=SEED, unsafe_fraction=0.10,
                             unsafe_chain_fraction=0.04)
    truth = set(unsafe_edges(fleet))
    print(f"fleet: {len(fleet)} services, {len(truth)} planted fail-close "
          f"edges (incl. critical->critical relay chains)")

    with plane.phase("runtime-detection"):
        ra = runtime_analysis(fleet, n_records=1_500_000, seed=SEED,
                              device=dev)
    with plane.phase("static-analysis"):
        sa = static_analysis(fleet, seed=SEED)
    detected = (ra["found"] | sa["found"])
    recall = len(detected & truth) / max(1, len(truth))
    print(f"detection: runtime={len(ra['found'])} static={len(sa['found'])} "
          f"combined_recall={recall:.2f} "
          f"(paper Table 6: 3041 runtime + 1114 static)")

    # ---- build graph from the detections + propagate --------------------
    graph = CallGraph.from_detections(fleet, detected & truth)
    cert0 = certify(graph, device=dev)
    print(f"\nblackhole certification (multi-hop): "
          f"{cert0.n_broken_critical}/{cert0.n_critical} critical services "
          f"break, {int(cert0.multi_hop.sum())} only through relay chains "
          f"({cert0.rounds} propagation rounds)")

    # ---- plan hardening -------------------------------------------------
    t0 = time.time()
    with plane.phase("plan-hardening"):
        plan = plan_hardening(graph, batch=12, device=dev)
    print(f"\nhardening planner: {plan.n_hardened} edges converted "
          f"fail-open over {plan.rounds} rounds ({time.time() - t0:.1f}s) "
          f"-> certified={plan.certified}")
    print(f"  paper: 4,000+ dependencies hardened fleet-wide; this fleet "
          f"is scale={SCALE}, i.e. ~{int(plan.n_hardened / SCALE):,} "
          f"full-scale-equivalent conversions")
    print("  trajectory (hardened -> broken criticals): "
          + " ".join(f"{t['n_hardened']}->{t['n_broken_critical']}"
                     for t in plan.trajectory))

    # ---- re-certify against the ground truth ----------------------------
    remediate(fleet, set(plan.hardened_edge_names))
    cert1 = certify(CallGraph.from_specs(fleet), device=dev)
    print(f"\nre-certification on the remediated fleet: "
          f"broken criticals {cert0.n_broken_critical} -> "
          f"{cert1.n_broken_critical} (ok={cert1.ok})")

    # ---- gate future regressions ----------------------------------------
    hardened = plan.graph
    crit = hardened.names[int(np.flatnonzero(hardened.critical)[0])]
    pre = hardened.names[int(np.flatnonzero(hardened.preemptible)[0])]
    gate = regression_gate(hardened, hardened.with_edge(crit, pre,
                                                        fail_open=False),
                           device=dev)
    print(f"regression gate on a planted {crit} -> {pre} fail-close edge: "
          f"ok={gate.ok} violations={gate.violations}")

    # ---- scenario ensemble with the dependency layer closed in ----------
    fs = synthesize_fleet_state(scale=1.0, seed=SEED,
                                unsafe_chain_fraction=0.05)
    g_paper = CallGraph.from_fleet_state(fs)
    t0 = time.time()
    with plane.phase("certify-paper-scale"):
        cert_paper = certify(g_paper, device=dev)
        ens = blackhole_ensemble(g_paper, n_scenarios=256, seed=SEED,
                                 device=dev)
    dt = time.time() - t0
    print(f"\npaper scale: {g_paper.n} SEs / {g_paper.n_edges} edges — "
          f"full certification + 256-scenario blackhole ensemble in "
          f"{dt:.2f}s ({cert_paper.n_broken_critical} broken criticals "
          f"un-hardened; ensemble ok-rate "
          f"{float(np.mean(ens['ok'])):.2f})")
    res = sweep_with_dependency_ensemble(
        fs, scenario_grid(evict_fraction=(1.0, 0.75, 0.5, 0.25)), seed=SEED,
        device=dev)
    s = summarize_sweep(res)
    print(f"scenario sweep with dependency verdicts: "
          f"{s['n_dep_ok']}/{s['n_scenarios']} scenarios dependency-clean, "
          f"worst broken-critical fraction {s['worst_dep_broken_frac']:.3f}")

    plane.finish({"example": "harden_fleet", "scale": SCALE})


if __name__ == "__main__":
    main()
