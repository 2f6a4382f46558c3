"""Capacity optimization walkthrough, on the port
(``examples/optimize_capacity.py`` of the reference): replace the
paper's hand-tuned provisioning knobs with a differentiable search over
the fused sweep engine.

Starts from the legacy 2x-buffer design, anneals autograd through the
soft-relaxed pipeline, polishes with a CEM loop over the bit-exact hard
objective (B1), hard-verifies the optimum through a real ``SweepEngine``
on the 48-scenario certification ensemble, then feeds the availability
gradient at the optimum back into the hardening planner (B2) as
blast-radius weights.

  PYTHONPATH=src python -m repro_torch.examples.optimize_capacity
  PYTHONPATH=src python -m repro_torch.examples.optimize_capacity --smoke
"""

import argparse

import numpy as np

from repro_torch.core.service import synthesize_fleet
from repro_torch.examples.common import add_device_arg
from repro_torch.graph import CallGraph, plan_hardening
from repro_torch.kernels.backend import resolve_device
from repro_torch.optim import hardening_weights, optimize_capacity


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="small fleet + tiny budgets (CI gate)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    smoke = args.smoke
    scale = 0.02 if smoke else 0.05
    fs = synthesize_fleet(scale=scale, seed=7, as_arrays=True)
    fs.apply_ufa_target_classes()
    graph = CallGraph.from_fleet_state(fs)
    plan = plan_hardening(graph, device=dev)
    fs.edges.fail_open[graph.input_edge_indices(plan.hardened_edges)] = True
    print(f"fleet: {fs.n} services at scale {scale}, "
          f"{len(plan.hardened_edges)} edges hardened fail-open")

    kw = (dict(grad_steps=20, taus=(1.0, 0.1, 0.03), cem_generations=4,
               cem_population=24) if smoke else {})
    res = optimize_capacity(fs, mode="both", device=dev, **kw)
    v = res.verification
    print(f"\nprovisioning multiple: {res.start_multiple:.3f}x (legacy "
          f"start) -> {res.provisioning_multiple:.3f}x (optimized)")
    print(f"knob optimum: buffer={res.design['buffer'] - 1:.3f}, "
          f"overcommit={res.design['overcommit']:.3f}x, "
          f"ramp={res.design['spawn_mult']:.3f}, "
          f"evict_lambda={res.design['evict_lambda']:+.3f}")
    print(f"hard verification ({v['n_scenarios']} scenarios): "
          f"sla_ok {v['n_sla_ok']}, t_sla_ok {v['n_t_sla_ok']}, "
          f"t_avail_ok {v['n_t_avail_ok']}, "
          f"min availability {v['availability_min']:.6f} "
          f"-> all_ok={v['all_ok']}")
    assert res.improved and v["all_ok"]
    if smoke:
        # CI gate: one grad step + a few CEM generations must already
        # beat the legacy start point and hard-certify
        assert res.provisioning_multiple <= 1.4, res.provisioning_multiple

    w = hardening_weights(fs, graph, knobs=res.knobs, device=dev)
    top = np.argsort(w)[::-1][:5]
    print("\nblast-radius-weighted hardening (availability gradient at "
          "the optimum):")
    for i in top:
        print(f"  {w[i]:8.3f}  {graph.names[i]}")
    wplan = plan_hardening(graph, service_weights=w, device=dev)
    print(f"weighted plan: {len(wplan.hardened_edges)} edges, "
          f"certified={wplan.certified}")
    assert wplan.certified


if __name__ == "__main__":
    main()
