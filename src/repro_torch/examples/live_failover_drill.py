"""Live-workload failover drill: the UFA control plane driving real
serving, on the port (``examples/live_failover_drill.py`` of the
reference).

The timeline simulation (B1) plays a full-peak regional failover for a
paper-shaped fleet; ``serving.FailoverBridge`` replays its per-tier
capacity traces as replica actuation on a pool of serving engines (a
2-layer model, head dim 16: B4 and B5 every decode step) behind the
hardened ``TieredScheduler``; an open-loop Poisson workload flows through
the same window.  Every request gets a user-visible verdict, and the
report is measured request SLOs fed through the ``obs`` burn-rate
monitors, per §4.2.  The full run then hunts the request-level SLA
frontier with a chaos campaign over the request-plane fault families and
replays it bit-exactly through a fresh oracle.

  PYTHONPATH=src python -m repro_torch.examples.live_failover_drill
  PYTHONPATH=src python -m repro_torch.examples.live_failover_drill --smoke
"""

import argparse
import time

from repro_torch import obs
from repro_torch.chaos import verify_report
from repro_torch.core.tiers import RTO_SECONDS, FailureClass
from repro_torch.examples.common import add_device_arg
from repro_torch.kernels.backend import resolve_device
from repro_torch.serving import (DrillSpec, drill_oracle, request_campaign,
                                 run_drill)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="drill + SLA asserts only (CI-sized)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    obs.enable()
    spec = DrillSpec()
    rto = RTO_SECONDS[FailureClass.RESTORE_LATER]

    t0 = time.time()
    rep = run_drill(spec, device=dev)
    print(rep.render())
    print(f"drill wall time {time.time() - t0:.1f}s "
          f"(includes jit compiles on the first run)")
    print("replica actuation:", " -> ".join(
        f"t={t:.0f}s {tier.name}x{tgt}" for t, tier, tgt in
        rep.actuation_log))

    crit, pre = rep.crit, rep.pre
    # user-visible differentiated SLAs, asserted from the measured report
    assert rep.sla_ok, "drill SLA verdict failed"
    assert crit.availability >= spec.avail_slo, crit.availability
    assert not crit.slo_alert, "burn-rate alert on the critical tier"
    assert crit.p99_s <= spec.crit_p99_slo_s, crit.p99_s
    assert pre.time_to_restore_s <= rto, pre.time_to_restore_s
    assert pre.slo_alert, "blackout must be user-visible on the pre tier"
    # ... and cross-checked against the obs metrics plane
    assert obs.value("ufa_serving_requests_total", tier=crit.tier,
                     outcome="served") == crit.served
    print(f"PASS  critical {crit.tier}: availability "
          f"{crit.availability:.4f} >= {spec.avail_slo} with no alert; "
          f"preemptible {pre.tier}: restored in "
          f"{pre.time_to_restore_s:.0f}s <= RTO {rto:.0f}s "
          f"(alert fired at t={pre.t_first_alert_s:.0f}s)")
    if args.smoke:
        return

    # ---- chaos: hunt the request-level SLA frontier ---------------------
    print("\nchaos campaign over the request-plane fault families:")
    t0 = time.time()
    camp = request_campaign(spec, tol=1.0 / 8.0, max_rounds=5, device=dev)
    crep = camp.run()
    print(crep.render())
    print(f"campaign wall time {time.time() - t0:.1f}s")
    assert crep.op_ok and crep.n_localized >= 1
    out = verify_report(crep, oracle=drill_oracle(spec, device=dev))
    print(f"replayed {out['n_probes']} probes bit-exactly: "
          f"{len(out['mismatches'])} mismatches")


if __name__ == "__main__":
    main()
