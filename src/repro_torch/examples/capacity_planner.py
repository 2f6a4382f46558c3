"""Capacity planning walkthrough: the §4.4 overcommit analysis, on the
port (``examples/capacity_planner.py`` of the reference).

Computes O_max from the paper's constants, runs the overcommit
simulator across a factor grid on the device, prints the violation
curve and the recommendation, then sizes a UFA region for a synthesized
fleet and compares provisioned cores against the legacy 2x model.

  PYTHONPATH=src python -m repro_torch.examples.capacity_planner \\
      [--device cpu]
"""

import argparse

from repro_torch.core.capacity import RegionCapacity
from repro_torch.core.overcommit_sim import (OvercommitSimConfig,
                                             recommend_factor)
from repro_torch.core.service import synthesize_fleet
from repro_torch.core.tiers import o_max
from repro_torch.examples.common import add_device_arg
from repro_torch.kernels.backend import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    dev = resolve_device(ap.parse_args(argv).device)
    print(f"O_max = (M_h/M_s)*(alpha_m/alpha_c) = {o_max():.3f}  "
          f"(paper: 1.66)")
    r = recommend_factor(OvercommitSimConfig(), device=dev)
    print("\nfactor  P(host > 75% busy)")
    for f, v in zip(r["factors"], r["violation_rates"]):
        bar = "#" * int(v * 400)
        marker = "  <= recommended" if abs(f - r["recommended"]) < 1e-9 else ""
        print(f"  {f:.2f}   {v:7.4f} {bar}{marker}")
    if not r["safe"]:
        print("\nWARNING: no factor on the grid met the violation budget "
              f"— {r['recommended']}x is the grid floor, NOT certified safe")
    print(f"\nsimulator recommendation: {r['recommended']}x "
          f"(safe={r['safe']}, paper: 1.5x), clamped by "
          f"O_max={r['o_max']:.2f}")

    fleet = synthesize_fleet(scale=0.05, seed=7)
    demand = sum(s.cores for s in fleet.values())
    ufa = RegionCapacity.for_fleet("region", fleet, model="ufa",
                                   overcommit_factor=r["recommended"])
    legacy = RegionCapacity.for_fleet("region", fleet, model="legacy")
    saved = legacy.steady.physical_cores - ufa.steady.physical_cores
    print(f"\nfleet steady demand/region: {demand:,.0f} cores")
    print(f"legacy 2x provisioning:     {legacy.steady.physical_cores:,.0f} cores")
    print(f"UFA provisioning:           {ufa.steady.physical_cores:,.0f} cores "
          f"(+{ufa.steady.overcommit.capacity:,.0f} overcommit pool)")
    print(f"cores returned:             {saved:,.0f} "
          f"({saved/legacy.steady.physical_cores:.0%} of legacy)")


if __name__ == "__main__":
    main()
