"""Temporal scenario ensemble: execute failure *timelines*, not point
estimates, on the port (``examples/temporal_sweep.py`` of the reference).

Synthesizes a Tables-1-3 fleet, then runs the fused sweep engine
(``repro_torch.core.sweep_engine``: analytic model, the timeline
verdict reduction (B1) and dependency propagation (B2) on the device)
over the scenario grid, before and after hardening: per-scenario
time-to-restore per tier, the availability integral against the 99.97%
SLA and the peak on-demand cloud draw, beside the analytic verdicts.

  PYTHONPATH=src python -m repro_torch.examples.temporal_sweep
  # the README's 64k-scenario ensemble:
  PYTHONPATH=src python -m repro_torch.examples.temporal_sweep \\
      --grid-size 65536
  # the scenario axis sharded over N ranks (one a card; gloo ranks with
  # --device cpu):
  PYTHONPATH=src python -m repro_torch.examples.temporal_sweep \\
      --devices 2 --device cpu
  # with the observability plane on: Chrome trace (load in Perfetto),
  # Prometheus + JSONL metric snapshots, SLO burn-rate verdicts
  PYTHONPATH=src python -m repro_torch.examples.temporal_sweep --trace \\
      --metrics-out

With ``--devices N > 1`` the driver spawns N ranks over
``torch.distributed`` (``launch.mesh.run_ranks``; gloo on the CPU, NCCL
with one rank a card on CUDA); every rank runs the driver, the sweep
engine shards each chunk's scenarios over the world's mesh, and rank 0
prints and writes.  The reference re-executes itself with N fake XLA
host devices instead.
"""

import argparse
import contextlib
import io
import time

import numpy as np
import torch

from repro_torch.core.scenarios import (operating_point_mask, scenario_grid,
                                        summarize_sweep,
                                        sweep_with_dependency_ensemble)
from repro_torch.core.service import synthesize_fleet
from repro_torch.core.sweep_engine import tile_grid
from repro_torch.core.tiers import Tier
from repro_torch.examples.common import ObsPlane, add_device_arg
from repro_torch.graph import CallGraph, plan_hardening
from repro_torch.kernels.backend import resolve_device
from repro_torch.launch.mesh import init_world, run_ranks


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid-size", type=int, default=256,
                    help="scenario count (the 256-point base grid is "
                         "tiled out; the fused engine bucket-pads)")
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks to shard the scenario axis over (one a "
                         "card on CUDA, gloo processes on the CPU)")
    ap.add_argument("--trace", nargs="?", const="failover_trace.json",
                    default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON of the run "
                         "(host pipeline phases + a traced event-loop "
                         "failover); open in https://ui.perfetto.dev")
    ap.add_argument("--metrics-out", nargs="?", const="metrics.prom",
                    default=None, metavar="PATH",
                    help="enable the metrics registry and write a "
                         "Prometheus snapshot (+ JSONL next to it)")
    add_device_arg(ap)
    return ap


def _run(args, dev: torch.device, world: int = 1, rank: int = 0) -> None:
    plane = ObsPlane(args.trace, args.metrics_out, write=rank == 0)

    fs = synthesize_fleet(scale=0.1, seed=7, as_arrays=True,
                          unsafe_chain_fraction=0.02)
    fs.apply_ufa_target_classes()
    print(f"fleet: {fs.n} service-environments, "
          f"{float(fs.spec_cores.sum()):,.0f} cores | "
          f"grid={args.grid_size} devices={world}")

    grid = tile_grid(scenario_grid(), args.grid_size)

    # 1. the un-remediated fleet: fail-close chains break criticals in
    #    every blackhole scenario, sinking the availability trace
    with plane.phase("sweep-unhardened"):
        res0 = sweep_with_dependency_ensemble(fs, grid=grid, temporal=True,
                                              device=dev)
    print(f"\nbefore hardening: t_sla_ok="
          f"{int(res0['t_sla_ok'].sum())}/{len(res0['t_sla_ok'])} "
          f"worst avail integral "
          f"{float(res0['t_availability_mean'].min()):.5f}")

    # 2. harden: greedily fail-open the highest-blast-radius unsafe edges
    #    until the full blackhole certifies (paper's 4,000+ conversions)
    graph = CallGraph.from_fleet_state(fs)
    with plane.phase("plan-hardening"):
        plan = plan_hardening(graph, device=dev)
    # plan indices are CSR positions; map back to FleetState edge order
    fs.edges.fail_open[graph.input_edge_indices(plan.hardened_edges)] = True
    print(f"hardened {plan.n_hardened} edges in {plan.rounds} rounds "
          f"(certified={plan.certified})")

    # 3. the hardened fleet, same temporal ensemble
    t0 = time.time()
    with plane.phase("sweep-hardened"):
        res = sweep_with_dependency_ensemble(fs, grid=grid, temporal=True,
                                             device=dev)
    dt = time.time() - t0
    print(f"fused sweep: {len(res['sla_ok'])} scenarios in {dt:.2f}s "
          f"({len(res['sla_ok'])/dt:,.0f} scenarios/s)")
    summary = summarize_sweep(res)
    print("\n== ensemble digest (analytic + temporal, hardened fleet) ==")
    for k, v in summary.items():
        print(f"  {k:32s} {v}")

    print("\n== analytic vs temporal disagreements ==")
    diff = np.flatnonzero(res["sla_ok"] != res["t_sla_ok"])
    print(f"  {len(diff)} of {len(res['sla_ok'])} scenarios differ")
    for i in diff[:5]:
        print(f"  mult={res['traffic_mult'][i]:.1f} "
              f"burst_avail={res['burst_availability'][i]:.2f} "
              f"quota={res['cloud_quota_frac'][i]:.2f} "
              f"evict={res['evict_fraction'][i]:.2f}: "
              f"analytic={bool(res['sla_ok'][i])} "
              f"temporal={bool(res['t_sla_ok'][i])} "
              f"t_rl_done={res['t_rl_done_s'][i]/60.0:.1f}min")

    print("\n== worst temporal scenarios (availability integral) ==")
    order = np.argsort(res["t_availability_mean"])[:5]
    for i in order:
        ttr = res["t_time_to_restore_s"][i]
        t3 = ttr[int(Tier.T3)]
        print(f"  avail_mean={res['t_availability_mean'][i]:.5f} "
              f"mult={res['traffic_mult'][i]:.1f} "
              f"burst_avail={res['burst_availability'][i]:.2f} "
              f"quota={res['cloud_quota_frac'][i]:.2f} "
              f"dep_broken={res['dep_broken_frac'][i]:.3f} "
              f"T3_restore={'never' if np.isinf(t3) else f'{t3/60:.0f}min'} "
              f"peak_cloud={res['t_peak_cloud_cores'][i]:,.0f}")

    op = operating_point_mask(res)
    i = int(np.flatnonzero(op)[0])
    print("\n== paper operating point, per-tier time-to-restore ==")
    for t in Tier:
        v = res["t_time_to_restore_s"][i][int(t)]
        label = ("never (until failback)" if np.isinf(v)
                 else "no interruption" if v == 0.0 else f"{v/60.0:.1f} min")
        print(f"  {t.name:3s} {label}")
    print(f"  availability integral: "
          f"{res['t_availability_mean'][i]:.5f} (SLA 0.9997) "
          f"temporal_sla_ok={bool(res['t_sla_ok'][i])}")

    if plane.on:
        from repro_torch.core.timeline_sim import (config_for_fleet,
                                                   sweep_timeline)
        from repro_torch.obs import slo

        # SLO burn-rate monitor over full per-step availability traces
        # (multi-window multi-burn-rate against the 99.97% target),
        # verdict quality judged against the kernel's own avail_ok
        with plane.phase("slo-monitor"):
            cfg = config_for_fleet(fs)
            n_slo = min(args.grid_size, 256)
            tr = sweep_timeline(cfg, grid=tile_grid(scenario_grid(), n_slo),
                                return_traces=True, device=dev)
            verd = slo.sweep_alerts(tr["trace_availability"], tr["t"],
                                    device=dev)
            quality = slo.alert_quality(verd["alert"], ~tr["avail_ok"],
                                        verd["t_first_alert"])
        print("\n== SLO burn-rate monitor (99.97% target) ==")
        print(f"  rules: {[r.name for r in slo.DEFAULT_RULES]}")
        print(f"  alerts on {quality['n_alerts']}/{quality['n_scenarios']} "
              f"scenarios ({quality['n_violations']} true SLA violations): "
              f"precision={quality['precision']:.2f} "
              f"recall={quality['recall']:.2f} "
              f"median time-to-first-alert="
              f"{quality['median_t_first_alert']:.0f}s")

        if args.trace:
            # one traced event-loop failover: the orchestration waves
            # (BBM evict, burst conversion, MBB/RL waves, cloud grants)
            # render as sim-time spans alongside the host phases above
            from repro_torch.core.capacity import RegionCapacity
            from repro_torch.core.omg import Orchestrator
            with plane.phase("traced-failover"):
                orch = Orchestrator(fs, RegionCapacity.for_fleet("tr", fs),
                                    tracer=plane.tracer)
                orch.failover()
        plane.finish({"example": "temporal_sweep",
                      "grid_size": args.grid_size})


def _rank_main(rank: int, world: int, init_file: str, args) -> str:
    """One rank of ``--devices N``: the driver under the world's mesh;
    returns what it printed (rank 0's is the run's output)."""
    if args.device == "cpu":
        torch.set_num_threads(1)
    dev = init_world(init_file, rank, world, args.device)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _run(args, dev, world, rank)
    return buf.getvalue()


def main(argv=None):
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    if args.devices <= 1:
        return _run(args, dev)
    if dev.type == "cuda" and args.devices > torch.cuda.device_count():
        raise ValueError(f"--devices {args.devices}: one rank a card, and "
                         f"this host has {torch.cuda.device_count()}")
    print(run_ranks(_rank_main, args.devices, (args,))[0], end="")


if __name__ == "__main__":
    main()
