"""End-to-end UFA failover drill with real ML workloads, on the port
(``examples/failover_drill.py`` of the reference).

Two-region active-active deployment in miniature:
  - a T1 (Always-On) serving engine answering tiered requests (B4, B5,
    B6 on the card),
  - a T5 (Restore-Later) training job running opportunistically in the
    overcommit pool,
  - the OMG orchestrator wired to both via its eviction/restore hooks.

A full-peak regional failure is injected: UFA evicts the trainer, blocks
preemptible-tier traffic, keeps T0/T1 availability at 100%, restores the
trainer from its checkpoint within RTO, and fails back; then the
256-scenario ensemble sweep.  The weights are the port's
``init_params(CFG, seed)``, drawn on the CPU whatever the device (the
reference draws with ``jax.random.PRNGKey(seed)``), so the two losses
follow the port's weights and a run on the card trains a CPU run's.

  PYTHONPATH=src python -m repro_torch.examples.failover_drill \\
      [--device cpu]
"""

import argparse
import tempfile

import numpy as np

from repro_torch.core.capacity import RegionCapacity
from repro_torch.core.drills import remediate
from repro_torch.core.metrics import availability_during_failover
from repro_torch.core.omg import Orchestrator
from repro_torch.core.scenarios import (FleetAggregates, summarize_sweep,
                                        sweep_scenarios)
from repro_torch.core.service import synthesize_fleet, unsafe_edges
from repro_torch.core.tiers import Tier
from repro_torch.data import SyntheticLMDataset, make_train_iterator
from repro_torch.examples.common import (add_device_arg, init_weights,
                                         train_state)
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import LMConfig
from repro_torch.serving import Request, ServingEngine, TieredScheduler
from repro_torch.train import make_train_step
from repro_torch.train.trainer import Trainer

CFG = LMConfig(name="drill", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
               d_head=16, d_ff=128, vocab_size=128, tie_embeddings=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    dev = resolve_device(ap.parse_args(argv).device)

    # ---- control plane --------------------------------------------------
    fleet = synthesize_fleet(scale=0.02, seed=4)
    n_unsafe = len(unsafe_edges(fleet))
    remediate(fleet, set(unsafe_edges(fleet)))
    print(f"fleet: {len(fleet)} services; {n_unsafe} fail-close edges "
          f"remediated before the drill")
    region = RegionCapacity.for_fleet("regionB", fleet)

    # ---- data plane ------------------------------------------------------
    params = init_weights(CFG, 0, dev)
    engine = ServingEngine(CFG, params, max_batch=4, max_seq=48)
    sched = TieredScheduler({"serving-t1": engine})
    step_fn, opt = make_train_step(CFG, n_loss_chunks=2)
    ds = SyntheticLMDataset(vocab_size=128, seq_len=16, global_batch=4, seed=1)

    with tempfile.TemporaryDirectory() as ckdir:
        trainer = Trainer(CFG, step_fn, ckdir, checkpoint_every=2)
        tstate = train_state(CFG, 0, opt, dev)
        tstate, rep0 = trainer.run(tstate, make_train_iterator(ds, device=dev),
                                   6)
        print(f"batch training in overcommit pool: {rep0.steps_done} steps, "
              f"loss {rep0.final_loss:.3f}")

        def on_evict(spec):
            if not trainer._preempt_requested:
                print(f"  [UFA] evicting preemptible workloads "
                      f"(e.g. {spec.name}) — BBM")
                trainer.request_preempt()
                sched.enter_failover()

        restored = []
        orch = Orchestrator(fleet, region, scale=0.02, on_evict=on_evict,
                            on_restore=lambda s: restored.append(s.name))

        print("\n== injecting full-peak regional failure ==")
        report = orch.failover(tv_failover=1.0)

        rng = np.random.default_rng(0)
        for i in range(18):
            sched.submit(Request(i, tier=Tier(i % 6),
                                 prompt=list(rng.integers(0, 128, 8)),
                                 max_new_tokens=2))
        while sched.tick():
            pass

        print(f"mode={report.mode} | burst full at "
              f"{report.burst_full_at_s/60:.1f} min | AM migrated at "
              f"{report.am_migrated_at_s/60:.1f} min | RL restored at "
              f"{report.rl_restored_at_s/60:.1f} min (1h RTO met: "
              f"{report.rl_rto_met})")
        print(f"restored {len(restored)} Restore-Later services in "
              f"burst/cloud capacity")
        series = availability_during_failover(fleet, orch)
        print(f"availability through the window: min="
              f"{min(a for _, a in series):.4f} (paper: 0.9997)")
        for t in (Tier.T0, Tier.T1, Tier.T4, Tier.T5):
            s = engine.counters["served"][t]
            r = engine.counters["rejected"][t]
            print(f"  tier {t.name}: served={s} rejected={r} "
                  f"availability={engine.availability(t):.2f}")

        print("\n== restoring the preempted training job (BBM revive) ==")
        sched.exit_failover()
        t2 = train_state(CFG, 9, opt, dev)
        t2, start = trainer.maybe_resume(t2, device=dev)
        trainer._preempt_requested = False
        t2, rep2 = trainer.run(t2, make_train_iterator(ds, start_step=start,
                                                       device=dev),
                               4, start_step=start)
        print(f"training resumed at step {start}, continued "
              f"{rep2.steps_done} steps, loss {rep2.final_loss:.3f}")

        orch.failback()
        print(f"failback complete at t={orch.loop.now/60:.1f} min; all "
              f"{len(orch.se)} services back in steady state")

    # ---- scenario ensemble: one drill is an anecdote, 256 are evidence --
    print("\n== scenario-ensemble sweep (vmapped capacity model) ==")
    agg = FleetAggregates.from_fleet(fleet)
    res = sweep_scenarios(agg, device=dev)   # default 4^4 grid
    s = summarize_sweep(res)
    print(f"evaluated {s['n_scenarios']} failover scenarios in one vmap: "
          f"{s['n_sla_ok']} meet every class SLA "
          f"({s['sla_ok_fraction']:.0%})")
    print(f"availability min={s['availability_min']:.4f} "
          f"mean={s['availability_mean']:.4f}; worst Restore-Later "
          f"completion {s['worst_rl_done_min']:.0f} min (RTO 60)")
    bad = ~res["sla_ok"]
    if bad.any():
        fail_idx = np.flatnonzero(bad)
        i = int(fail_idx[np.argmin(res["availability"][fail_idx])])
        print(f"worst scenario: traffic x{res['traffic_mult'][i]:.1f}, "
              f"burst availability {res['burst_availability'][i]:.0%}, "
              f"preheat {res['burst_delay_s'][i]:.0f}s, cloud quota "
              f"x{res['cloud_quota_frac'][i]:.2f} -> availability "
              f"{res['availability'][i]:.4f}")


if __name__ == "__main__":
    main()
