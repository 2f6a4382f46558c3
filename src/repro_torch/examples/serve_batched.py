"""End-to-end serving driver, on the port (``examples/serve_batched.py``
of the reference): serve qwen3-1.7b's reduced config with batched,
tiered requests through the UFA request plane (B4 on every norm, B5 a
decode step, B6 for a prefill on the card).

A tiered request mix (Table 2 volume shape), wave batching with
strict-priority + aging scheduling, and a mid-run failover window with
preemptible-tier blocking; prints per-tier counters and availability,
throughput, and the differentiated-SLA effect.  The weights are the
port's ``init_params(cfg, 0)`` (drawn on the CPU); the counters do not
depend on them.

  PYTHONPATH=src python -m repro_torch.examples.serve_batched \\
      [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.tiers import Tier
from repro_torch.examples.common import (add_device_arg, device_label,
                                         init_weights)
from repro_torch.kernels.backend import resolve_device
from repro_torch.serving import Request, ServingEngine, TieredScheduler


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    dev = resolve_device(ap.parse_args(argv).device)
    arch = get_arch("qwen3-1.7b")
    cfg = arch.reduced
    print(f"serving {cfg.name}: {cfg.param_count()/1e6:.2f}M params "
          f"(reduced config of {arch.arch_id})")
    params = init_weights(cfg, 0, dev)
    engine = ServingEngine(cfg, params, max_batch=8, max_seq=64)
    sched = TieredScheduler({"pod0": engine})

    rng = np.random.default_rng(0)
    # request mix skewed like production: mostly critical-tier traffic
    tier_mix = [Tier.T0] * 1 + [Tier.T1] * 6 + [Tier.T2] * 2 + \
        [Tier.T3] * 2 + [Tier.T4] * 1 + [Tier.T5] * 2
    rid = 0

    def submit(n):
        nonlocal rid
        for _ in range(n):
            sched.submit(Request(rid, tier=tier_mix[rid % len(tier_mix)],
                                 prompt=list(rng.integers(0, cfg.vocab_size, 8)),
                                 max_new_tokens=4))
            rid += 1

    t0 = time.perf_counter()
    submit(24)
    for _ in range(60):
        sched.tick()

    print("\n== failover window: preemptible tiers blocked ==")
    sched.enter_failover()
    submit(24)
    for _ in range(60):
        sched.tick()
    sched.exit_failover()

    print("== failback: all tiers restored ==")
    submit(12)
    for _ in range(80):
        sched.tick()
        if sched.queue_depth() == 0 and not engine.wave:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0

    total_served = sum(engine.counters["served"].values())
    print(f"\n{total_served} requests served, "
          f"{engine.tokens_decoded} tokens decoded in {dt:.1f}s "
          f"({engine.tokens_decoded/dt:.0f} tok/s on {device_label(dev)})")
    print(f"{'tier':>6} {'served':>7} {'rejected':>9} {'availability':>13}")
    for t in Tier:
        s = engine.counters["served"][t]
        r = engine.counters["rejected"][t]
        if s + r == 0:
            continue
        print(f"{t.name:>6} {s:>7} {r:>9} {engine.availability(t):>12.2f}")
    assert engine.availability(Tier.T1) == 1.0
    print("\ndifferentiated SLA holds: critical tiers at 1.00 availability "
          "through the failover; preemptible tiers failed fast (paper §4.2)")


if __name__ == "__main__":
    main()
