"""Serving launcher: batched tiered requests against one arch (port of
``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
      --requests 32 [--failover-at 16] [--device cuda|cpu]

Uses the REDUCED config.  --failover-at N triggers the UFA request-plane
failover (preemptible tiers blocked + running waves preempted) after N
submissions, demonstrating differentiated SLAs.  --device (default
cuda) is where the weights lie and the decode steps run; the weights
are the port's ``init_params(cfg, 0)`` and the prompts the reference's
(``np.random.default_rng(0)``), so the printed counters equal the
reference CLI's.
"""

import argparse

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.core.tiers import Tier
from repro_torch.models import init_params
from repro_torch.serving import Request, ServingEngine, TieredScheduler

def serve(engine: ServingEngine, requests: int, prompt_len: int,
          max_new: int, failover_at=None, log=print) -> TieredScheduler:
    """The CLI's schedule on one engine: ``requests`` submissions cycling
    the tiers, one scheduler round after each, ``enter_failover()``
    before submission ``failover_at``, then rounds until the queue and
    the wave are empty (at most 10 a request) and ``exit_failover()``.
    Prompts are ``prompt_len`` draws from ``np.random.default_rng(0)``
    (token ids, or 0/1 for a stub-frontend config)."""
    cfg = engine.cfg
    sched = TieredScheduler({"pod0": engine})
    rng = np.random.default_rng(0)
    tiers = list(Tier)
    for i in range(requests):
        if failover_at is not None and i == failover_at:
            log(f"-- failover injected after {i} submissions --")
            sched.enter_failover()
        if cfg.embed_inputs:
            prompt = list(rng.integers(0, cfg.vocab_size, prompt_len))
        else:
            prompt = list(rng.integers(0, 2, prompt_len))
        sched.submit(Request(i, tier=tiers[i % len(tiers)], prompt=prompt,
                             max_new_tokens=max_new))
        sched.tick()
    for _ in range(10 * requests):
        if sched.queue_depth() == 0 and not any(
                e.wave for e in sched.engines.values()):
            break
        sched.tick()
    if sched.failover_active:
        sched.exit_failover()
    return sched


def counter_table(engine: ServingEngine) -> str:
    """Tokens decoded and the per-tier served / rejected / availability
    table, as the CLI prints them."""
    lines = [f"tokens decoded: {engine.tokens_decoded}",
             f"{'tier':>6} {'served':>7} {'rejected':>9} {'availability':>13}"]
    for t in Tier:
        s = engine.counters["served"][t]
        r = engine.counters["rejected"][t]
        if s + r:
            lines.append(f"{t.name:>6} {s:>7} {r:>9} "
                         f"{engine.availability(t):>12.2f}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=4)
    ap.add_argument("--failover-at", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    cfg = arch.reduced
    print(f"serving {args.arch} (reduced: {cfg.param_count()/1e6:.1f}M params)")
    params = init_params(cfg, 0, device=args.device)
    engine = ServingEngine(cfg, params, max_batch=args.max_batch,
                           max_seq=args.prompt_len + args.max_new + 8)
    serve(engine, args.requests, args.prompt_len, args.max_new,
          args.failover_at)
    print(counter_table(engine))


if __name__ == "__main__":
    main()
