"""Wall-clock ms a decode step of llama3.2-3b at full width (28 layers,
bf16, B 8 against 4,352 cache slots from length 4,096, random weights
from seed 0: phase 10c's decode of ``chip_smoke.py``) for the copy of
the port under ``--src``.  Decode is host-bound (a few hundred small
launches a step), so this times the host work a step adds; run two
trees of the port in one call on one card, alternating (A, B, B, A), to
compare them.  Needs a CUDA card; builds B4 and B5 under the tree's own
``build/``.

    python3 tools/decode_step_timing.py --src DIR [--steps 40] [--reps 3]

Prints one JSON line: the tree, the card's name and power limit, and
each rep's ms a step.
"""

import argparse
import json
import os
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True,
                    help="a checkout's src/ holding repro_torch")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("decode_step_timing: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs.llama3_2_3b import CONFIG as cfg
    from repro_torch.kernels import build
    from repro_torch.models import decode_step, init_decode_state, init_params
    build.build_all(["rmsnorm", "decode_attention"])
    dev = torch.device("cuda")
    B, slots, start = 8, 4352, 4096
    params = init_params(cfg, 0, device=dev)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (args.steps + 4, B),
                         generator=gen).to(dev)
    ms = []
    with torch.no_grad():
        for _ in range(args.reps):
            st = init_decode_state(cfg, B, slots, torch.bfloat16,
                                   length=start, device=dev)
            for t in range(4):            # warm-up
                _, st = decode_step(params, cfg, st, toks[t])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for t in range(args.steps):
                _, st = decode_step(params, cfg, st, toks[4 + t])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) / args.steps * 1e3)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps({"src": args.src, "card": card, "steps": args.steps,
                      "ms_a_step": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
