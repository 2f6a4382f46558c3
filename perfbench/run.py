"""The port's benchmark: one run of one cell on the CUDA card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Everything the cell is, its configuration,
traffic mix, check and metrics, is found by name (``pbharness/files.py``).
The run draws weights and prompts from ``--seed`` on the card, warms up
the cell's shape (set-up), measures ``--seconds`` of the closed prefill
loop, checks a sample of the window's answers against the plain float32
reference, and prints one JSON line last on standard output, the
compared numbers beside their limits last on standard error.  With
``--trace 1`` it profiles a few of the window's steps and reports the
per-layer metrics instead of the end-to-end ones.  Without a CUDA card,
or with JAX or the JAX package loaded, it prints no result and exits
non-zero.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent / "src"))
sys.path.insert(0, str(HERE))


def _finite(x):
    return x if not isinstance(x, float) or math.isfinite(x) else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from pbharness import core, files

    bench = files.manifest()
    chips = files.cell_entry(args.workload, bench)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: {args.workload} needs {chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = core.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", T0, bench)
    loaded = core.banned_modules()
    if loaded:
        print(f"run.py: JAX or the JAX package is loaded: {loaded}",
              file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        c["value"] = _finite(c["value"])
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
