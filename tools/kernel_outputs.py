"""Digests (and times) of the model kernels' outputs on
``chip_smoke.py``'s phase 6 inputs, for holding two trees of the port bit
for bit on one card, and timing them in turns.

Each tree's own ``chip_smoke.py`` draws phase 6's cases in order from one
seed (``model_cases``), so the cases two trees share come first and are
the same inputs.  For every case of the dtypes given, the tree's kernel
wrapper runs once and the SHA-256 of its output bytes (every part of a
tuple) is kept under the case's index, op and label; with ``--time``,
also the kernel's CUDA-event ms a call (the mean of ``--reps`` calls
after two warm-up calls: for a launch-bound call, the host's time a
call) and the profiler's device ms a call (the kernel's own time).
Needs a CUDA card; builds the kernels under the tree's own ``build/``.

    python3 tools/kernel_outputs.py --root DIR --out FILE.json [--time]
        [--reps N]
    python3 tools/kernel_outputs.py --compare A.json B.json [C.json D.json]

``--compare`` prints one JSON line: how many cases the first two files
share (same index, op and label), how many of them differ, and the first
few that do; it exits 1 when any does.  Where the files hold times it
adds under ``ms``, for each op, the median over the shared cases of the
ratio of the files' ms (the second and third files' mean over the first
and fourth's for four files: A, B, B, A), and the cases whose ratio is
largest; under ``device_ms`` the same for the device ms.
"""

import argparse
import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys


def digests(root: str, dtypes, reps: int = 0) -> tuple:
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    spec = importlib.util.spec_from_file_location(
        "tree_chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.kernels import build
    build.build_all()
    dev = torch.device("cuda")
    ops, cases = smoke.model_cases(torch, dev)
    out, ms, dev_ms = {}, {}, {}
    for i, c in enumerate(cases):
        if str(c["dtype"]).split(".")[-1] not in dtypes:
            continue
        fn = getattr(ops, c["op"])
        got = fn(*c["args"], **c["kwargs"])
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for t in (got if isinstance(got, tuple) else (got,)):
            h.update(t.contiguous().view(torch.uint8).cpu().numpy()
                     .tobytes())
        key = f"{i}|{c['op']}|{c['label']}"
        out[key] = h.hexdigest()
        if reps:
            def call():
                return fn(*c["args"], **c["kwargs"])
            ms[key] = smoke.device_ms(torch, call, reps)
            dev_ms[key] = smoke.profiled_device_ms(torch, call, reps)
    return out, ms, dev_ms


def ratios(times: list, shared: list) -> dict:
    """Each shared case's ratio of the second file's time over the
    first's (for four files A, B, B, A: the B files' sum over the A
    files'), and the median by op and the largest eight."""
    def ratio(k):
        if len(times) == 2:
            return times[1][k] / times[0][k]
        return (times[1][k] + times[2][k]) / (times[0][k] + times[3][k])
    got = {k: ratio(k) for k in shared if all(t.get(k) for t in times)}
    ops = sorted({k.split("|")[1] for k in got})
    return {"median_ratio": {
                op: statistics.median(r for k, r in got.items()
                                      if k.split("|")[1] == op)
                for op in ops},
            "largest": sorted(got.items(), key=lambda kv: -kv[1])[:8]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", help="a checkout of the repo")
    ap.add_argument("--out", help="where to write the digests")
    ap.add_argument("--dtypes", default="float32,bfloat16")
    ap.add_argument("--time", action="store_true",
                    help="also time each case (CUDA events and the "
                    "profiler's device time)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--compare", nargs="+", metavar="JSON")
    args = ap.parse_args()
    if args.compare:
        files = [json.load(open(p)) for p in args.compare]
        a, b = files[0]["digests"], files[1]["digests"]
        shared = [k for k in a if k in b]
        differ = [k for k in shared if a[k] != b[k]]
        res = {"shared": len(shared), "differ": len(differ),
               "first": differ[:10]}
        for name in ("ms", "device_ms"):
            times = [f.get(name) or {} for f in files]
            if len(times) in (2, 4) and all(times):
                res[name] = ratios(times, shared)
        print(json.dumps(res))
        return 1 if differ or not shared else 0
    import torch
    if not torch.cuda.is_available():
        print("kernel_outputs: no CUDA card", file=sys.stderr)
        return 2
    got, ms, dev_ms = digests(os.path.abspath(args.root),
                              args.dtypes.split(","),
                              args.reps if args.time else 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    with open(args.out, "w") as f:
        json.dump({"root": args.root, "card": card.strip(),
                   "digests": got, "ms": ms, "device_ms": dev_ms}, f)
    print(f"{len(got)} cases -> {args.out} [{card.strip()}]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
