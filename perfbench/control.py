"""Readings that set a cell's limits: the program on many seeds, and the
controls (``reference/precision.py``) on a few, at the cell's own size and
load, on the CUDA card.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 [--controls fp8,scan_tf32] \
        [--out chiprun_out/readings.jsonl]
    python3 perfbench/control.py --workload <cell> --seeds 1,2 --witness

For each seed: the weights and prompts drawn from it, a short window of
the cell's closed loop through the timed call (as many batches as a run
samples from), the sample a run would draw, and the compared numbers of
the program against the float32 reference; for the control seeds also
the numbers of each control in the program's place (by default those the
cell's check lists), on the same inputs, against the same reference.
``--witness`` instead reads, on the first sampled batch, how far the
program's and the bf16 reference's last-position logits lie from the
float32 reference's, run end to end from the prompts, and the share of
tokens whose top-k experts differ between the two references, layer by
layer.  One process; the weights are drawn again in place for each
seed.  Prints one JSON line a seed.  The benchmark's runs never run
this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent / "src"))
sys.path.insert(0, str(HERE))


def _window(cell, seed, session, device):
    """The weights for ``seed`` and a window of as many batches as a run
    samples from; returns what the check reads."""
    from pbharness import core, files, trace, traffic, weights

    wl = files.workload(cell)
    conf = files.config(wl["config"])
    fresh = session is None
    if fresh:
        session = core.Session(conf, seed, device)
    else:
        weights.draw(session.plan, seed, device)
    gen = traffic.load(files.traffic(wl["traffic"]), seed,
                       conf["vocab_draw"], device)
    patches = trace.Patches()
    win = core.Window(wl, conf, gen, seed, False, patches)
    if fresh:   # later seeds find the shapes warm
        win.warm_up(gen, session.step)
    records = gen.run(session.step, 0.0, min_steps=win.min_steps,
                      before=win.before, after=win.after)
    patches.remove()
    return session, (conf, wl, session.params, gen, records, win.idx,
                     win.kept, seed)


def _out(row, out, device):
    import torch
    if torch.device(device).type == "cuda":
        row["device"] = torch.cuda.get_device_name(device)
    print(json.dumps(row), flush=True)
    if out:
        with open(out, "a") as f:
            f.write(json.dumps(row) + "\n")


def readings(cell: str, seeds, control_seeds, device="cuda", out=None,
             controls=None):
    import torch
    from pbharness import core, files

    conf = files.config(files.workload(cell)["config"])
    dev = torch.device(device)
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.build_all(conf["kernels"])
    precision = files.load_module("reference", "precision")
    lm = files.load_module("reference", "lm")
    if controls is None:
        controls = files.workload(cell)["check"]["controls"]
    session = None
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        session, args = _window(cell, seed, session, dev)
        row = {"cell": cell, "seed": seed,
               "program": core.check_numbers(*args), "control": None}
        if seed in control_seeds:
            row["control"] = {
                name: core.check_numbers(
                    *args, lm.lowered(name, precision.CONTROLS[name]))
                for name in controls}
        del args
        row["seconds"] = time.perf_counter() - t0
        _out(row, out, dev)
        rows.append(row)
    return rows


def witness(cell: str, seeds, device="cuda", out=None):
    import torch
    from pbharness import compare, core, files

    conf = files.config(files.workload(cell)["config"])
    dev = torch.device(device)
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.build_all(conf["kernels"])
    precision = files.load_module("reference", "precision")
    lm = files.load_module("reference", "lm")
    family = files.load_module("reference", conf["family"])
    session = None
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        session, args = _window(cell, seed, session, dev)
        _, _, params, gen, records, idx, _, _ = args
        i = idx[0]
        ids = gen.prompts(records[i]["index"])
        served = records[i]["out"].float()
        tokens = torch.tensor(records[i]["tokens"], device=served.device)
        del args, records
        f32 = lm.lowered("float32", {}, routes=[])
        b16 = lm.lowered("bf16", precision.BF16, routes=[])
        (ref,) = lm.last_logits(conf, params, [ids], family, f32)
        (low,) = lm.last_logits(conf, params, [ids], family, b16)
        flips = [float((a.sort(dim=-1).values != b.sort(dim=-1).values)
                       .any(dim=-1).double().mean())
                 for a, b in zip(f32.routes, b16.routes)]
        row = {"cell": cell, "seed": seed,
               "program": compare.numbers(served, tokens, ref),
               "bf16_reference": compare.numbers(low, low.argmax(dim=-1),
                                                 ref),
               "topk_flip_share_by_layer": flips,
               "seconds": time.perf_counter() - t0}
        _out(row, out, dev)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--controls", default=None)
    ap.add_argument("--witness", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    if args.witness:
        witness(args.workload, seeds, out=args.out)
        return 0
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    names = args.controls.split(",") if args.controls else None
    readings(args.workload, seeds, ctl, out=args.out, controls=names)
    return 0


if __name__ == "__main__":
    sys.exit(main())
