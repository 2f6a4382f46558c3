"""One run of one cell: set-up, the measured window, the check.

``run_cell`` draws the weights and the prompts from the seed, warms up
the cell's own shape, runs the traffic mix's closed loop for the window,
reads the device's peak memory, then checks a sample of the window's
answers against the plain float32 reference and reads the metrics the
manifest gives the cell.  ``run.py`` is the command line around it.
"""

from __future__ import annotations

import math
import sys
import time
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch

from pbharness import compare, files, peaks, trace, traffic, weights

BANNED_MODULES = ("jax", "jaxlib", "flax", "repro")
TRACE_SKIP = 2  # window batches before the traced ones
LAYER_FN = "repro_torch.models.model._layer_forward"


def log(msg: str) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


class Session:
    """The program under test, its weights and its timed call."""

    def __init__(self, conf: dict, seed: int, device):
        t0 = time.perf_counter()
        from repro_torch import models
        self.models = models
        self.cfg = models.LMConfig(**conf["lm_config"])
        abstract = models.init_abstract(self.cfg)
        t1 = time.perf_counter()
        self.params, self.plan = weights.make(abstract, conf["init"], seed,
                                              device)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        log(f"weights: the program's tree {t1 - t0:.3f} s, drawn "
            f"{time.perf_counter() - t1:.3f} s")

    @torch.no_grad()
    def step(self, ids: torch.Tensor):
        """One prefill of a batch: the forward pass, the head at each
        prompt's last position, and the first tokens on the host."""
        h, _ = self.models.forward(self.params, self.cfg, ids)
        logits = self.models.logits_fn(self.params, self.cfg, h[:, -1, :])
        return torch.argmax(logits, dim=-1).tolist(), logits


class Chain:
    """Keeps the hidden states entering each of the program's layers, and
    the last layer's output, for the batches the check follows layer by
    layer: references to the program's own tensors, no copy."""

    name = "chain"

    def __init__(self, patches: trace.Patches):
        self.chain: Optional[list] = None
        self.last = None
        self.seen = False
        patches.wrap(LAYER_FN, self._wrap)

    def _wrap(self, fn):
        def wrapper(lp, h, *args, **kwargs):
            out = fn(lp, h, *args, **kwargs)
            if self.chain is not None:
                self.chain.append(h)
                self.last = out[0]
            return out
        return wrapper

    def begin(self, index: int):
        self.chain, self.last = [], None

    def end(self) -> list:
        chain = self.chain + ([self.last] if self.last is not None else [])
        self.seen = self.seen or bool(chain)
        self.chain, self.last = None, None
        return chain


class Stage:
    """Keeps what ``stages/<name>.py`` keeps of the calls its span sees in
    the layers drawn from the seed, for the batches the check compares.
    The span is called once a layer, so the n-th call of a batch is
    layer n."""

    def __init__(self, name: str, patches: trace.Patches, seed: int,
                 n_layers: int, layers: int):
        self.name = name
        self.mod = files.load_module("stages", name)
        self.seed = seed
        self.layers = set(pick(n_layers, layers, seed, _tag(name)))
        self.kept: Optional[list] = None
        self.calls = self.index = 0
        self.seen = False
        patches.wrap(self.mod.SPAN, self._wrap)

    def _wrap(self, fn):
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            if self.kept is not None:
                if self.calls in self.layers:
                    layer = self.calls
                    self.kept.append((layer, self.mod.keep(
                        args, kwargs, out,
                        lambda n, k, what: pick(n, k, self.seed, self.index,
                                                layer, _tag(what)))))
                self.calls += 1
            return out
        return wrapper

    def begin(self, index: int):
        self.kept, self.calls, self.index = [], 0, index

    def end(self) -> list:
        kept, self.kept = self.kept, None
        self.seen = self.seen or bool(kept)
        return kept


def banned_modules() -> List[str]:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in BANNED_MODULES)


def _tag(name: str) -> int:
    return zlib.crc32(name.encode())


def pick(n: int, k: int, seed: int, *tag: int) -> List[int]:
    """``k`` of ``range(n)`` (all where ``k >= n``), sorted, drawn from the
    seed and the ``tag``."""
    rng = np.random.default_rng([int(seed) & (2 ** 128 - 1), 0xC4EC,
                                 *[int(t) for t in tag]])
    return sorted(rng.choice(n, size=min(k, n), replace=False).tolist())


def sample(n: int, k: int, seed: int) -> List[int]:
    """The window's batches the check compares: ``k`` of the first ``n``,
    drawn from the seed."""
    return pick(n, k, seed)


def reference_logits(conf: dict, params: dict, batches: List[torch.Tensor],
                     prec=None) -> torch.Tensor:
    lm = files.load_module("reference", "lm")
    family = files.load_module("reference", conf["family"])
    return torch.cat(lm.last_logits(conf, params, batches, family,
                                    prec or lm.FLOAT32))


def logits_numbers(conf, params, batches, logits, tokens,
                   prec=None) -> Dict[str, float]:
    """``logits`` mode: the last-position logits against the reference run
    from the prompts (the control's own logits where ``prec``)."""
    ref = reference_logits(conf, params, batches)
    if prec is not None:
        logits = reference_logits(conf, params, batches, prec)
        tokens = logits.argmax(dim=-1)
    return compare.numbers(logits, tokens, ref)


def layers_numbers(conf, params, batches, chains, logits, tokens,
                   prec=None) -> Dict[str, float]:
    """``layers`` mode: the embedding against the prompts; each layer's
    output against the reference layer on the program's own input to it
    (the median and mean over tokens of the relative error of the update,
    the largest over layers and batches); the final norm and head on the
    program's last hidden state against the program's logits and first
    tokens.  Where ``prec`` is given, that control stands in the
    program's place at every stage on the same inputs.  A chain that is
    not a whole batch through every layer fails every number."""
    lm = files.load_module("reference", "lm")
    family = files.load_module("reference", conf["family"])
    lc = conf["lm_config"]
    L = lc["n_layers"]
    bad = {k: math.inf for k in ("embed_err_max", "layer_err_median",
                                 "layer_err_mean", "head_err_max",
                                 "token_gap_max")}
    if len(chains) != len(batches) or any(
            len(c) != L + 1 or any(tuple(t.shape) != (*ids.shape,
                                                      lc["d_model"])
                                   for t in c)
            for c, ids in zip(chains, batches)):
        return bad
    out = {"embed_err_max": max(float((c[0].float() - lm.embed(params, ids))
                                      .abs().max())
                                for c, ids in zip(chains, batches))}
    precs = (lm.FLOAT32,) + ((prec,) if prec is not None else ())
    med = mean = 0.0
    off = []
    for i, j, x, outs in lm.follow(conf, params, [c[:-1] for c in chains],
                                   family, precs):
        got = outs[1] if prec is not None else chains[j][i + 1]
        err = compare.token_update_err(x, got.float(), outs[0])
        med = max(med, float(err.median()))
        mean = max(mean, float(err.mean()))
        off.append(float((err > 0.1).double().mean()))
    out["layer_err_median"], out["layer_err_mean"] = med, mean
    h_last = torch.cat([c[L][:, -1, :] for c in chains])
    ref = lm.head_logits(conf, params, h_last)
    if prec is not None:
        logits = lm.head_logits(conf, params, h_last, prec)
        tokens = logits.argmax(dim=-1)
    ends = compare.numbers(logits, tokens, ref)
    out["head_err_max"] = ends["logit_err_max"]
    out["token_gap_max"] = ends["token_gap_max"]
    log(f"layers: share of tokens off by more than 10% in a layer: max "
        f"{max(off):.5f}, median {sorted(off)[len(off) // 2]:.5f}")
    return out


def stage_numbers(conf, wl, params, kept, prec=None) -> Dict[str, float]:
    """Each of the check's ``stages`` on what it kept of the compared
    batches; a stage that kept nothing fails its numbers."""
    lm = files.load_module("reference", "lm")
    family = files.load_module("reference", conf["family"])
    out: Dict[str, float] = {}
    for st in wl["check"].get("stages", []):
        mod = files.load_module("stages", st["name"])
        got = [item for per in kept.get(st["name"], {}).values()
               for item in per]
        if not got:
            out.update({k: math.inf for k in mod.NUMBERS})
            continue
        out.update(mod.numbers(got, conf, params, prec, lm, family))
    return out


def check_numbers(conf, wl, params, gen, records, idx, kept, seed,
                  prec=None) -> Dict[str, float]:
    """The compared numbers of the program (or of the control ``prec`` in
    its place) on the window's sampled batches ``idx``: in ``logits``
    mode on ``sample_rows`` rows of each, drawn from the seed, in
    ``layers`` mode on whole batches; then the check's stages."""
    chk = wl["check"]
    served = [records[i]["out"].float() for i in idx]
    tokens = [torch.tensor(records[i]["tokens"], device=served[0].device)
              for i in idx]
    if chk["mode"] == "layers":
        rows = [list(range(s.shape[0])) for s in served]
    else:
        rows = [pick(s.shape[0], chk.get("sample_rows", s.shape[0]), seed,
                     i, _tag("rows")) for s, i in zip(served, idx)]
    batches = [gen.prompts(records[i]["index"])[r] for i, r in zip(idx, rows)]
    logits = torch.cat([s[r] for s, r in zip(served, rows)])
    toks = torch.cat([t[r] for t, r in zip(tokens, rows)])
    if chk["mode"] == "layers":
        out = layers_numbers(conf, params, batches,
                             [kept.get("chain", {}).get(i, []) for i in idx],
                             logits, toks, prec)
    else:
        out = logits_numbers(conf, params, batches, logits, toks, prec)
    out.update(stage_numbers(conf, wl, params, kept, prec))
    # the end of the chain, exact: each first token of the sampled batches
    # is the argmax of the logits it was served from (the control serves
    # its own argmax)
    out["token_mismatch"] = (0 if prec is not None else sum(
        int((t != s.argmax(dim=-1)).sum()) for t, s in zip(tokens, served)))
    return out


def device_info(device) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


class Window:
    """The window's hooks: which batches the check keeps, what it keeps of
    them (``captures``), and (traced) which batches the profiler sees."""

    def __init__(self, wl: dict, conf: dict, gen, seed: int, traced: bool,
                 patches: trace.Patches, spans=None, prof=None):
        chk = wl["check"]
        self.idx = sample(chk["sample_from"], chk["sample_steps"], seed)
        self.captures = ([Chain(patches)] if chk["mode"] == "layers" else [])
        self.captures += [Stage(st["name"], patches, seed,
                                conf["lm_config"]["n_layers"], st["layers"])
                          for st in chk.get("stages", [])]
        self.kept: Dict[str, Dict[int, list]] = {c.name: {}
                                                 for c in self.captures}
        self.traced, self.spans, self.prof = traced, spans, prof
        self.first = TRACE_SKIP
        self.last = TRACE_SKIP + gen.trace_steps - 1
        self.min_steps = max(chk["sample_from"],
                             self.last + 1 if traced else 1)

    def warm_up(self, gen, step):
        """Set-up's batches (every shape the window uses); in ``layers``
        mode at least one for each batch the check keeps, keeping what
        the check keeps and holding it until the end, so that the
        window's kept batches find their memory reserved."""
        holds = any(isinstance(c, Chain) for c in self.captures)
        held = []
        for n, ids in enumerate(gen.warmup(len(self.idx) if holds else 0)):
            keep = holds and n < len(self.idx)
            for c in self.captures if keep else ():
                c.begin(n)
            step(ids)
            if keep:
                held.append([c.end() for c in self.captures])
        for c in self.captures:
            c.seen = False
        del held

    def before(self, i):
        if self.traced and i == self.first:
            self.prof.start()
            self.spans.active = True
        if i in self.idx:
            for c in self.captures:
                c.begin(i)

    def after(self, i):
        if i in self.idx:
            for c in self.captures:
                self.kept[c.name][i] = c.end()
        if self.traced and i == self.last:
            self.spans.active = False
            self.prof.stop()

    def unseen(self) -> List[str]:
        """The captures whose hook the program never called: the program
        no longer calls what they wrap, and their numbers fail."""
        return [c.name for c in self.captures if not c.seen]


def run_cell(cell: str, seed: int, seconds: float, traced: bool, device,
             t0: float, bench: Optional[dict] = None) -> dict:
    bench = files.manifest() if bench is None else bench
    wl = files.workload(cell)
    conf = files.config(wl["config"])
    mix = files.traffic(wl["traffic"])
    dev = torch.device(device)
    t_build = time.perf_counter()
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.build_all(conf["kernels"])
    t_weights = time.perf_counter()
    session = Session(conf, seed, dev)
    gen = traffic.load(mix, seed, conf["vocab_draw"], dev)
    t_warm = time.perf_counter()
    layer_metrics = files.per_layer_metrics(cell, bench) if traced else []
    readers = {m["name"]: files.load_module("metrics", m["name"])
               for m in layer_metrics}
    patches = trace.Patches()
    spans = trace.Spans([p for r in readers.values() for p in r.SPANS],
                        patches)
    prof = trace.Profile(dev) if traced else None
    win = Window(wl, conf, gen, seed, traced, patches, spans, prof)

    def step(ids):
        if not spans.active:
            return session.step(ids)
        with torch.profiler.record_function(trace.STEP):
            return session.step(ids)

    win.warm_up(gen, step)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s: imports {t_build - t0:.3f}, kernels "
        f"{t_weights - t_build:.3f}, weights {t_warm - t_weights:.3f}, "
        f"warm-up {setup_s - (t_warm - t0):.3f}")

    records = gen.run(step, seconds, min_steps=win.min_steps,
                      before=win.before, after=win.after)
    patches.remove()
    window_s = records[-1]["t_first"] - records[0]["t_dispatch"]
    info = device_info(dev)
    walls = [r["t_first"] - r["t_dispatch"] for r in records]
    slow = max(range(len(walls)), key=walls.__getitem__)
    walls = sorted(walls)
    log(f"window {window_s:.3f} s, {len(records)} batches, step s min "
        f"{walls[0]:.5f} median {walls[len(walls) // 2]:.5f} max "
        f"{walls[-1]:.5f} (batch {slow}); peak "
        f"{info['memory_peak_bytes']} bytes")
    for name in win.unseen():
        log(f"check: the capture {name!r} saw no call of the program; its "
            f"numbers fail")

    result: dict = {"correct": False,
                    "attempted": sum(r["requests"] for r in records),
                    "failed": 0, "metrics": {}, "device": info}
    if traced:
        tw = records[win.last]["t_first"] - records[win.first]["t_dispatch"]
        context = {"lm_config": conf["lm_config"],
                   "shapes": [records[i]["shape"]
                              for i in range(win.first, win.last + 1)],
                   "peaks": peaks.for_kind(info["kind"]),
                   "count": lambda name: files.load_module("counts", name)}
        view = trace.TraceView(prof.events, spans, gen.trace_steps, tw,
                               context)
        info["busy_s"] = view.busy_s
        info["window_s"] = view.window_s
        log(f"trace: busy {view.busy_s:.6f} s of {view.window_s:.6f} s, "
            f"{view.unattributed_s:.6f} s launched outside any range; "
            f"device s by range {dict(view.device_s)}")
        for m in layer_metrics:
            value = readers[m["name"]].read(view)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        result["breakdown"] = view.breakdown()
    else:
        run = {"records": records, "setup_s": setup_s, "window_s": window_s}
        for m in files.end_to_end_metrics(cell, bench):
            value = files.load_module("end_to_end", m["name"]).read(run)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}

    t_check = time.perf_counter()
    for i, r in enumerate(records):   # free what the check does not read
        if i not in win.idx:
            r["out"] = None
    numbers = check_numbers(conf, wl, session.params, gen, records, win.idx,
                            win.kept, seed)
    log(f"check {time.perf_counter() - t_check:.3f} s: {numbers}")
    limits = wl["check"]["limits"]
    result["check"] = {k: {"value": numbers[k], "limit": limits[k]}
                       for k in limits}
    result["correct"] = all(math.isfinite(numbers[k]) and numbers[k] <= lim
                            for k, lim in limits.items())
    return result
