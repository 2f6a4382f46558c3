"""The SSD scan (kernel B8) of a Mamba-2 model, checked on the program's
own inputs to it.

The configuration states a float32 scan (``ssm_dtype``); a scan in TF32
moves the model's logits by far less than the bf16 model's own rounding
does, so the last-position logits cannot tell it from a sound one.  The
check therefore keeps, in the layers drawn from the seed of each sampled
batch, ``ROWS`` rows and ``HEADS`` heads of the scan's inputs (x, dt, B,
C, as the program derived them; the scan is independent a row and a
head) and of its output y, and the reference scan
(``reference/mamba2.py`` ``scan``, A from the benchmark's own weights)
computes y again from them in float32 with TF32 off.

``scan_err_max``: the largest relative L2 distance ||y - y_ref|| /
||y_ref|| over the kept (row, head) pairs.
"""

from __future__ import annotations

import torch

SPAN = "repro_torch.kernels.ops.ssd_scan"
NUMBERS = ("scan_err_max",)
ROWS, HEADS = 2, 4


def keep(args, kwargs, out, pick) -> dict:
    x, dt, _a, b, c = args[:5]
    y = out[0]
    rows = pick(x.shape[0], ROWS, "rows")
    heads = torch.tensor(pick(x.shape[2], HEADS, "heads"), device=x.device)

    def take(t, by_head):
        return torch.stack([t[r].index_select(1, heads) if by_head
                            else t[r].clone() for r in rows])
    return {"x": take(x, True), "dt": take(dt, True), "b": take(b, False),
            "c": take(c, False), "y": take(y, True), "heads": heads}


def numbers(kept, conf, params, prec, lm, family) -> dict:
    worst = 0.0
    a_log = params["layers"]["ssm"]["a_log"]
    for layer, k in kept:
        A = -torch.exp(a_log[layer].float()[k["heads"]])
        args = (k["x"].float(), k["dt"].float(), A, k["b"].float(),
                k["c"].float())
        lm.tf32_off()
        ref = family.scan(*args, "float32")
        got = k["y"] if prec is None else family.scan(*args, prec.scan)
        d = (got.double() - ref.double()).norm(dim=(1, 3))
        worst = max(worst, float((d / ref.double().norm(dim=(1, 3))).max()))
    return {"scan_err_max": worst}
