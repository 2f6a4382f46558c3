"""The MoE layer's routing, checked on the program's own input to it.

The configuration states a float32 router (``router_dtype``).  A router
in bf16 flips the top-2 of a token about as often as the bf16 rounding of
its input already does, so the layer-by-layer numbers cannot tell it
from a sound one.  On the same input the flips are the router's alone:
the check keeps, in the layers drawn from the seed of each sampled
batch, the input x (T, D) the program gave ``moe_apply_local`` and its
output y, and the reference MoE (``reference/attn_moe.py`` ``moe``, float32,
TF32 off) computes y again from x, routing and capacity drops included.

``moe_off_share``: the largest share, over the kept layers and batches,
of tokens whose output lies more than ``OFF`` (relative L2) from the
reference's: a token with another expert, or dropped on one side only.
A kept token's bf16 experts alone put it about 1% off.
"""

from __future__ import annotations

import torch

SPAN = "repro_torch.models.layers.moe_apply_local"
NUMBERS = ("moe_off_share",)
OFF = 0.25


def keep(args, kwargs, out, pick) -> dict:
    return {"x": args[1], "y": out[0]}


def numbers(kept, conf, params, prec, lm, family) -> dict:
    worst = 0.0
    sem = conf["semantics"]
    for layer, k in kept:
        lp = lm.layer_params(params, layer)
        x = k["x"].float()
        lm.tf32_off()
        ref = family.moe(lp, x, sem, lm.FLOAT32).double()
        got = (k["y"] if prec is None else family.moe(lp, x, sem, prec))
        d = (got.double() - ref).norm(dim=-1)
        r = ref.norm(dim=-1)
        off = torch.where(r > 0, d > OFF * r, d > 0)
        worst = max(worst, float(off.double().mean()))
        del lp
    return {"moe_off_share": worst}
