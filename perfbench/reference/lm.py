"""Plain float32 reference of the decoder stack: embedding, the layers of
a block family, final norm, the head at each prompt's last position.

Imports torch alone: nothing of the program, nothing of JAX.  It reads
the weights the benchmark drew (the tree the program is given), upcasts
one layer at a time to float32 and runs every sampled batch through it,
so that it fits beside the served weights.  TF32 is off: every float32
product is IEEE float32.  A ``Precision`` says how the reference
computes: float32 throughout here; each control
(``reference/precision.py``) lowers one part of it.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def float32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


class Precision:
    """``mm``: every weight and attention product; ``router``: the MoE
    router's logits and softmax, ``"float32"`` or ``"bfloat16"``;
    ``scan``: the SSD scan, ``"float32"``, ``"tf32"`` (its products in
    TF32) or ``"bfloat16"`` (all of it).  Where ``routes`` is a list, the
    router appends each call's top-k experts to it."""

    def __init__(self, name: str = "float32", mm: Callable = float32_mm,
                 router: str = "float32", scan: str = "float32",
                 routes: Optional[list] = None):
        self.name, self.mm, self.router, self.scan = name, mm, router, scan
        self.routes = routes


FLOAT32 = Precision()


def lowered(name: str, fields: dict, routes: Optional[list] = None
            ) -> Precision:
    """A ``Precision`` named ``name`` with ``fields`` (a control of
    ``reference/precision.py``) in place of float32's."""
    return Precision(name, routes=routes, **fields)


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def layer_params(params: dict, i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s weights upcast to float32, by their paths below
    ``layers`` (``ln1/scale``, ``moe/router``, ...)."""
    return {k: v[i].float() for k, v in flat_leaves(params["layers"]).items()}


def flat_leaves(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def embed(params: dict, ids: torch.Tensor) -> torch.Tensor:
    return params["embed"][ids].float()


def head_logits(conf: dict, params: dict, h_last: torch.Tensor,
                prec: Precision = FLOAT32) -> torch.Tensor:
    """Final norm and head on last-position hidden states (R, D)."""
    lc = conf["lm_config"]
    head = (params["embed"].T if lc.get("tie_embeddings") else
            params["lm_head"]).float()
    scale = params["final_norm"]["scale"].float()
    return prec.mm(rmsnorm(h_last.float(), scale,
                           conf["semantics"]["norm_eps"]), head)


@torch.no_grad()
def follow(conf: dict, params: dict, chains: List[List[torch.Tensor]],
           family, precs=(FLOAT32,)):
    """The reference layer applied to given inputs: for each layer l and
    each chain (the hidden states (B, S, D) entering every layer of one
    batch), yields (l, chain index, the input in float32, the layer's
    output under each of ``precs``).  One layer's weights are upcast at
    a time."""
    tf32_off()
    layers = flat_leaves(params["layers"])
    for i in range(conf["lm_config"]["n_layers"]):
        lp = {k: v[i].float() for k, v in layers.items()}
        for j, chain in enumerate(chains):
            x = chain[i].float()
            yield i, j, x, [family.layer(lp, x, conf, p) for p in precs]
        del lp


@torch.no_grad()
def last_logits(conf: dict, params: dict, batches: List[torch.Tensor],
                family, prec: Precision = FLOAT32) -> List[torch.Tensor]:
    """Float32 logits (B, V) at the last position of each batch of prompt
    ids (B, S) in ``batches`` (the batches may differ in shape)."""
    tf32_off()
    lc = conf["lm_config"]
    hs = [embed(params, ids) for ids in batches]
    layers = flat_leaves(params["layers"])
    for i in range(lc["n_layers"]):
        lp = {k: v[i].float() for k, v in layers.items()}
        hs = [family.layer(lp, h, conf, prec) for h in hs]
        del lp
    return [head_logits(conf, params, h[:, -1, :], prec) for h in hs]
