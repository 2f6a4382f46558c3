"""Plain float32 reference of an attention + mixture-of-experts layer.

The semantics the configuration file states (``semantics`` and
``departures``), written from them and not from the program:

- RMSNorm before attention and before the experts, scale only;
- grouped-query attention, causal, softmax scaled by 1/sqrt(d_head), with
  rotary embeddings at theta that rotate the head's two halves, computed
  in blocks of queries so that the scores fit;
- a float32 router (bf16 in the ``router_bf16`` control): softmax over the expert logits, the top k by a stable
  descending sort (ties to the lower expert), weights renormalised to 1;
- capacity ceil(T * k * factor / E) rounded up to a multiple, at least a
  minimum, over the T tokens of the whole batch; each expert's queue is
  filled slot-major (every token's first choice before any second
  choice), tokens in batch order, and a (token, slot) past the capacity
  is dropped;
- SwiGLU experts, the kept slots' outputs summed with their weights.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

SCORES_BYTES = 2 ** 31  # a block of attention scores stays under 2 GiB


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, d): position s rotates the pairs (i, i + d/2) by
    s * theta^(-2i/d)."""
    S, d = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, mm) -> torch.Tensor:
    """q (B, S, H, d), k and v (B, S, KV, d) -> (B, S, H * d)."""
    B, S, H, d = q.shape
    KV = k.shape[2]
    g = H // KV
    qh = q.permute(0, 2, 1, 3).reshape(B, KV, g, S, d) / math.sqrt(d)
    kh = k.permute(0, 2, 1, 3)[:, :, None]          # (B, KV, 1, S, d)
    vh = v.permute(0, 2, 1, 3)[:, :, None]
    blk = max(16, min(S, SCORES_BYTES // (4 * B * H * S)))
    out = torch.empty((B, KV, g, S, d), dtype=torch.float32, device=q.device)
    for s0 in range(0, S, blk):
        s1 = min(S, s0 + blk)
        scores = mm(qh[:, :, :, s0:s1], kh[..., :s1, :].transpose(-1, -2))
        qi = torch.arange(s0, s1, device=q.device)[:, None]
        kj = torch.arange(s1, device=q.device)[None, :]
        scores = scores.masked_fill(kj > qi, -math.inf)
        out[:, :, :, s0:s1] = mm(torch.softmax(scores, dim=-1),
                                 vh[..., :s1, :])
        del scores
    return out.reshape(B, H, S, d).permute(0, 2, 1, 3).reshape(B, S, H * d)


def capacity(n_tokens: int, sem: dict, n_experts: int) -> int:
    cap = math.ceil(n_tokens * sem["top_k"] * sem["capacity_factor"]
                    / n_experts)
    mult = sem["capacity_multiple"]
    return max(sem["capacity_min"], -(-cap // mult) * mult)


def route(x: torch.Tensor, router: torch.Tensor, sem: dict, prec):
    """Top-k experts and renormalised weights of each token of x (T, D),
    and which (token, slot) pairs the capacity keeps."""
    T = x.shape[0]
    E, k = router.shape[1], sem["top_k"]
    if prec.router == "bfloat16":
        probs = torch.softmax(x.bfloat16() @ router.bfloat16(),
                              dim=-1).float()
    else:
        probs = torch.softmax(x @ router, dim=-1)
    w, e = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, e = w[:, :k], e[:, :k]
    if prec.routes is not None:
        prec.routes.append(e)
    w = w / w.sum(dim=-1, keepdim=True)
    cap = capacity(T, sem, E)
    slot_major = e.T.reshape(-1)
    keep = torch.zeros(T * k, dtype=torch.bool, device=x.device)
    for ex in range(E):
        queue = torch.nonzero(slot_major == ex)[:, 0]
        keep[queue[:cap]] = True
    return w, e, keep.reshape(k, T).T


def moe(lp: Dict[str, torch.Tensor], x: torch.Tensor, sem: dict,
        prec) -> torch.Tensor:
    """x (T, D) -> the weighted sum of the kept slots' expert outputs."""
    mm = prec.mm
    w, e, keep = route(x, lp["moe/router"], sem, prec)
    y = torch.zeros_like(x)
    for ex in range(lp["moe/router"].shape[1]):
        tok, slot = torch.nonzero((e == ex) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        h = F.silu(mm(xe, lp["moe/w_gate"][ex])) * mm(xe, lp["moe/w_up"][ex])
        y.index_add_(0, tok, mm(h, lp["moe/w_down"][ex]) * w[tok, slot][:, None])
    return y


def layer(lp: Dict[str, torch.Tensor], h: torch.Tensor, conf: dict,
          prec) -> torch.Tensor:
    lc, sem = conf["lm_config"], conf["semantics"]
    mm = prec.mm
    B, S, D = h.shape
    H, KV, d = lc["n_heads"], lc["n_kv_heads"], lc["d_head"]
    eps, theta = sem["norm_eps"], sem["rope_theta"]
    x = rmsnorm(h, lp["ln1/scale"], eps)
    q = rope(mm(x, lp["attn/wq"]).reshape(B, S, H, d), theta)
    k = rope(mm(x, lp["attn/wk"]).reshape(B, S, KV, d), theta)
    v = mm(x, lp["attn/wv"]).reshape(B, S, KV, d)
    h = h + mm(causal_attention(q, k, v, mm), lp["attn/wo"])
    x = rmsnorm(h, lp["ln2/scale"], eps)
    return h + moe(lp, x.reshape(B * S, D), sem, prec).reshape(B, S, D)
