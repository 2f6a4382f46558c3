"""Plain PyTorch versions of the model kernels B4-B7.

Each computes what ``repro.kernels.ops`` computes, the Pallas kernel's
contract and not only the reference oracle's: float32 arithmetic, output
in the input's dtype, the attention masks with the kernels' finite
``NEG_INF`` and the ``max(l, 1e-30)`` denominator, so that decode
attention with ``length == 0`` gives zeros (the reference's
``ref_decode_attention`` gives NaN there).  The wrappers take these for
CPU tensors, and ``chip_smoke.py`` holds each CUDA kernel against them on
the card.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def ref_rmsnorm(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """``(x * rsqrt(mean(x^2) + eps)) * scale`` over the last axis."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _softmax_pv(s: torch.Tensor, valid: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
    """``softmax(s) @ v`` over the allowed keys, as the kernels finish it:
    masked scores at ``NEG_INF``, masked weights 0, ``l`` clamped."""
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return (p @ v) / denom


def ref_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """q, k, v: (B, S, H, d), KV already repeated to H heads.  ``window``
    0 = global, > 0 = keys with ``q_pos - k_pos < window``."""
    S, d = q.shape[1], q.shape[3]
    scale = 1.0 / math.sqrt(d)
    qt = q.float().transpose(1, 2) * scale            # (B, H, S, d)
    kt = k.float().transpose(1, 2)
    vt = v.float().transpose(1, 2)
    pos = torch.arange(S, device=q.device)
    q_pos, k_pos = pos[:, None], pos[None, :]
    valid = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        valid = k_pos <= q_pos
    if window > 0:
        valid = valid & ((q_pos - k_pos) < window)
    out = _softmax_pv(qt @ kt.transpose(-1, -2), valid, vt)
    return out.transpose(1, 2).to(q.dtype)


def ref_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, length,
                         window=0) -> torch.Tensor:
    """q: (B, H, d); caches: (B, K, KV, d).  Position p counts when
    ``p < length`` and (``window <= 0`` or ``length - 1 - p < window``);
    ``length`` and ``window`` are ints or 0-d integer tensors."""
    B, H, d = q.shape
    K, KV = k_cache.shape[1], k_cache.shape[2]
    g = H // KV
    scale = 1.0 / math.sqrt(d)
    length = torch.as_tensor(length, device=q.device)
    window = torch.as_tensor(window, device=q.device)
    qg = q.float().reshape(B, KV, g, d) * scale
    kt = k_cache.float().permute(0, 2, 3, 1)           # (B, KV, d, K)
    vt = v_cache.float().transpose(1, 2)               # (B, KV, K, d)
    k_pos = torch.arange(K, device=q.device)
    valid = (k_pos < length) & ((window <= 0)
                                | ((length - 1 - k_pos) < window))
    out = _softmax_pv(qg @ kt, valid, vt)
    return out.reshape(B, H, d).to(q.dtype)


def ref_grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-expert product: x (E, C, D) @ w (E, D, F) -> (E, C, F), in
    float32, stored in x's dtype."""
    return torch.bmm(x.float(), w.float()).to(x.dtype)
