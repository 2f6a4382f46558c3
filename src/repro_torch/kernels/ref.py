"""Plain PyTorch versions of the model kernels B4-B8.

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
from typing import Optional, Tuple

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


def ref_ssd_chunk(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor,
                  init_state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-chunk SSD: the intra-chunk + state update computed by one grid
    step of the Pallas kernel.  x: (B, c, H, P); dt: (B, c, H); a: (H,);
    b, c: (B, c, H, N) (already head-expanded);
    init_state: (B, H, P, N).  Returns (y (B,c,H,P), out_state (B,H,P,N))."""
    L = x.shape[1]
    x32 = x.float() * dt.float()[..., None]
    da = dt.float() * a.float()      # (B, c, H)
    da_h = da.transpose(1, 2)        # (B, H, c)
    cs = torch.cumsum(da_h, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    tril = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    # masked before the exp, as the model's segsum does: above the
    # diagonal diff grows with the decay and its exp overflows, and
    # where(tril, exp(diff), 0) would give 0 * inf = NaN gradients
    L_mat = torch.exp(torch.where(tril, diff, -math.inf))
    y = torch.einsum("bihn,bjhn,bhij,bjhp->bihp",
                     c.float(), b.float(), L_mat, x32)
    if init_state is not None:
        state_decay = torch.exp(cs)  # (B,H,c)
        y = y + torch.einsum("bchn,bhpn,bhc->bchp",
                             c.float(), init_state.float(), state_decay)
    decay_states = torch.exp(cs[..., -1:] - cs)
    new_state = torch.einsum("bchn,bhc,bchp->bhpn",
                             b.float(), decay_states, x32)
    if init_state is not None:
        new_state = new_state + init_state.float() * \
            torch.exp(cs[..., -1])[..., None, None]
    return y.to(x.dtype), new_state


def ref_ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor,
                 chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Pallas kernel's grid, step by step: ``ref_ssd_chunk`` over each
    chunk of ``chunk`` positions, carrying the float32 state from one to
    the next.  x: (B, S, H, P); dt: (B, S, H); a: (H,); b, c: (B, S, G, N)
    with ``H % G == 0`` (group ``h // (H // G)`` serves head h);
    ``S % chunk == 0``.  Returns y (B, S, H, P) in x's dtype and the final
    state (B, H, P, N) in float32.  y is computed in float32 and rounded
    once, as the kernel stores it."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    rep = H // b.shape[2]
    if rep != 1:
        b = torch.repeat_interleave(b, rep, dim=2)
        c = torch.repeat_interleave(c, rep, dim=2)
    x32 = x.float()
    state = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for s0 in range(0, S, chunk):
        sl = slice(s0, s0 + chunk)
        y, state = ref_ssd_chunk(x32[:, sl], dt[:, sl], a, b[:, sl],
                                 c[:, sl], state)
        ys.append(y)
    y = torch.cat(ys, dim=1) if ys else x32.new_zeros((B, 0, H, P))
    return y.to(x.dtype), state
