"""Split-KV (flash-decode) attention over a sequence-sharded KV cache
(port of ``repro/dist/splitkv.py``).

The KV cache's sequence dimension is sharded over a mesh axis; each rank
writes the new token into its local block (if it owns the slot),
computes a *partial* softmax over its local keys, and the partials are
merged with a pmax/psum log-sum-exp reduction — numerically the
attention over the full cache.  The rank-local partial is plain PyTorch,
as the reference's is ``jnp``: no kernel runs here (on one card this
branch never has more than one rank).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.dist import smap


def _write_local(cache: torch.Tensor, new: torch.Tensor, start: torch.Tensor,
                 offset: int, l_local: int) -> None:
    """Write ``new`` (global position ``start``) into the local cache
    block covering [offset, offset + l_local), IN PLACE; a rank that does
    not own the slot keeps its block."""
    pos = start.long() - offset
    in_range = (pos >= 0) & (pos < l_local)
    idx = torch.clamp(pos, 0, l_local - 1).reshape(1)
    old = cache.index_select(1, idx)
    cache.index_copy_(1, idx, torch.where(in_range, new.to(cache.dtype), old))


def splitkv_decode_attention(q, k_new, v_new, k_cache, v_cache, start, window,
                             *, mesh, seq_axis: str,
                             k_scale: Optional[torch.Tensor] = None,
                             v_scale: Optional[torch.Tensor] = None,
                             new_scales: Optional[Tuple] = None):
    """One decode step against a sequence-sharded KV cache, on the rank's
    blocks.

    q: (B_l, 1, n_heads, d_head); k_new/v_new: (B_l, 1, n_kv, d_head)
    (already quantized when scales are given); k_cache/v_cache: the
    rank's block (B_l, max_seq / n_seq, n_kv, d_head) of the caches
    sharded over ``seq_axis`` on dim 1 (the batch blocks are the caller's:
    no collective runs over the batch).  The caches (and scales) are
    written in place.
    Returns (out (B_l, 1, n_heads, d_head), the caches given)."""
    quant = k_scale is not None
    B, _, n_heads, d_head = q.shape
    n_kv = k_cache.shape[2]
    group = n_heads // n_kv
    out_dtype = q.dtype
    l_local = k_cache.shape[1]
    offset = smap.axis_index(seq_axis, mesh) * l_local
    start = start.reshape(())
    _write_local(k_cache, k_new, start, offset, l_local)
    _write_local(v_cache, v_new, start, offset, l_local)
    if quant:
        ks_new, vs_new = new_scales
        _write_local(k_scale, ks_new, start, offset, l_local)
        _write_local(v_scale, vs_new, start, offset, l_local)
        k_all = k_cache.float() * k_scale[..., None]
        v_all = v_cache.float() * v_scale[..., None]
    else:
        k_all = k_cache.float()
        v_all = v_cache.float()

    k_pos = offset + torch.arange(l_local, dtype=torch.int32,
                                  device=q.device)
    valid = k_pos <= start
    if int(window) > 0:
        valid = valid & (k_pos > start - int(window))

    qg = q.float().reshape(B, 1, n_kv, group, d_head)
    # (B, n_kv, group, 1, l_local) partial scores
    s = torch.einsum("bsngh,bknh->bngsk", qg, k_all)
    s = s / math.sqrt(d_head)
    s = torch.where(valid, s, torch.full((), -1e30, device=q.device))
    m_loc = torch.amax(s, dim=-1)
    m = smap.pmax(m_loc, seq_axis, mesh)
    p = torch.exp(s - m[..., None])
    p = torch.where(valid, p, torch.zeros((), device=q.device))
    l_sum = smap.psum(torch.sum(p, dim=-1), seq_axis, mesh)
    o = torch.einsum("bngsk,bknh->bsngh", p, v_all)
    o = smap.psum(o, seq_axis, mesh)
    o = o / torch.clamp(l_sum, min=1e-30).permute(0, 3, 1, 2)[..., None]
    caches = ((k_cache, v_cache, k_scale, v_scale) if quant
              else (k_cache, v_cache))
    return o.reshape(B, 1, n_heads, d_head).to(out_dtype), caches
