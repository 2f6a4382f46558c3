"""Core neural layers of the port.

The port of ``repro/models/layers.py``: the initializers, RMSNorm, rotary
embeddings, GQA attention (qk-norm, per-layer window and theta, a bf16 /
float32 or int8 KV cache), the SwiGLU MLP, the top-k capacity-dropped
MoE and the Mamba-2 (SSD) block.  Parameters are plain dicts of tensors,
as in the reference; a stack of layers keeps its parameters along a
leading layer axis.  Initializers draw from an explicit
``torch.Generator`` on the device the parameters live on; they follow
the reference's distributions (held to them statistically by the
tests), not its bits.

Compute-dtype policy, as in the reference: matmuls run in the activation
dtype; softmax, the router, the conv, the scan, softplus and the norms in
float32.  The kernels carry the layers: ``rmsnorm`` launches B4
(``kernels.ops.rmsnorm``), ``attention`` B6 (``ops.flash_attention``)
for a prefill and B5 (``ops.decode_attention``) against a cache, the
MoE's three expert products B7 (``ops.grouped_matmul``) and ``ssm_apply``
B8 (``ops.ssd_scan``).  The reference computes its own attention and
``ssd_chunked`` instead; ``ssd_chunked`` stays here as the SSD block's
plain algorithm, and ``_blocked_local_attention`` as a port of the
reference's blocked sliding-window attention, which B6 replaces.  The
reference's sharding hints are gone (``dist.ctx.hint`` returns its
input; ``seq_parallel`` moved only hints).  Under a mesh a layer sees
the rank's blocks (``models.model`` gathers the weights); a decode step
against caches sharded over "kv_seq" takes ``dist.splitkv``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.dist import ctx as dctx
from repro_torch.dist.splitkv import splitkv_decode_attention
from repro_torch.kernels import ops
from repro_torch.kernels.backend import resolve_device

Params = Dict[str, Any]

# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


class Abstract:
    """Stands in for the generator where ``models.init_abstract`` builds
    the parameter tree on the ``meta`` device: each draw keeps its shape
    and dtype and draws nothing."""
    device = torch.device("meta")


def _param_device(device) -> torch.device:
    """The device parameters or caches are made on: ``meta`` as given
    (shapes only), any other through ``resolve_device``."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def _dense_init(gen: torch.Generator, shape, dtype, in_axis_size=None):
    """Truncated-normal fan-in init (maxtext-style): N(0, 1) cut at +-2,
    times 1 / sqrt(fan_in), drawn in float32 and cast.  Scaled in place,
    so one float32 slab is alive before the cast (kimi-k2's (384, 7,168,
    2,048) expert slab is 22.5 GB of float32).

    The draw is the inverse CDF of one uniform a value (as
    ``jax.random.truncated_normal``), written out here rather than left
    to ``torch.nn.init.trunc_normal_``, whose algorithm changed between
    torch builds (2.13 redraws out-of-range normals instead): a seed
    gives the same weights on every build."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=gen.device)
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    std = 1.0 / math.sqrt(max(1, fan_in))
    lo, hi = (math.erf(c / math.sqrt(2.0)) for c in (-2.0, 2.0))
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    t.uniform_(lo, hi, generator=gen).erfinv_().mul_(math.sqrt(2.0))
    return t.clamp_(-2.0, 2.0).mul_(std).to(dtype)


def _embed_init(gen: torch.Generator, shape, dtype):
    """N(0, 0.02^2), drawn in float32, scaled in place and cast."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=gen.device)
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device).mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def init_rmsnorm(dim: int, dtype=torch.float32, device=None) -> Params:
    """Unit scale on ``device`` (default: the CUDA card, as every entry
    point of the port)."""
    return {"scale": torch.ones((dim,), dtype=dtype,
                                device=_param_device(device))}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` in float32, stored in x's
    dtype: kernel B4 on the card."""
    return ops.rmsnorm(x.contiguous(), params["scale"], eps)


def rmsnorm_noscale(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Scale-free RMS norm (used for qk-norm when per-head scale is folded)."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(d_head: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, d_head); positions: (..., seq) integers.  The
    head dimension rotates as two halves (not interleaved pairs), in
    float32."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)   # (d_head//2,)
    angles = positions[..., :, None].float() * freqs         # (..., seq, d/2)
    cos = torch.cos(angles)[..., :, None, :]                 # (..., seq, 1, d/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, optional sliding window, optional qk-norm)
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv_heads: int, d_head: int, qk_norm: bool,
                   dtype=torch.float32) -> Params:
    p = {
        "wq": _dense_init(gen, (d_model, n_heads * d_head), dtype),
        "wk": _dense_init(gen, (d_model, n_kv_heads * d_head), dtype),
        "wv": _dense_init(gen, (d_model, n_kv_heads * d_head), dtype),
        "wo": _dense_init(gen, (n_heads * d_head, d_model), dtype,
                          in_axis_size=n_heads * d_head),
    }
    if qk_norm:
        p["q_norm"] = init_rmsnorm(d_head, dtype, gen.device)
        p["k_norm"] = init_rmsnorm(d_head, dtype, gen.device)
    return p


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8 quantization of K/V.
    x: (B, S, KV, dh) -> (int8 values, fp32 scales (B, S, KV))."""
    x32 = x.float()
    scale = torch.clamp_min(x32.abs().amax(dim=-1) / 127.0, 1e-8)
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _attn_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
               window: int) -> torch.Tensor:
    """Boolean (q, k) mask. window: an int; <= 0 means global causal."""
    causal = k_pos[None, :] <= q_pos[:, None]
    if window <= 0:
        return causal
    return causal & ((q_pos[:, None] - k_pos[None, :]) < window)


def _blocked_local_attention(q, k, v, window: int, block: int, scale: float):
    """Sliding-window attention computed over (block, 2*block) tiles: each
    query block attends to itself + the previous block, masked to the exact
    window.  Requires S % block == 0 and window <= block.  q/k/v:
    (B, S, H, d) with KV pre-repeated."""
    B, S, H, d = q.shape
    nb = S // block
    qb = q.reshape(B, nb, block, H, d)
    kb = k.reshape(B, nb, block, H, d)
    vb = v.reshape(B, nb, block, H, d)

    def prev(t):   # block n-1 beside block n, zeros before the first
        return torch.cat([torch.zeros_like(t[:, :1]), t[:, :-1]], dim=1)

    k2 = torch.cat([prev(kb), kb], dim=2)                  # (B,nb,2b,H,d)
    v2 = torch.cat([prev(vb), vb], dim=2)
    scores = torch.einsum("bnqhd,bnkhd->bnhqk", qb.float(),
                          k2.float()) * scale
    q_pos = torch.arange(block, device=q.device)[:, None]  # within-block
    k_pos = torch.arange(2 * block, device=q.device)[None, :] - block
    dist = q_pos - k_pos
    mask = (dist >= 0) & (dist < max(window, 1))
    # first block has no predecessor: mask the padded half
    first = (torch.arange(nb, device=q.device) == 0)[None, :, None, None, None]
    pad_mask = (k_pos >= 0)[None, None, None, :, :] | ~first
    allowed = mask[None, None, None] & pad_mask
    probs = torch.softmax(torch.where(allowed, scores, -1e30),
                          dim=-1).to(q.dtype)
    out = torch.einsum("bnhqk,bnkhd->bnqhd", probs, v2)
    return out.reshape(B, S, H, d)


def _write_cache(cache: torch.Tensor, start: torch.Tensor,
                 new: torch.Tensor) -> None:
    """``cache[:, start:start + S] = new`` in place, with
    ``lax.dynamic_update_slice``'s clamp: a start past ``K - S`` writes the
    last S slots.  ``start`` stays on the device (no host read)."""
    S, K = new.shape[1], cache.shape[1]
    first = torch.clamp(start.long(), 0, K - S)
    idx = first + torch.arange(S, device=cache.device)
    cache.index_copy_(1, idx, new.to(cache.dtype))


def attention(params: Params, x: torch.Tensor, *, n_heads: int,
              n_kv_heads: int, d_head: int, theta: float, window: int = 0,
              qk_norm: bool = False, eps: float = 1e-6,
              kv_cache: Optional[Tuple[torch.Tensor, ...]] = None,
              cache_len: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Optional[Tuple]]:
    """Multi-head GQA attention.

    x: (B, S, D).  Without a cache (prefill) the queries sit at positions
    0..S-1 and attention runs on B6 (``ops.flash_attention``, K/V repeated
    to the query heads in ``jnp.repeat``'s order, ``window`` passed
    through).  With ``kv_cache`` (decode): (k_cache, v_cache) of shape
    (B, max_seq, n_kv, d_head), or int8 values with their float32
    (B, max_seq, n_kv) scales (k_cache, v_cache, k_scale, v_scale).  The
    new K/V are written into those tensors IN PLACE at ``cache_len`` (a
    0-d integer tensor, read on the device), and each new query s runs on
    B5 (``ops.decode_attention``) with length ``cache_len + s + 1`` and
    the layer's window: the reference's mask with ``valid``.  A cache of
    another dtype than x (int8 dequantised, or bf16 under a float32
    model) is cast to x's dtype first, as the reference casts it.  B6
    applies the window itself, so the reference's ``local_block`` (its
    blocked O(S*W) route, ``_blocked_local_attention``, the same
    function) has no counterpart here.  Returns (out, the caches given,
    now updated)."""
    B, S, D = x.shape
    cdt = x.dtype
    q = (x @ params["wq"].to(cdt)).reshape(B, S, n_heads, d_head)
    k = (x @ params["wk"].to(cdt)).reshape(B, S, n_kv_heads, d_head)
    v = (x @ params["wv"].to(cdt)).reshape(B, S, n_kv_heads, d_head)
    if qk_norm:
        q = rmsnorm(params["q_norm"], q, eps)
        k = rmsnorm(params["k_norm"], k, eps)

    offsets = torch.arange(S, dtype=torch.int32, device=x.device)
    positions = (offsets if kv_cache is None else cache_len + offsets)[None, :]
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)

    if kv_cache is None:
        group = n_heads // n_kv_heads
        kr = torch.repeat_interleave(k, group, dim=2) if group > 1 else k
        vr = torch.repeat_interleave(v, group, dim=2) if group > 1 else v
        out = ops.flash_attention(q, kr, vr, causal=True, window=window)
    else:
        start = cache_len.reshape(())
        mesh = dctx.current_mesh()
        n_seq = dctx.axis_size("kv_seq")
        if mesh is not None and n_seq > 1 and S == 1:
            # split-KV (flash-decode): the caches are the rank's blocks of
            # the caches sharded over "kv_seq" (decode_state_shardings), so
            # the reference's max_seq % n_seq == 0 holds by construction;
            # local write + partial softmax, pmax / psum log-sum-exp merge
            # (dist.splitkv)
            seq_axis = dctx.get_rule("kv_seq")
            if len(kv_cache) == 4:
                (kq, ks_new), (vq, vs_new) = quantize_kv(k), quantize_kv(v)
                out, caches = splitkv_decode_attention(
                    q, kq, vq, kv_cache[0], kv_cache[1], start, window,
                    mesh=mesh, seq_axis=seq_axis,
                    k_scale=kv_cache[2], v_scale=kv_cache[3],
                    new_scales=(ks_new, vs_new))
            else:
                out, caches = splitkv_decode_attention(
                    q, k, v, kv_cache[0], kv_cache[1], start, window,
                    mesh=mesh, seq_axis=seq_axis)
            out = out.reshape(B, S, n_heads * d_head)
            return out @ params["wo"].to(cdt), caches
        if len(kv_cache) == 4:
            k_cache, v_cache, k_scale, v_scale = kv_cache
            for cache, scales, new in ((k_cache, k_scale, k),
                                       (v_cache, v_scale, v)):
                values, sc = quantize_kv(new)
                _write_cache(cache, start, values)
                _write_cache(scales, start, sc)
            k_all = (k_cache.float() * k_scale[..., None]).to(cdt)
            v_all = (v_cache.float() * v_scale[..., None]).to(cdt)
        else:
            k_cache, v_cache = kv_cache
            _write_cache(k_cache, start, k)
            _write_cache(v_cache, start, v)
            k_all, v_all = k_cache.to(cdt), v_cache.to(cdt)
        out = torch.stack([ops.decode_attention(
            q[:, s].contiguous(), k_all, v_all, start + (s + 1), window)
            for s in range(S)], dim=1)
    out = out.reshape(B, S, n_heads * d_head)
    return out @ params["wo"].to(cdt), kv_cache


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             dtype=torch.float32) -> Params:
    return {
        "w_gate": _dense_init(gen, (d_model, d_ff), dtype),
        "w_up": _dense_init(gen, (d_model, d_ff), dtype),
        "w_down": _dense_init(gen, (d_ff, d_model), dtype, in_axis_size=d_ff),
    }


def mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU; the products are ``torch.matmul`` in x's dtype, as the
    reference computes them outside any Pallas kernel."""
    cdt = x.dtype
    g = x @ params["w_gate"].to(cdt)
    u = x @ params["w_up"].to(cdt)
    return (F.silu(g) * u) @ params["w_down"].to(cdt)


# ---------------------------------------------------------------------------
# Mixture of Experts (top-k, capacity-dropped, sort-free scatter dispatch)
# ---------------------------------------------------------------------------


def init_moe(gen: torch.Generator, d_model: int, n_experts: int, d_ff: int,
             n_shared: int = 0, dtype=torch.float32) -> Params:
    # the fan-in as the reference takes it: the leading (expert) axis of
    # the gate and up slabs
    p = {
        "router": _dense_init(gen, (d_model, n_experts), torch.float32),
        "w_gate": _dense_init(gen, (n_experts, d_model, d_ff), dtype),
        "w_up": _dense_init(gen, (n_experts, d_model, d_ff), dtype),
        "w_down": _dense_init(gen, (n_experts, d_ff, d_model), dtype,
                              in_axis_size=d_ff),
    }
    if n_shared:
        p["shared"] = init_mlp(gen, d_model, n_shared * d_ff, dtype)
    return p


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``F.one_hot`` without its host read of the largest index."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def moe_routing(router_w: torch.Tensor, x: torch.Tensor, top_k: int):
    """Router in fp32. x: (T, D). Returns (weights (T,k), experts (T,k),
    aux_loss).  Ties go to the lower expert index, as ``lax.top_k``
    breaks them: a stable descending sort (``torch.topk`` promises no
    order among equal values)."""
    logits = x.float() @ router_w.float()                       # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :top_k], top_e[:, :top_k]
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    # Switch-style load-balancing aux loss
    n_experts = router_w.shape[1]
    me = probs.mean(dim=0)                                      # (E,)
    ce = _one_hot(top_e[:, 0], n_experts, torch.float32).mean(dim=0)
    aux = n_experts * torch.sum(me * ce)
    return top_w, top_e, aux


def _expert_positions(top_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Position of each (token, slot) within its expert queue, counted jointly
    across slots in (slot-major, token) order.  top_e: (T, k) -> pos (T, k)."""
    T, k = top_e.shape
    flat = top_e.T.reshape(-1)             # slot-major: all slot-0 tokens first
    onehot = _one_hot(flat, n_experts, torch.int32)             # (T*k, E)
    pos_flat = torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1
    pos = pos_flat.gather(1, flat[:, None])[:, 0]
    return pos.reshape(k, T).T


def _expert_positions_big(top_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Sort-based variant that avoids the (T*k, E) one-hot (for big E):
    a stable argsort, so each queue keeps (slot-major, token) order."""
    T, k = top_e.shape
    flat = top_e.T.reshape(-1)
    tk = flat.shape[0]
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros((n_experts,), dtype=torch.int32, device=flat.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    starts = torch.cumsum(counts, dim=0, dtype=torch.int32) - counts  # (E,)
    pos_sorted = (torch.arange(tk, dtype=torch.int32, device=flat.device)
                  - starts[flat[order]])
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    return pos.reshape(k, T).T


def moe_apply_local(params: Params, x: torch.Tensor, *, top_k: int,
                    capacity: int, n_experts: int, expert_start: int = 0,
                    n_local_experts: Optional[int] = None,
                    big_e_threshold: int = 64
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply a (possibly expert-sharded) MoE to local tokens.

    x: (T, D) local tokens.  params hold only the local expert slab
    [expert_start, expert_start+n_local).  Returns (partial y (T, D), aux
    loss); with experts sharded the caller sums y over the shards.  The
    three expert products run on B7 (``ops.grouped_matmul``: a float32
    accumulator stored in x's dtype, as the reference's einsums with
    ``preferred_element_type=float32`` and a cast)."""
    T, D = x.shape
    cdt = x.dtype
    n_local = n_local_experts if n_local_experts is not None else n_experts
    top_w, top_e, aux = moe_routing(params["router"], x, top_k)

    if n_experts >= big_e_threshold:
        pos = _expert_positions_big(top_e, n_experts)
    else:
        pos = _expert_positions(top_e, n_experts)

    # each slot's row in the per-expert queues; a dropped slot (another
    # shard's expert, or past capacity) goes to the trash row
    trash = n_local * capacity
    slots = []
    for s in range(top_k):
        e = top_e[:, s] - expert_start
        ok = (e >= 0) & (e < n_local) & (pos[:, s] < capacity)
        dst = torch.where(ok, e * capacity
                          + torch.clamp(pos[:, s], max=capacity - 1), trash)
        slots.append((ok, dst))

    # Scatter tokens into per-expert queues: xe (n_local * capacity, D)
    xe = torch.zeros((trash + 1, D), dtype=cdt, device=x.device)
    for ok, dst in slots:
        xe.index_add_(0, dst, torch.where(ok[:, None], x, 0))
    xe = xe[:trash].reshape(n_local, capacity, D)

    # Expert GEMMs (grouped): (E_l, C, D) x (E_l, D, F)
    g = ops.grouped_matmul(xe, params["w_gate"].to(cdt))
    u = ops.grouped_matmul(xe, params["w_up"].to(cdt))
    ye = ops.grouped_matmul(F.silu(g) * u, params["w_down"].to(cdt))
    ye = torch.cat([ye.reshape(trash, D),
                    torch.zeros((1, D), dtype=cdt, device=x.device)])

    # Combine: gather each slot's expert output back to its token, slot
    # by slot
    y = torch.zeros((T, D), dtype=cdt, device=x.device)
    for s, (ok, dst) in enumerate(slots):
        w = torch.where(ok, top_w[:, s], 0.0).to(cdt)
        y = y + ye[dst] * w[:, None]

    if "shared" in params:
        y = y + mlp(params["shared"], x)
    return y, aux


# ---------------------------------------------------------------------------
# Mamba-2 (SSD) block
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SSMDims:
    d_model: int
    d_inner: int
    n_heads: int
    head_dim: int
    d_state: int
    n_groups: int = 1
    d_conv: int = 4
    chunk: int = 64


def ssm_dims(d_model: int, d_state: int, head_dim: int = 64, expand: int = 2,
             chunk: int = 64) -> SSMDims:
    d_inner = expand * d_model
    return SSMDims(d_model=d_model, d_inner=d_inner, n_heads=d_inner // head_dim,
                   head_dim=head_dim, d_state=d_state, chunk=chunk)


def a_log_init(n_heads: int) -> np.ndarray:
    """``log(linspace(1, 16, n_heads))`` as float32, computed in float64
    on the host and rounded once.  The reference's float32 ``jnp.linspace``
    and ``jnp.log`` round differently (XLA folds them at compile time), so
    a few entries differ from it by one unit in the last place."""
    return np.log(np.linspace(1.0, 16.0, n_heads)).astype(np.float32)


def init_ssm(gen: torch.Generator, dims: SSMDims, dtype=torch.float32) -> Params:
    dev = gen.device
    conv_dim = dims.d_inner + 2 * dims.n_groups * dims.d_state
    d_in_proj = 2 * dims.d_inner + 2 * dims.n_groups * dims.d_state + dims.n_heads
    in_proj = _dense_init(gen, (dims.d_model, d_in_proj), dtype)
    conv_w = _dense_init(gen, (dims.d_conv, conv_dim), dtype,
                         in_axis_size=dims.d_conv)
    u = torch.empty((dims.n_heads,), dtype=torch.float32, device=dev)
    if dev.type != "meta":
        u.uniform_(math.log(1e-3), math.log(1e-1), generator=gen)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "a_log": torch.from_numpy(a_log_init(dims.n_heads)).to(dev),
        "dt_bias": torch.log(torch.expm1(torch.exp(u))),
        "d_skip": torch.ones((dims.n_heads,), dtype=torch.float32, device=dev),
        "norm": init_rmsnorm(dims.d_inner, dtype, dev),
        "out_proj": _dense_init(gen, (dims.d_inner, dims.d_model), dtype,
                                in_axis_size=dims.d_inner),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable 'segment sum' producing L[i, j] = sum_{j < m <= i} x[m] (i >= j).
    x: (..., c) -> (..., c, c) with -inf above the diagonal."""
    c = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, -math.inf)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.float32
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD (state-space dual) exact chunked scan, the model's plain
    algorithm in four stages (the Mamba-2 ``ssd_minimal_discrete``, with
    ``X <- dt*x`` and ``A <- dt*a`` discretization done here).

    x: (B, S, H, P); dt: (B, S, H) (already softplus'd, >0); a: (H,) (negative);
    b, c: (B, S, G, N).  Returns (y (B,S,H,P), final_state (B,H,P,N)),
    computed and returned in ``dtype``: float32 as in the reference;
    float64 is the evaluation that B8 is held to for accuracy.
    """
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if S % chunk:
        raise ValueError(f"ssd_chunked: S={S} must be a multiple of "
                         f"chunk={chunk}")
    nc = S // chunk
    rep = H // G

    def to_heads(t):  # (B,S,G,N) -> (B,nc,c,H,N)
        th = torch.repeat_interleave(t, rep, dim=2) if rep != 1 else t
        return th.reshape(B, nc, chunk, H, N).to(dtype)

    xw = (x.to(dtype) * dt.to(dtype)[..., None]).reshape(B, nc, chunk, H, P)
    bb = to_heads(b)
    cb = to_heads(c)
    da = (dt.to(dtype) * a.to(dtype)[None, None, :]).reshape(B, nc, chunk, H)
    da_h = da.permute(0, 1, 3, 2)                          # (B,nc,H,c)
    da_cs = torch.cumsum(da_h, dim=-1)                     # (B,nc,H,c)

    # --- 1. intra-chunk (diagonal blocks) ---
    L = torch.exp(_segsum(da_h))                           # (B,nc,H,c,c)
    y_diag = torch.einsum("bzihn,bzjhn,bzhij,bzjhp->bzihp",
                          cb, bb, L, xw)                   # (B,nc,c,H,P)

    # --- 2. state contributed by each chunk ---
    decay_states = torch.exp(da_cs[..., -1:] - da_cs)      # (B,nc,H,c)
    states = torch.einsum("bzchn,bzhc,bzchp->bzhpn", bb, decay_states, xw)

    # --- 3. inter-chunk recurrence ---
    chunk_decay = torch.exp(da_cs[..., -1])                # (B,nc,H)
    carry = torch.zeros((B, H, P, N), dtype=dtype, device=x.device) \
        if init_state is None else init_state.to(dtype)
    prev = []
    for z in range(nc):                                    # emit the state
        prev.append(carry)                                 # entering chunk z
        carry = carry * chunk_decay[:, z, :, None, None] + states[:, z]
    prev_states = torch.stack(prev, dim=1)                 # (B,nc,H,P,N)

    # --- 4. contribution of previous chunks' state ---
    state_decay = torch.exp(da_cs)                         # (B,nc,H,c)
    y_off = torch.einsum("bzchn,bzhpn,bzhc->bzchp", cb, prev_states,
                         state_decay)

    y = (y_diag + y_off).reshape(B, S, H, P)
    return y, carry


def _split(zxbcdt: torch.Tensor, d: SSMDims):
    gn = d.n_groups * d.d_state
    return torch.split(zxbcdt, [d.d_inner, d.d_inner, 2 * gn, d.n_heads],
                       dim=-1)


def ssm_step(params: Params, dims: SSMDims, x_t: torch.Tensor,
             conv_state: torch.Tensor, ssm_state: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token recurrent step (decode).  x_t: (B, D).
    conv_state: (B, d_conv-1, conv_dim); ssm_state: (B, H, P, N)."""
    B, D = x_t.shape
    d = dims
    cdt = x_t.dtype
    zxbcdt = x_t @ params["in_proj"].to(cdt)
    z, xin, bc, dt = _split(zxbcdt, d)
    conv_in = torch.cat([xin, bc], dim=-1)                 # (B, conv_dim)
    # causal conv over the rolling window
    window = torch.cat([conv_state, conv_in[:, None, :]], dim=1)  # (B,dc,cd)
    # the reference's einsums, written out: torch.einsum would search a
    # contraction path on the host at every call of the decode loop
    conv_out = (window.float() * params["conv_w"].float()).sum(dim=1)
    conv_out = F.silu(conv_out + params["conv_b"].float())
    new_conv_state = window[:, 1:, :]

    xc = conv_out[:, :d.d_inner].reshape(B, d.n_heads, d.head_dim)
    bcx = conv_out[:, d.d_inner:]
    gn = d.n_groups * d.d_state
    b_t = bcx[:, :gn].reshape(B, d.n_groups, d.d_state)
    c_t = bcx[:, gn:].reshape(B, d.n_groups, d.d_state)
    rep = d.n_heads // d.n_groups
    b_h = torch.repeat_interleave(b_t, rep, dim=1)         # (B,H,N)
    c_h = torch.repeat_interleave(c_t, rep, dim=1)

    dt_t = F.softplus(dt.float() + params["dt_bias"])     # (B,H)
    a = -torch.exp(params["a_log"])                        # (H,)
    decay = torch.exp(dt_t * a[None, :])                   # (B,H)
    upd = (dt_t[..., None] * xc.float())[..., None] * b_h[:, :, None, :]
    new_ssm_state = ssm_state * decay[..., None, None] + upd
    y = (new_ssm_state @ c_h[..., None])[..., 0]          # (B,H,P)
    y = y + params["d_skip"][None, :, None] * xc.float()
    y = y.reshape(B, d.d_inner).to(cdt)
    y = rmsnorm(params["norm"], y * F.silu(z))
    return y @ params["out_proj"].to(cdt), new_conv_state, new_ssm_state


def ssm_apply(params: Params, dims: SSMDims, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence SSD pass (train / prefill).  x: (B, S, D)."""
    B, S, D = x.shape
    d = dims
    cdt = x.dtype
    zxbcdt = x @ params["in_proj"].to(cdt)                 # (B,S,*)
    z, xin, bc, dt = _split(zxbcdt, d)
    conv_in = torch.cat([xin, bc], dim=-1)                 # (B,S,conv_dim)
    # depthwise causal conv, kernel d_conv, summed in the reference's order
    pad = F.pad(conv_in, (0, 0, d.d_conv - 1, 0))
    conv_w = params["conv_w"].float()
    conv_out = sum(pad[:, i:i + S, :].float() * conv_w[i]
                   for i in range(d.d_conv))
    conv_out = F.silu(conv_out + params["conv_b"].float()).to(cdt)

    xc = conv_out[..., :d.d_inner].reshape(B, S, d.n_heads, d.head_dim)
    bcx = conv_out[..., d.d_inner:]
    gn = d.n_groups * d.d_state
    b = bcx[..., :gn].reshape(B, S, d.n_groups, d.d_state)
    c = bcx[..., gn:].reshape(B, S, d.n_groups, d.d_state)
    dt_v = F.softplus(dt.float() + params["dt_bias"])     # (B,S,H)
    a = -torch.exp(params["a_log"])

    # ssd_chunked's own first step: x, b and c in float32, so that y comes
    # back in float32 (B8 stores y in x's dtype); the final state is
    # dropped, as the reference's prefill drops it
    xc32 = xc.float()
    y, _ = ops.ssd_scan(xc32, dt_v, a, b.float(), c.float(), chunk=d.chunk)
    y = y + params["d_skip"][None, None, :, None] * xc32
    y = y.reshape(B, S, d.d_inner).to(cdt)
    y = rmsnorm(params["norm"], y * F.silu(z))
    return y @ params["out_proj"].to(cdt)
