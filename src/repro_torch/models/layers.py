"""Core neural layers of the port: what the SSM (Mamba-2) family needs.

The port of ``repro/models/layers.py``'s initializers, RMSNorm and the
Mamba-2 (SSD) block.  Parameters are plain dicts of tensors, as in the
reference; a stack of layers keeps its parameters along a leading layer
axis.  Initializers draw from an explicit ``torch.Generator`` on the
device the parameters live on; they follow the reference's distributions
(held to them statistically by the tests), not its bits.

Compute-dtype policy, as in the reference: matmuls run in the activation
dtype; the conv, the scan, softplus and the norms in float32.  Two
kernels carry the block: ``rmsnorm`` launches B4 (``kernels.ops.rmsnorm``)
and ``ssm_apply`` launches B8 (``kernels.ops.ssd_scan``) where the
reference runs its plain ``ssd_chunked``, which stays here as the
model's plain algorithm and, in float64, the yardstick of B8's
accuracy.  The reference's sharding hint is gone: with no mesh it
returns its input.  Attention, MLP and MoE layers are not ported
yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.backend import resolve_device

Params = Dict[str, Any]

# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def _dense_init(gen: torch.Generator, shape, dtype, in_axis_size=None):
    """Truncated-normal fan-in init (maxtext-style): N(0, 1) cut at +-2,
    times 1 / sqrt(fan_in), drawn in float32 and cast."""
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    std = 1.0 / math.sqrt(max(1, fan_in))
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * std).to(dtype)


def _embed_init(gen: torch.Generator, shape, dtype):
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def init_rmsnorm(dim: int, dtype=torch.float32, device=None) -> Params:
    """Unit scale on ``device`` (default: the CUDA card, as every entry
    point of the port)."""
    return {"scale": torch.ones((dim,), dtype=dtype,
                                device=resolve_device(device))}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` in float32, stored in x's
    dtype: kernel B4 on the card."""
    return ops.rmsnorm(x.contiguous(), params["scale"], eps)


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
