"""Plain float32 reference of a Mamba-2 (SSD) layer.

The semantics the configuration file states, written from the Mamba-2
paper (arXiv:2405.21060) and not from the program:

- RMSNorm of the residual stream, then one input projection split into
  z (d_inner), x (d_inner), B and C (n_groups * d_state each) and dt
  (one a head);
- a depthwise causal convolution of width d_conv over [x, B, C], with
  bias, then SiLU;
- dt = softplus(dt + dt_bias), A = -exp(A_log), and the selective scan
  h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,  y_t = h_t C_t + D x_t,
  computed exactly in its chunked dual form (``ssd``);
- the gated norm RMSNorm(y * silu(z)) (norm after the gate), the output
  projection, and the residual add.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

CHUNK = 256  # the dual form is exact at any chunk; this one bounds memory
CHUNKS_AT_ONCE = 16


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def scan(x, dt, A, Bm, Cm, mode: str = "float32") -> torch.Tensor:
    """``ssd`` in the precision ``mode`` names: ``"float32"`` (IEEE
    products), ``"tf32"`` (its products in TF32) or ``"bfloat16"`` (inputs
    and every step in bf16); float32 out."""
    if mode == "bfloat16":
        x, dt, A, Bm, Cm = (t.bfloat16() for t in (x, dt, A, Bm, Cm))
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
    try:
        return ssd(x, dt, A, Bm, Cm).float()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """The scan's outputs y (B, S, H, P) from a zero state.  x (B, S, H, P),
    dt (B, S, H), A (H,), Bm and Cm (B, S, G, N), head h reading group
    h // (H / G).  Within a chunk, y_i = sum_{j <= i} (C_i . B_j)
    exp(a_j+1 + ... + a_i) dt_j x_j, a = dt A; across chunks the state
    carried in at each chunk's start adds exp(a_1 + ... + a_i) C_i . h."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    pad = (-S) % chunk
    if pad:  # dt = 0 past the end: no input, no decay
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        Bm, Cm = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (Bm, Cm))
    nc = x.shape[1] // chunk
    rep = H // G
    xd = (x * dt[..., None]).reshape(Bsz, nc, chunk, H, P)
    a = (dt * A).reshape(Bsz, nc, chunk, H)
    Bh = Bm.repeat_interleave(rep, dim=2).reshape(Bsz, nc, chunk, H, N)
    Ch = Cm.repeat_interleave(rep, dim=2).reshape(Bsz, nc, chunk, H, N)
    cs = a.cumsum(dim=2)                                    # (B, nc, c, H)
    tril = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    y = torch.empty_like(xd)
    states = torch.empty((Bsz, nc, H, P, N), dtype=x.dtype, device=x.device)
    for z0 in range(0, nc, CHUNKS_AT_ONCE):
        z = slice(z0, min(nc, z0 + CHUNKS_AT_ONCE))
        seg = cs[:, z, :, None, :] - cs[:, z, None, :, :]   # [i, j]
        decay = torch.exp(seg.masked_fill(~tril[:, :, None], -math.inf))
        cb = torch.einsum("bzihn,bzjhn->bzijh", Ch[:, z], Bh[:, z])
        y[:, z] = torch.einsum("bzijh,bzjhp->bzihp", cb * decay, xd[:, z])
        to_end = torch.exp(cs[:, z, -1:, :] - cs[:, z])     # (B, z, c, H)
        states[:, z] = torch.einsum("bzjhn,bzjh,bzjhp->bzhpn", Bh[:, z],
                                    to_end, xd[:, z])
    h = torch.zeros((Bsz, H, P, N), dtype=x.dtype, device=x.device)
    for zi in range(nc):
        y[:, zi] += torch.einsum("bihn,bhpn,bih->bihp", Ch[:, zi], h,
                                 torch.exp(cs[:, zi]))
        h = h * torch.exp(cs[:, zi, -1])[..., None, None] + states[:, zi]
    return y.reshape(Bsz, nc * chunk, H, P)[:, :S]


def layer(lp: Dict[str, torch.Tensor], h: torch.Tensor, conf: dict,
          prec) -> torch.Tensor:
    lc, sem = conf["lm_config"], conf["semantics"]
    mm = prec.mm
    Bsz, S, D = h.shape
    d_inner = lc["ssm_expand"] * D
    P, N, G = lc["ssm_head_dim"], lc["ssm_state"], 1
    H = d_inner // P
    K = sem["d_conv"]
    x = rmsnorm(h, lp["ln1/scale"], sem["norm_eps"])
    z, xs, bc, dt = torch.split(mm(x, lp["ssm/in_proj"]),
                                [d_inner, d_inner, 2 * G * N, H], dim=-1)
    u = torch.cat([xs, bc], dim=-1)                         # (B, S, conv)
    w = lp["ssm/conv_w"]                                    # (K, conv)
    conv = sum(F.pad(u, (0, 0, K - 1 - i, 0))[:, :S] * w[i] for i in range(K))
    u = F.silu(conv + lp["ssm/conv_b"])
    xs, Bm, Cm = torch.split(u, [d_inner, G * N, G * N], dim=-1)
    xs = xs.reshape(Bsz, S, H, P)
    dt = F.softplus(dt + lp["ssm/dt_bias"])
    A = -torch.exp(lp["ssm/a_log"])
    y = scan(xs, dt, A, Bm.reshape(Bsz, S, G, N), Cm.reshape(Bsz, S, G, N),
             prec.scan)
    y = y + lp["ssm/d_skip"][:, None] * xs
    y = y.reshape(Bsz, S, d_inner) * F.silu(z)
    y = rmsnorm(y, lp["ssm/norm/scale"], sem["gated_norm_eps"])
    return h + mm(y, lp["ssm/out_proj"])
