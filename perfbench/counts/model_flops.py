"""The model's operations for one prefill step, counted from the
configuration (``lm_config``) and the step's batch and length alone.

- 2 operations (a multiply and an add) a token for every weight the token
  passes through outside the embedding: each layer's attention
  projections (D (H + 2 KV) d + H d D), router (D E), the experts a token
  is routed to (k of them, 3 D F each) or the dense MLP (3 D F), the SSD
  block's in-projection (D (2 d_inner + 2 G N + H)), depthwise conv
  (d_conv (d_inner + 2 G N)) and out-projection (d_inner D);
- causal attention: 4 d a (query, key) pair a head, S (S + 1) / 2 pairs a
  sequence a layer (about 2 S^2 H d);
- the SSD's chunked dual form at the configuration's chunk (see
  ``b8.py``);
- the head at each sequence's last position only: 2 D V.

The norms, gates, softmax and scan's elementwise work are not counted;
capacity slots that hold no token (the MoE's padding) are not work the
model needs and are not counted either.
"""

from __future__ import annotations


def layer_weights_per_token(lc: dict) -> int:
    D = lc["d_model"]
    n = 0
    block = lc.get("block", "attn")
    if block in ("attn", "hybrid"):
        H, KV, d = lc["n_heads"], lc["n_kv_heads"], lc["d_head"]
        n += D * (H + 2 * KV) * d + H * d * D
    if block in ("ssm", "hybrid"):
        d_inner = lc.get("ssm_expand", 2) * D
        G, N = 1, lc["ssm_state"]
        Hs = d_inner // lc.get("ssm_head_dim", 64)
        n += D * (2 * d_inner + 2 * G * N + Hs) + 4 * (d_inner + 2 * G * N)
        n += d_inner * D
    E = lc.get("n_experts", 0)
    if E:
        n += D * E + lc["moe_top_k"] * 3 * D * lc["d_ff"]
    elif lc.get("d_ff", 0):
        n += 3 * D * lc["d_ff"]
    return n


def ssd_flops(lc: dict, batch: int, seq_len: int) -> int:
    D = lc["d_model"]
    d_inner = lc.get("ssm_expand", 2) * D
    P, N, G = lc.get("ssm_head_dim", 64), lc["ssm_state"], 1
    H = d_inner // P
    c = lc.get("ssm_chunk", 64)
    nc = -(-seq_len // c)
    tri = c * (c + 1) // 2
    return batch * nc * (G * tri * 2 * N + H * tri * 2 * P
                         + H * c * 4 * P * N + H * 2 * P * N)


def prefill_flops(lc: dict, batch: int, seq_len: int) -> float:
    tokens = batch * seq_len
    n = 2 * layer_weights_per_token(lc) * tokens
    block = lc.get("block", "attn")
    if block in ("attn", "hybrid"):
        n += 4 * lc["d_head"] * lc["n_heads"] * batch * (
            seq_len * (seq_len + 1) // 2)
    if block in ("ssm", "hybrid"):
        n += ssd_flops(lc, batch, seq_len)
    n *= lc["n_layers"]
    n += 2 * lc["d_model"] * lc["vocab_size"] * batch
    return float(n)
