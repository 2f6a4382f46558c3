"""Operations and bytes of a call of B6, ``flash_attention(q, k, v, *,
causal=True, window=0)``, from its shapes alone.

q, k and v are (B, S, H, d), k and v already repeated to the H query
heads.  A (query, key) pair the mask allows costs the score q . k (d
multiplies and d adds) and its share of the output p * v (d and d): 4d
operations.  The pairs of one (sequence, head): S^2 without a mask, S
(S + 1) / 2 under the causal mask, and sum over queries i of min(i + 1,
W) with a causal window W.  Softmax's exponentials and sums are not
counted (they are not products and no kernel's bound rests on them).
Bytes: q, k and v read once and the output (B, S, H, d) written once, in
q's dtype.  The dtype returned is the one the products take: q's.
"""

from __future__ import annotations


def pairs(S: int, causal: bool, window: int) -> int:
    if not causal:
        return S * S
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    # queries 0..W-1 see i + 1 keys, the rest W
    return window * (window + 1) // 2 + (S - window) * window


def count(call: dict):
    q = call["args"][0]
    B, S, H, d = q["shape"]
    causal = bool(call["kwargs"].get("causal", True))
    window = int(call["kwargs"].get("window", 0))
    flops = 4 * d * pairs(S, causal, window) * B * H
    nbytes = 4 * B * S * H * d * q["itemsize"]
    return float(flops), float(nbytes), q["dtype"]
