"""Operations and bytes of a call of B8, ``ssd_scan(x, dt, a, b, c,
chunk)``, from its shapes alone.

x (B, S, H, P), dt (B, S, H), a (H,), b and c (B, S, G, N), head h
reading group h // (H / G); the scan runs from a zero state and returns
y (B, S, H, P) in x's dtype and the final state (B, H, P, N) in float32.

The work of the chunked dual form at the call's ``chunk`` c, per
sequence and chunk (nc = S / c chunks):

- C_i . B_j for the c (c + 1) / 2 pairs i >= j, once a group:
  2 N each;
- y_i = sum_{j <= i} (C_i . B_j) L_ij (dt_j x_j), once a head: 2 P a pair;
- the chunk's state sum_j B_j (decay_j dt_j x_j)^T, once a head: 2 P N a
  position;
- the carried-in state read out, C_i . h, once a head: 2 P N a position;
- the state passed on, h * decay + state, once a head: 2 P N a chunk.

The decays, the exponentials and the products by dt are elementwise and
not counted.  Bytes: x, dt, a, b and c read once and y and the final
state written once.  The dtype returned is x's: float32 inputs price at
the TF32 rate, the fastest at which float32 operands can be multiplied.
"""

from __future__ import annotations


def count(call: dict):
    x, dt, a, b, c = call["args"][:5]
    chunk = call["args"][5] if len(call["args"]) > 5 else \
        call["kwargs"].get("chunk", 128)
    B, S, H, P = x["shape"]
    G, N = b["shape"][2], b["shape"][3]
    nc = -(-S // chunk)
    tri = chunk * (chunk + 1) // 2
    per_chunk = (G * tri * 2 * N + H * tri * 2 * P
                 + H * chunk * 2 * P * N * 2 + H * 2 * P * N)
    flops = B * nc * per_chunk
    nbytes = (2 * B * S * H * P * x["itemsize"]
              + B * S * H * dt["itemsize"] + H * a["itemsize"]
              + 2 * B * S * G * N * b["itemsize"] + B * H * P * N * 4)
    return float(flops), float(nbytes), x["dtype"]
