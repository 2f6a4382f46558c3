"""Operations and bytes of a call of B7, ``grouped_matmul(x, w)``, from
its shapes alone.

x (E, C, D) @ w (E, D, F) -> (E, C, F): each of E experts multiplies its
C queue slots by its own D x F weights, 2 E C D F operations (a multiply
and an add each).  Bytes: x and every expert's weights read once, the
output written once, in x's dtype (the port stores the product in x's
dtype).  The dtype returned is the inputs': the rate the products run at.
"""

from __future__ import annotations


def count(call: dict):
    x, w = call["args"][0], call["args"][1]
    E, C, D = x["shape"]
    F = w["shape"][2]
    flops = 2 * E * C * D * F
    nbytes = (E * C * D * x["itemsize"] + E * D * F * w["itemsize"]
              + E * C * F * x["itemsize"])
    return float(flops), float(nbytes), x["dtype"]
