"""The share of the rows the MoE layer hands to its expert products (B7)
that hold a token, in percent: the program's counters ``moe.rows_filled``
over ``moe.rows_computed`` (experts x capacity a layer) over the traced
steps.  The rest are computed and thrown away."""

from pbharness.program import counter_pct

SPANS = []


def read(t):
    return counter_pct(t, "moe.rows_filled", "moe.rows_computed")
