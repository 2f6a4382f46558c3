"""The share of routed slots the MoE layer drops because their expert's
queue is full, in percent: the program's counters ``moe.slots_dropped``
over ``moe.slots_routed`` (tokens x top-k a layer) over the traced
steps."""

from pbharness.program import counter_pct

SPANS = []


def read(t):
    return counter_pct(t, "moe.slots_dropped", "moe.slots_routed")
