"""Device milliseconds a prefill step spends moving tokens between the
MoE layer and its expert queues, summed over the layers: the program's
``moe.dispatch`` (slot rows, ``torch.where``, ``index_add_`` into the
queues) and ``moe.combine`` (the gather back, the weighted sum, a
shared MLP) phases, the functions they call."""

from pbharness.program import present, spans_ms

SPANS = present(["repro_torch.models.layers._moe_dispatch",
                 "repro_torch.models.layers._moe_combine"])


def read(t):
    return spans_ms(t, SPANS)
