"""Device milliseconds a prefill step spends computing each routed
slot's position in its expert's queue (the one-hot ``cumsum``, or the
sort for many experts), summed over the layers: the kernels launched
inside the program's ``moe.positions`` phase, the functions it calls."""

from pbharness.program import present, spans_ms

SPANS = present(["repro_torch.models.layers._expert_positions",
                 "repro_torch.models.layers._expert_positions_big"])


def read(t):
    return spans_ms(t, SPANS)
