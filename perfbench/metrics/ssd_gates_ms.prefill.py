"""Device milliseconds a prefill step spends making B8's inputs in the
SSD block (softplus of dt, a, the float32 copies of x, b and c), summed
over the layers: the program's ``ssm.gates`` phase, the function it
calls."""

from pbharness.program import present, spans_ms

SPANS = present(["repro_torch.models.layers._ssm_gates"])


def read(t):
    return spans_ms(t, SPANS)
