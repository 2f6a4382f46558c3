"""Device milliseconds a prefill step spends in the SSD block's depthwise
causal conv (concat, pad, the float32 tap products, bias, SiLU, the cast
back), summed over the layers: the program's ``ssm.conv`` phase, the
function it calls."""

from pbharness.program import present, spans_ms

SPANS = present(["repro_torch.models.layers._ssm_conv"])


def read(t):
    return spans_ms(t, SPANS)
