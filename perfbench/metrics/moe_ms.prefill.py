"""Device milliseconds a prefill step spends in the kernels launched
inside ``repro_torch.models.layers.moe_apply_local``, summed over the layers."""

from pbharness.readers import span_ms

SPANS = ["repro_torch.models.layers.moe_apply_local"]


def read(t):
    return span_ms(t, SPANS[0])
