"""Device milliseconds a prefill step spends in the kernels launched
inside ``repro_torch.models.layers.ssm_apply``, summed over the layers."""

from pbharness.readers import span_ms

SPANS = ["repro_torch.models.layers.ssm_apply"]


def read(t):
    return span_ms(t, SPANS[0])
