"""Device milliseconds a prefill step spends in the MoE layer outside its
expert products: the kernels launched inside ``moe_apply_local``'s
ranges less those inside ``grouped_matmul``'s (B7).  Routing, the queue
positions (the one-hot ``cumsum``), dispatch, the SwiGLU's elementwise
product and the combine."""

from pbharness.readers import span_ms

SPANS = ["repro_torch.models.layers.moe_apply_local",
         "repro_torch.kernels.ops.grouped_matmul"]


def read(t):
    moe = span_ms(t, SPANS[0])
    b7 = span_ms(t, SPANS[1])
    if moe is None or b7 is None:
        return None
    return moe - b7
