"""The whole prefill step's share of the card's bf16 peak, in percent:
the model's operations over the traced steps (``counts/model_flops.py``,
from the configuration and each traced batch's shape) over their wall time at
989 TFLOP/s.  A kernel taken off the path leaves its roofline silent;
this share still bounds what the step achieves."""

from pbharness import peaks

SPANS = []


def read(t):
    pk = t.context["peaks"]
    if pk is None or t.busy_s <= 0:
        return None
    mf = t.context["count"]("model_flops")
    flops = sum(mf.prefill_flops(t.context["lm_config"], b, s)
                for b, s in t.context["shapes"])
    return 100.0 * flops / (t.window_s * pk["flops"][peaks.MFU_DTYPE])
