"""Kernel B6's share of its roofline, in percent: the least time of
the calls ``repro_torch.kernels.ops.flash_attention`` saw (``counts/b6.py``) over the device time
inside its ranges.  Above 100 would mean the count is too high or the
time leaves out work; it is reported as measured."""

from pbharness.readers import roofline_pct

SPANS = ["repro_torch.kernels.ops.flash_attention"]


def read(t):
    return roofline_pct(t, SPANS[0], "b6")
