"""Mamba-2's dt bias: dt = exp(U(log ``dt_min``, log ``dt_max``)),
floored at ``floor``; the bias is softplus^-1(dt) = dt + log(-expm1(-dt))."""

import math

import torch


def fill(rule, buf, gen):
    buf.uniform_(math.log(rule["dt_min"]), math.log(rule["dt_max"]),
                 generator=gen).exp_().clamp_(min=rule["floor"])
    buf.copy_(buf + torch.log(-torch.expm1(-buf)))
