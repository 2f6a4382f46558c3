"""The controls: the reference with one part computed in the nearest
precision below the one the configuration states, the step a later
change would be tempted by.  Each cell's check lists the controls that
apply to it (``controls``); ``control.py`` reads them by name.

- ``fp8``: every product the reference routes through ``mm`` (the
  projections, the experts, the attention scores and sums, the head) in
  fp8 (e4m3) with float32 accumulation, as the H100's fp8 tensor cores
  multiply: the configurations state bfloat16.  Each operand is scaled
  per row of the left operand and per column of the right one (each
  row's or column's largest magnitude onto e4m3's largest finite value,
  448), rounded to e4m3 and multiplied in float32.
- ``scan_tf32``: the SSD scan's products in TF32 (the configuration
  states a float32 scan, ``ssm_dtype``).
- ``scan_bf16``: the whole SSD scan in bfloat16.
- ``router_bf16``: the MoE router's logits and softmax in bfloat16 (the
  configuration states a float32 router, ``router_dtype``).

``BF16`` is no control: the reference itself with its products and
router in bfloat16, the witness of how far two correct computations in
different precisions part over an MoE model's layers.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(_fp8(a, -1), _fp8(b, -2))


def bf16_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.bfloat16(), b.bfloat16()).float()


# the fields of ``lm.Precision`` each lowers
CONTROLS = {
    "fp8": {"mm": fp8_mm},
    "scan_tf32": {"scan": "tf32"},
    "scan_bf16": {"scan": "bfloat16"},
    "router_bf16": {"router": "bfloat16"},
}

BF16 = {"mm": bf16_mm, "router": "bfloat16"}
