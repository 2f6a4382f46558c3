"""Published peaks of the cards the benchmark prices work against.

NVIDIA H100 SXM5 data sheet, dense rates (no sparsity), at the full
700 W power limit: 989 TFLOP/s for bf16 and fp16 tensor-core products,
494.5 TFLOP/s for TF32 (the rate at which float32 inputs can be multiplied
on the tensor cores; no implementation that keeps float32 accuracy can
beat it), and 3.35 TB/s of HBM3 bandwidth.  A card that is not in the
table has no peaks: every share of a peak is then left out of the
result rather than priced against a guess.
"""

from __future__ import annotations

from typing import Optional

import torch

H100_SXM = {
    "flops": {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 494.5e12},
    "hbm_bytes_per_s": 3.35e12,
}

PEAKS = {"NVIDIA H100 80GB HBM3": H100_SXM}

# the rate mfu is priced at: the card's bf16 tensor-core peak
MFU_DTYPE = torch.bfloat16


def for_kind(kind: str) -> Optional[dict]:
    return PEAKS.get(kind)


def least_seconds(peaks: dict, flops: float, nbytes: float, dtype) -> float:
    """The least time a call could take on the card: the larger of its
    operations at the rate of its inputs' dtype and its bytes at the
    memory bandwidth."""
    return max(flops / peaks["flops"][dtype],
               nbytes / peaks["hbm_bytes_per_s"])
