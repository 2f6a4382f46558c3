"""Device helper shared by the port's entry points.

Every entry point takes ``device=`` and runs on the CUDA card unless the
caller names another device.  There is no environment switch and no
quiet fallback: asking for CUDA on a host without it raises, and the
CPU runs only when the caller asks for it (the CPU tests do).  On the
CPU each kernel wrapper takes its plain PyTorch version; on the card it
launches its kernel.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device`` (default: the CUDA card).

    Also pins float32 to IEEE float32 for the process: TF32 off for
    matrix products and for cuDNN, so no float32 reduction on the UFA
    path can silently lose mantissa bits."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA was asked for but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def describe_device(device) -> dict:
    """``{"platform", "kind", "count"}`` of the device a result ran on."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(dev),
                "count": torch.cuda.device_count()}
    return {"platform": "cpu", "kind": "cpu", "count": 1}
