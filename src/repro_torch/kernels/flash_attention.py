"""Flash attention (forward): the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``repro/kernels/flash_attention.py::flash_attention`` (Pallas
``_flash_kernel``) behind ``repro/kernels/ops.py::flash_attention``:
q, k, v in the model layout ``(B, S, H, d)`` with KV already repeated to
H heads, read through their strides (no transposed copies); online
softmax in float32; causal and sliding-window masks, with key tiles that
the mask covers wholly skipped.  The kernel (``csrc/flash_attention.cu``)
says what bounds it and how its design answers that.  Two routes by
dtype (``flash_attention_route``): ``"mma"`` for bfloat16 (``mma.sync``)
and ``"fma"`` for float32 (scalar IEEE FMAs).  Both take every head dim
in ``backend.HEAD_DIM_DOMAIN`` (a multiple of 8 from 8 to 256, as the
reference's kernel takes any d), run at the smallest of the route's
``WIDTHS`` (``backend.padded_head_dim``) with the columns past d zero.
``flash_attention`` launches the kernel for CUDA tensors and takes
``ref.ref_flash_attention`` for CPU tensors; its gradient is the plain
version's (``backend.with_plain_grad``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import backend, build
from repro_torch.kernels.ref import ref_flash_attention

# the widths each route's kernel is instantiated for (a call runs the
# smallest one >= d; the bf16 kernel's k16 fragments and tiling need 32 or
# more)
WIDTHS = {"mma": (32, 64, 128, 256), "fma": (8, 16, 32, 64, 128, 256)}


def _lib():
    fn = build.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, ctypes.POINTER(ctypes.c_longlong), i, i,
                       i, i, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention_route(q: torch.Tensor, *_) -> str:
    """The kernel a CUDA call takes: ``"mma"`` for bfloat16, ``"fma"``
    for float32."""
    return "mma" if q.dtype == torch.bfloat16 else "fma"


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window: int = 0) -> int:
    """The kernel's checks on q, k, v and ``window``; returns the dtype
    code.  Reads only dtype, shape, strides and address, so it takes
    ``meta`` tensors too (the CPU tests run it at the models' shapes)."""
    dt = backend.kernel_dtype("flash_attention", q, k, v)
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q, k, v (B, S, H, d) of one "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, d = q.shape
    backend.padded_head_dim(d, WIDTHS[flash_attention_route(q)],
                            "flash_attention")
    if not all(backend.rows_aligned(t) for t in (q, k, v)):
        raise ValueError("flash_attention: every row of q, k, v must be "
                         "unit-strided and 16-byte aligned")
    if not 0 <= window < 2 ** 31 or max(B, S, H) >= 2 ** 31:
        raise ValueError(f"flash_attention: window={window} or shape "
                         f"{tuple(q.shape)} out of range")
    return dt


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q, k, v (B, S, H, d), float32 or bfloat16, one dtype; ``window`` 0
    = global, > 0 = keys with ``q_pos - k_pos < window``.  Returns
    (B, S, H, d) in q's dtype.  CUDA tensors launch the kernel (counted in
    ``flash_attention.launches``); CPU tensors take the plain version.
    Differentiable in q, k and v, by the plain version's gradient."""
    return backend.with_plain_grad(
        _flash_attention, ref_flash_attention, (q, k, v),
        {"causal": causal, "window": window})


def attention_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask allows, per (sequence, head)."""
    w = min(window, S) if window > 0 else S
    if causal:
        return w * (w + 1) // 2 + (S - w) * w
    # not causal: keys k >= q - w + 1, so query q >= w loses q - w + 1
    return S * S - (S - w) * (S - w + 1) // 2


def cost(q: torch.Tensor, causal: bool, window: int):
    """(operations, bytes) of one call: its bound's counts (PERF.md §6),
    q, k, v read and out written once, 4 d operations an allowed pair."""
    B, S, H, d = q.shape
    return (4 * B * H * d * attention_pairs(S, causal, int(window)),
            4 * B * S * H * d * q.element_size())


def _flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool, window: int) -> torch.Tensor:
    route = backend.kernel_route("flash_attention", q, k, v)
    if route == "cpu":
        return backend.plain_route(
            "flash_attention", lambda: cost(q, causal, window), ref_flash_attention,
            q, k, v, causal=causal, window=window)
    window = int(window)
    dt = check_inputs(q, k, v, window)
    B, S, H, d = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if route == "meta":
        backend.record_kernel("flash_attention", lambda: cost(q, causal, window))
        return out
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out)
                                         for s in t.stride()[:3]))
    backend.launch("flash_attention", _lib(), q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), out.data_ptr(), strides, B, S, H, d,
                   int(bool(causal)), window, 1.0 / math.sqrt(d), dt,
                   device=q.device)
    flash_attention.launches += 1
    backend.record_kernel("flash_attention", lambda: cost(q, causal, window))
    return out


flash_attention.launches = 0
