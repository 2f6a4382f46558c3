"""Flash attention (forward): the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``repro/kernels/flash_attention.py::flash_attention`` (Pallas
``_flash_kernel``) behind ``repro/kernels/ops.py::flash_attention``:
q, k, v in the model layout ``(B, S, H, d)`` with KV already repeated to
H heads, read through their strides (no transposed copies); online
softmax in float32; causal and sliding-window masks, with key tiles that
the mask covers wholly skipped.  The kernel (``csrc/flash_attention.cu``)
says what bounds it and how its design answers that.  Two routes by
dtype, head dim and alignment (``flash_attention_route``): ``"mma"``
(``mma.sync``) for bfloat16 and float16 at a d that is a multiple of 8
up to 256 with aligned rows, ``"fma"`` (scalar IEEE FMAs on widened
values) for float32 and every other 16-bit input.  Any head dim d >= 1,
as the reference's kernel takes any d: a call runs at the smallest of
the route's ``WIDTHS`` >= d (``backend.padded_head_dim``, the one width
rule, passed into C) with the columns past d zero, and a d past 256
splits the output's columns across blocks of 256, each computing the
scores over all of d.
``flash_attention`` launches the kernel for CUDA tensors and takes
``ref.ref_flash_attention`` for CPU tensors; its gradient is the plain
version's (``backend.with_plain_grad``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch.kernels import backend, build
from repro_torch.kernels.ref import ref_flash_attention
from repro_torch.obs.trace import span

# the widths each route's kernel is instantiated for (a call runs the
# smallest one >= d; the 16-bit kernel's k16 fragments and tiling need 32
# or more)
WIDTHS = {"mma": (32, 64, 128, 256), "fma": (8, 16, 32, 64, 128, 256)}
ROUTES = {"fma": 0, "mma": 1}  # route codes of the C entry point


def _lib():
    fn = build.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, ctypes.POINTER(ctypes.c_longlong), i, i,
                       i, i, i, i, i, ctypes.c_float, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention_route(q: torch.Tensor, *kv: torch.Tensor) -> str:
    """The kernel a CUDA call on q (and k, v where given) takes:
    ``"mma"`` for bfloat16 and float16 at a head dim that is a multiple
    of 8 up to 256 with every row 16-byte aligned, ``"fma"`` for the rest
    (``backend.head_dim_route``)."""
    return backend.head_dim_route(
        q.dtype, q.shape[-1], all(backend.rows_aligned(t) for t in (q, *kv)))


def _plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          window: int) -> Tuple[int, str, int, bool]:
    """The kernel's checks on q, k, v and ``window``, and the call's
    plan: the dtype code, the route, the width it runs at and whether
    every row of q, k, v is 16-byte aligned (each read once).  Reads only
    dtype, shape, strides and address."""
    dt = backend.kernel_dtype("flash_attention", q, k, v)
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q, k, v (B, S, H, d) of one "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, d = q.shape
    aligned = all(backend.rows_aligned(t) for t in (q, k, v))
    route = backend.head_dim_route(q.dtype, d, aligned)
    width = backend.padded_head_dim(d, WIDTHS[route], "flash_attention")
    if not all(t.stride(-1) == 1 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must be unit-strided "
                         "on d")
    if not 0 <= window < 2 ** 31 or max(B, S, H) >= 2 ** 31:
        raise ValueError(f"flash_attention: window={window} or shape "
                         f"{tuple(q.shape)} out of range")
    return dt, route, width, aligned


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window: int = 0) -> int:
    """The kernel's checks on q, k, v and ``window``; returns the dtype
    code.  Reads only dtype, shape, strides and address, so it takes
    ``meta`` tensors too (the CPU tests run it at the models' shapes)."""
    return _plan(q, k, v, window)[0]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q, k, v (B, S, H, d), float32, bfloat16 or float16, one dtype, any
    d >= 1; ``window`` 0
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
    dt, route_c, width, vec = _plan(q, k, v, window)
    B, S, H, d = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if route == "meta":
        backend.record_kernel("flash_attention", lambda: cost(q, causal, window))
        return out
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out)
                                         for s in t.stride()[:3]))
    with span("kernel.b6"):
        backend.launch("flash_attention", _lib(), q.data_ptr(),
                       k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
                       B, S, H, d, width, int(bool(causal)), window,
                       1.0 / math.sqrt(d), dt, ROUTES[route_c], int(vec),
                       device=q.device)
    flash_attention.launches += 1
    backend.record_kernel("flash_attention", lambda: cost(q, causal, window))
    return out


flash_attention.launches = 0
