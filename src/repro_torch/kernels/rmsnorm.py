"""RMSNorm: the CUDA kernel's wrapper and its plain PyTorch version.

Replaces ``repro/kernels/rmsnorm.py::rmsnorm`` (Pallas
``_rmsnorm_kernel``): ``y = (x * rsqrt(mean(x^2) + eps)) * scale`` over
the last axis in float32, stored in x's dtype.  The kernel
(``csrc/rmsnorm.cu``) says what bounds it and how its design answers
that.  ``rmsnorm`` launches it for CUDA tensors and takes
``ref.ref_rmsnorm`` for CPU tensors; its gradient is the plain
version's (``backend.with_plain_grad``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend, build
from repro_torch.kernels.ref import ref_rmsnorm
from repro_torch.obs.trace import span

# the widest row the one-pass kernel holds in registers (512 threads x
# 32 values a thread); wider rows, to int32 range, take the two-pass one
MAX_D = 16_384


def _lib():
    fn = build.load("rmsnorm").rmsnorm_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, ctypes.c_longlong, i, ctypes.c_float, i, i,
                       i, p]
        fn.restype = ctypes.c_int
    return fn


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x (..., D) contiguous, scale (D,); float32, bfloat16 or float16
    each, any D >= 1.
    CUDA tensors launch the kernel (counted in ``rmsnorm.launches``); CPU
    tensors take the plain version.  Differentiable in x and scale, by
    the plain version's gradient."""
    return backend.with_plain_grad(_rmsnorm, ref_rmsnorm, (x, scale),
                                   {"eps": eps})


def cost(x: torch.Tensor, scale: torch.Tensor):
    """(operations, bytes) of one call: its bound's counts (PERF.md §6),
    x read and y written once, the scale once."""
    D = x.shape[-1] if x.dim() else 0
    rows = x.numel() // D if D else 0
    return 4 * rows * D, (2 * rows * D * x.element_size()
                          + D * scale.element_size())


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor,
             eps: float) -> torch.Tensor:
    route = backend.kernel_route("rmsnorm", x, scale)
    if route == "cpu":
        return backend.plain_route("rmsnorm", lambda: cost(x, scale), ref_rmsnorm,
                                   x, scale, eps)
    x_dt = backend.kernel_dtype("rmsnorm", x)
    s_dt = backend.kernel_dtype("rmsnorm", scale)
    D = x.shape[-1] if x.dim() else 0
    if x.dim() == 0 or scale.shape != (D,) or not 1 <= D < 2 ** 31:
        raise ValueError(f"rmsnorm: x (..., D) with 1 <= D < 2**31 and "
                         f"scale (D,), got {tuple(x.shape)} and "
                         f"{tuple(scale.shape)}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm: x and scale must be contiguous")
    y = torch.empty_like(x)
    rows = x.numel() // D
    if route == "meta":
        backend.record_kernel("rmsnorm", lambda: cost(x, scale))
        return y
    if rows == 0:
        return y
    vec = int(all(t.data_ptr() % 16 == 0 for t in (x, scale, y)))
    with span("kernel.b4"):
        backend.launch("rmsnorm", _lib(), x.data_ptr(), scale.data_ptr(),
                       y.data_ptr(), rows, D, float(eps), x_dt, s_dt, vec,
                       device=x.device)
    rmsnorm.launches += 1
    backend.record_kernel("rmsnorm", lambda: cost(x, scale))
    return y


rmsnorm.launches = 0
