"""Grouped (per-expert) matmul: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``repro/kernels/grouped_matmul.py::grouped_matmul`` (Pallas
``_gmm_kernel``): ``x (E, C, D) @ w (E, D, F) -> (E, C, F)`` with a
float32 accumulator over D, stored in x's dtype.  The kernel
(``csrc/grouped_matmul.cu``: tensor-core ``mma.sync`` for bfloat16, IEEE
float32 FMAs for float32) says what bounds it and how its design answers
that; it masks ragged C, D and F itself.  ``grouped_matmul`` launches it
for CUDA tensors and takes ``ref.ref_grouped_matmul`` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend, build
from repro_torch.kernels.ref import ref_grouped_matmul


def _lib():
    fn = build.load("grouped_matmul").grouped_matmul_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E, C, D), w (E, D, F), contiguous, both float32 or both
    bfloat16.  CUDA tensors launch the kernel (counted in
    ``grouped_matmul.launches``); CPU tensors take the plain version."""
    if backend.kernel_route("grouped_matmul", x, w) == "cpu":
        return ref_grouped_matmul(x, w)
    dt = backend.kernel_dtype("grouped_matmul", x, w)
    if x.dim() != 3 or w.dim() != 3 or w.shape[:2] != (x.shape[0],
                                                        x.shape[2]):
        raise ValueError(f"grouped_matmul: x (E, C, D) and w (E, D, F), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("grouped_matmul: x and w must be contiguous")
    E, C, D = x.shape
    F = w.shape[2]
    if max(E, C, D, F) >= 2 ** 31:
        raise ValueError("grouped_matmul: dimensions must fit in int32")
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    vec = int(x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    backend.launch("grouped_matmul", _lib(), x.data_ptr(), w.data_ptr(),
                   out.data_ptr(), E, C, D, F, dt, vec, device=x.device)
    grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0
