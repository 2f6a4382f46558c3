"""Grouped (per-expert) matmul: the CUDA kernels' wrapper and its plain
PyTorch version.

Replaces ``repro/kernels/grouped_matmul.py::grouped_matmul`` (Pallas
``_gmm_kernel``): ``x (E, C, D) @ w (E, D, F) -> (E, C, F)`` with a
float32 accumulator over D, stored in x's dtype.  ``csrc/grouped_matmul.cu``
holds three kernels, one per route, and says what bounds each:

- ``"wgmma"``: bfloat16 or float16 with D and F multiples of 8 (D > 0)
  and x and w 16-byte aligned.  Three warpgroups a block: a producer thread keeps
  TMA loads of x and w tiles in a four-stage ``mbarrier`` ring, and two
  consumer warpgroups run ``wgmma`` on a 128 x 256 output tile.  w is
  read in place as wgmma's N-major operand.
- ``"mma_sync"``: every other bfloat16 or float16 input (a ragged D or
  F, a view off 16-byte alignment), on ``mma.sync`` with element-wise
  masked loads.
- ``"fma"``: float32, on IEEE float32 FMAs (no TF32).

``grouped_matmul_route`` picks the route from dtype, shape and alignment
alone; nothing falls back when a build or launch fails.  ``grouped_matmul``
launches the route's kernel for CUDA tensors and takes
``ref.ref_grouped_matmul`` for CPU tensors; its gradient is the plain
version's (``backend.with_plain_grad``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend, build
from repro_torch.kernels.ref import ref_grouped_matmul
from repro_torch.obs.trace import span

# route codes of the C entry point (csrc/grouped_matmul.cu)
ROUTES = {"fma": 0, "mma_sync": 1, "wgmma": 2}


def _lib():
    fn = build.load("grouped_matmul").grouped_matmul_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def grouped_matmul_route(x: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel a CUDA call on x (E, C, D) and w (E, D, F) launches:
    ``"wgmma"`` for bfloat16 or float16 whose D and F are multiples of 8
    (D > 0) and whose x and w start 16-byte aligned (TMA's stride and
    address rules), ``"mma_sync"`` for any other bfloat16 or float16,
    ``"fma"`` for float32.  Reads only dtype, shape and address, so it
    takes ``meta`` tensors too."""
    if x.dtype == torch.float32:
        return "fma"
    if x.dtype not in (torch.bfloat16, torch.float16):
        raise TypeError(f"grouped_matmul: no kernel for {x.dtype}")
    D, F = x.shape[2], w.shape[2]
    if (D > 0 and D % 8 == 0 and F % 8 == 0 and x.data_ptr() % 16 == 0
            and w.data_ptr() % 16 == 0):
        return "wgmma"
    return "mma_sync"


def cost(x: torch.Tensor, w: torch.Tensor):
    """(operations, bytes) of one call: its bound's counts (PERF.md §6),
    x, w read and out written once."""
    E, C, D = x.shape
    F = w.shape[2]
    return (2 * E * C * D * F,
            (E * C * D + E * D * F + E * C * F) * x.element_size())


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E, C, D), w (E, D, F), contiguous, one dtype: float32,
    bfloat16 or float16.  CUDA tensors launch the kernel of
    ``grouped_matmul_route(x, w)`` (counted in
    ``grouped_matmul.launches``); CPU tensors take the plain version.
    Differentiable in x and w, by the plain version's gradient."""
    return backend.with_plain_grad(_grouped_matmul, ref_grouped_matmul,
                                   (x, w), {})


def _grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    route = backend.kernel_route("grouped_matmul", x, w)
    if route == "cpu":
        return backend.plain_route("grouped_matmul", lambda: cost(x, w),
                                   ref_grouped_matmul, x, w)
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
    if route == "meta":
        backend.record_kernel("grouped_matmul", lambda: cost(x, w))
        return out
    if out.numel() == 0:
        return out
    route = ROUTES[grouped_matmul_route(x, w)]
    with span("kernel.b7"):
        backend.launch("grouped_matmul", _lib(), x.data_ptr(), w.data_ptr(),
                       out.data_ptr(), E, C, D, F, route, dt, device=x.device)
    grouped_matmul.launches += 1
    backend.record_kernel("grouped_matmul", lambda: cost(x, w))
    return out


grouped_matmul.launches = 0
