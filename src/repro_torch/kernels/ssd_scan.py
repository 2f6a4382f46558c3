"""Mamba-2 SSD chunked scan: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``repro/kernels/ssd_scan.py::ssd_scan`` (Pallas ``_ssd_kernel``)
behind ``repro/kernels/ops.py::ssd_scan``: x (B, S, H, P), dt (B, S, H),
a (H,), b and c (B, S, G, N) with ``H % G == 0``; y (B, S, H, P) in x's
dtype and the final state (B, H, P, N) in float32.  Head h reads group
``h // (H // G)``: the kernel indexes the group instead of expanding b
and c.  x, b, c and dt are read through their strides (unit stride on
the last axis), so the model's slices of its conv output need no copy.
The kernel (``csrc/ssd_scan.cu``: four launches, one call) says what
bounds it and how its design answers that: C B^T once per (sequence,
chunk, group), and every product on ``mma.sync`` in split TF32 (three
TF32 products for each float32 one).  One route, ``"mma"``
(``ssd_scan_route``), for every shape the reference's kernel takes: any
P (blocks of 64 columns), any N (slices of 128), any chunk dividing S; a
ragged P, N or chunk runs in zero-padded tiles.  ``ssd_scan`` launches it for CUDA
tensors and takes ``ref.ref_ssd_scan`` for CPU tensors; nothing falls
back when a build or launch fails.  Its gradient is the plain version's
(``backend.with_plain_grad``), through y only: the final state is
marked non-differentiable (the model reads only y).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import backend, build
from repro_torch.kernels.ref import ref_ssd_scan
from repro_torch.obs.trace import span

TILE = 64                  # rows of a C B^T tile (csrc TILE)


def _lib():
    lib = build.load("ssd_scan")
    fn = lib.ssd_scan_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 5 + [ll] * 12 + [i] * 9 + [p] * 8
        fn.restype = ctypes.c_int
        big = lib.ssd_scan_big_floats
        big.argtypes = [i] * 5
        big.restype = ll
    return lib


def _check(x, dt, a, b, c, chunk):
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or b.dim() != 4 \
            or c.shape != b.shape:
        raise ValueError(f"ssd_scan: x (B, S, H, P), dt (B, S, H), a (H,), "
                         f"b and c (B, S, G, N), got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    B, S, H, _ = x.shape
    G = b.shape[2]
    if dt.shape != (B, S, H) or a.shape != (H,) or b.shape[:2] != (B, S) \
            or G < 1 or H % G:
        raise ValueError(f"ssd_scan: shapes do not fit x {tuple(x.shape)}: "
                         f"dt {tuple(dt.shape)}, a {tuple(a.shape)}, b/c "
                         f"{tuple(b.shape)} (H % G must be 0)")
    if chunk < 1 or S % chunk:
        raise ValueError(f"ssd_scan: S={S} must be a multiple of "
                         f"chunk={chunk}")


def _codes(x, dt, a, b, c) -> Tuple[int, int]:
    """The kernel's dtype codes of x (shared by b and c) and of dt; raises
    for inputs the kernel does not take.  Reads only dtype and shape."""
    x_dt = backend.kernel_dtype("ssd_scan", x, b, c)
    dt_dt = backend.kernel_dtype("ssd_scan", dt)
    if a.dtype != torch.float32:
        raise TypeError(f"ssd_scan: a must be float32, got {a.dtype}")
    return x_dt, dt_dt


def ssd_scan_route(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor) -> str:
    """The kernel a CUDA call on these inputs launches: ``"mma"`` (split
    TF32 on ``mma.sync``) for x, b and c sharing float32, bfloat16 or
    float16, dt any of the three, a float32, at any P and N; raises for
    anything else.  Reads only dtype and shape, so it takes ``meta``
    tensors too."""
    _codes(x, dt, a, b, c)
    return "mma"


def cost(x: torch.Tensor, b: torch.Tensor, chunk: int):
    """(operations, bytes) of one call: its bound's counts (PERF.md §6).
    C B^T over the causal half of each chunk once a group; per head the
    masked scores times dt*x, the chunk's own state and the carry-in of
    every chunk but the first; x, b, c, dt, a read, y and the state
    written once."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    size = x.element_size()
    tri, nc = chunk * (chunk + 1) // 2, S // chunk
    cb_flops = B * G * nc * 2 * tri * N
    head_flops = B * H * (nc * (2 * tri * P + 2 * chunk * N * P)
                          + max(0, nc - 1) * 2 * chunk * N * P)
    nbytes = (2 * B * S * H * P * size + 2 * B * S * G * N * size
              + B * S * H * 4 + H * 4 + B * H * P * N * 4)
    return cb_flops + head_flops, nbytes


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor,
             chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, H, P); dt (B, S, H); a (H,); b/c (B, S, G, N).  Returns
    (y (B, S, H, P) in x's dtype, final state (B, H, P, N) float32).
    x, b and c share float32, bfloat16 or float16; dt is any of the
    three; a is float32.  ``S % chunk == 0``; any P and N.  CUDA tensors
    launch the kernel (counted in ``ssd_scan.launches``); CPU tensors take
    the plain version.  y is differentiable in x, dt, a, b and c, by the
    plain version's gradient; the state is not differentiable."""
    _check(x, dt, a, b, c, chunk)
    return backend.with_plain_grad(_ssd_scan, ref_ssd_scan, (x, dt, a, b, c),
                                   {"chunk": chunk}, nondiff=(1,))


def _ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor,
              chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    route = backend.kernel_route("ssd_scan", x, dt, a, b, c)
    if route == "cpu":
        return backend.plain_route("ssd_scan", lambda: cost(x, b, chunk),
                                   ref_ssd_scan, x, dt, a, b, c, chunk)
    x_dt, dt_dt = _codes(x, dt, a, b, c)
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if any(t.stride(-1) != 1 for t in (x, b, c)) or not a.is_contiguous():
        raise ValueError("ssd_scan: x, b and c need unit stride on their "
                         "last axis, a must be contiguous")
    dev = x.device
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=dev)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    if route == "meta":
        backend.record_kernel("ssd_scan", lambda: cost(x, b, chunk))
        return y, state
    if x.numel() == 0 or N == 0:
        return y.zero_(), state.zero_()
    yf = y if x.dtype == torch.float32 else torch.empty(
        (B, S, H, P), dtype=torch.float32, device=dev)
    cs = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    st = torch.empty((B, S // chunk, H, P, N), dtype=torch.float32,
                     device=dev)
    # C B^T: the causal 64 x 64 tile pairs of each (sequence, chunk, group)
    nt = -(-chunk // TILE)
    cb = torch.empty((B, S // chunk, G, nt * (nt + 1) // 2, TILE, TILE),
                     dtype=torch.float32, device=dev)
    lib = _lib()
    # the chunk kernel's chunk-long arrays, where shared memory cannot
    # hold them (a chunk above 10,240)
    n_big = lib.ssd_scan_big_floats(B, S, H, P, chunk)
    big = torch.empty(n_big, dtype=torch.float32, device=dev) \
        if n_big else None
    with span("kernel.b8"):
        backend.launch("ssd_scan", lib.ssd_scan_launch, x.data_ptr(),
                       dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                       *x.stride()[:3], *dt.stride(), *b.stride()[:3],
                       *c.stride()[:3], B, S, H, G, P, N, chunk, x_dt, dt_dt,
                       y.data_ptr(), yf.data_ptr(), cs.data_ptr(),
                       st.data_ptr(), cb.data_ptr(), state.data_ptr(),
                       big.data_ptr() if big is not None else None,
                       device=dev)
    ssd_scan.launches += 1
    backend.record_kernel("ssd_scan", lambda: cost(x, b, chunk))
    return y, state


ssd_scan.launches = 0
