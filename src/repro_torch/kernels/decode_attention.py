"""Decode attention: the CUDA kernel's wrapper and its plain PyTorch
version.

Replaces ``repro/kernels/decode_attention.py::decode_attention`` (Pallas
``_decode_kernel``): one query token per sequence, ``q (B, H, d)``,
against K/V caches in the model layout ``(B, K, KV, d)``, any GQA group
``H // KV`` per KV head, positions ``p < length`` and, for ``window > 0``,
``length - 1 - p < window``.  The caches are read through their strides
(no transposed copy).  ``length`` and ``window`` are Python ints or
one-element integer tensors on the card (int32, or any other integer
dtype cast to int32 there), which the kernel reads from device memory:
no ``.item()``, no host synchronisation.  The kernel
(``csrc/decode_attention.cu``: split-K partials and a log-sum-exp
combine) says what bounds it and how its design answers that.  Two
routes, by dtype, head dim and alignment (``decode_attention_route``):
``mma`` for bfloat16 and float16 at a d that is a multiple of 8 up to 256
with aligned rows (a TMA ring and the GQA group on ``mma.sync``), ``fma``
for float32 and every other 16-bit input (scalar IEEE FMAs on widened
values; element loads for rows TMA cannot read, no padded copy).  Any
head dim d >= 1, as the reference's kernel takes any d: a call runs at
the smallest of the route's ``WIDTHS`` >= d (``backend.padded_head_dim``,
the one width rule, passed into C) with the columns past d zero, and a d
past 256 splits the output's columns across blocks of 256, each
computing the scores over all of d.
``decode_attention`` launches the kernel for CUDA tensors and takes
``ref.ref_decode_attention`` for CPU tensors.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels import backend, build
from repro_torch.kernels.ref import ref_decode_attention
from repro_torch.obs.trace import span

# the widths each route's kernel is instantiated for (a call runs the
# smallest one >= d; the bf16 ring's TMA boxes are 64 elements wide)
WIDTHS = {"mma": (64, 128, 256), "fma": (8, 16, 32, 64, 128, 256)}
BLOCK_K = 64                       # cache positions a tile (csrc BK)
SUB_GROUP = {"mma": 16, "fma": 8}  # query heads a block, at most

# (device index, d, width, group, dtype code, route, vector loads) ->
# blocks resident on the card
_resident: Dict[Tuple[int, int, int, int, int, str, bool], int] = {}
ROUTES = {"fma": 0, "mma": 1}  # route codes of the C entry point


def _lib():
    lib = build.load("decode_attention")
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, ll, ll, ll, ll, ll, ll, i, i, i, i, i, i,
                       i, p, i, p, i, ctypes.c_float, p, p, p, i, i, i, p]
        fn.restype = ctypes.c_int
        occ = lib.decode_attention_blocks_per_sm
        occ.argtypes = [i, i, i, i, i, i, ctypes.POINTER(i)]
        occ.restype = ctypes.c_int
    return lib


def decode_attention_route(q: torch.Tensor, *caches: torch.Tensor) -> str:
    """The kernel a CUDA call on q and the caches (those given) takes:
    ``mma`` for bfloat16 and float16 at a head dim that is a multiple of 8
    up to 256 with every row 16-byte aligned (what TMA reads), ``fma``
    for the rest (``backend.head_dim_route``)."""
    return backend.head_dim_route(
        q.dtype, q.shape[-1],
        all(backend.rows_aligned(t) for t in (q, *caches)))


def split_count(B: int, KV: int, n_sub: int, K: int, resident: int) -> int:
    """Blocks per (KV head sub-group, sequence): as many as fill the
    card's ``resident`` blocks once, at most one per tile of the cache."""
    return max(1, min(-(-K // BLOCK_K), resident // (B * KV * n_sub)))


def split_tiles(K: int, length: int, window: int, sp: int,
                nsplit: int) -> Tuple[int, int]:
    """``[t_begin, t_end)``: the tiles of ``BLOCK_K`` positions that split
    ``sp`` of ``nsplit`` reads, as the kernel's ``split_range`` computes
    them: an equal share, +-1, of the tiles that hold the valid positions
    ``[lo, hi)``."""
    hi = min(length, K)
    lo = max(0, length - window) if window > 0 else 0
    if hi <= lo:
        return 0, 0
    t0 = lo // BLOCK_K
    n = -(-hi // BLOCK_K) - t0
    return t0 + n * sp // nsplit, t0 + n * (sp + 1) // nsplit


def _resident_blocks(device: torch.device, d: int, width: int, group: int,
                     dt: int, route: str, vec: bool) -> int:
    """SMs times the blocks of the kernel an SM holds, queried once per
    device and shape class."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    key = (index, d, width, group, dt, route, vec)
    if key not in _resident:
        per_sm = ctypes.c_int(0)
        with torch.cuda.device(index):
            rc = _lib().decode_attention_blocks_per_sm(
                d, width, group, dt, ROUTES[route], int(vec),
                ctypes.byref(per_sm))
        if rc != 0 or per_sm.value < 1:
            raise RuntimeError(f"decode_attention: occupancy query failed "
                               f"(cudaError {rc}, {per_sm.value} blocks)")
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        _resident[key] = per_sm.value * sms
    return _resident[key]


def _plan(q: torch.Tensor, k_cache: torch.Tensor,
          v_cache: torch.Tensor) -> Tuple[int, str, int, bool]:
    """The kernel's checks on q and the caches, and the call's plan: the
    dtype code, the route, the width it runs at and whether every row is
    16-byte aligned (each read once).  Reads only dtype, shape, strides
    and address."""
    dt = backend.kernel_dtype("decode_attention", q, k_cache, v_cache)
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention: q (B, H, d) and caches "
                         f"(B, K, KV, d), got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, H, d = q.shape
    _, K, KV, dk = k_cache.shape
    if k_cache.shape[0] != B or dk != d or KV < 1 or H % KV:
        raise ValueError(f"decode_attention: caches {tuple(k_cache.shape)} "
                         f"do not fit q {tuple(q.shape)}")
    aligned = all(backend.rows_aligned(t) for t in (q, k_cache, v_cache))
    route = backend.head_dim_route(q.dtype, d, aligned)
    width = backend.padded_head_dim(d, WIDTHS[route], "decode_attention")
    if not (q.is_contiguous() and k_cache.stride(-1) == 1
            and v_cache.stride(-1) == 1):
        raise ValueError("decode_attention: q contiguous, and the caches "
                         "unit-strided on d")
    return dt, route, width, aligned


def _nsplit(q: torch.Tensor, k_cache: torch.Tensor, dt: int, route: str,
            width: int, vec: bool) -> int:
    B, H, d = q.shape
    _, K, KV, _ = k_cache.shape
    n_sub = -(-(H // KV) // SUB_GROUP[route])
    if d > width:
        n_sub *= -(-d // width)   # the fma route's column blocks
    return split_count(B, KV, n_sub, K,
                       _resident_blocks(q.device, d, width, H // KV, dt,
                                        route, vec))


def decode_attention_nsplit(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor) -> int:
    """The splits a CUDA call on these inputs launches."""
    dt, route, width, vec = _plan(q, k_cache, v_cache)
    return _nsplit(q, k_cache, dt, route, width, vec)


def _runtime_scalar(name: str, val, device: torch.device):
    """``(device pointer or None, host int, tensor to keep alive)`` for
    ``length`` / ``window``.  A one-element integer tensor on ``device``
    of another dtype than int32 (int64 is torch's default) is cast there,
    asynchronously, as the reference casts any integer to int32; values
    outside int32 are the caller's to avoid.  The caller holds the third
    element until the launch that reads the pointer has been queued."""
    if isinstance(val, torch.Tensor):
        if val.numel() != 1 or val.dtype.is_floating_point:
            raise TypeError(f"decode_attention: {name} must be an int or a "
                            f"one-element integer tensor")
        if val.device.type == "cpu":
            val = int(val)       # already on the host: no synchronisation
        elif val.device != device:
            raise ValueError(f"decode_attention: {name} on the card must be "
                             f"on {device}, got {val.dtype} on {val.device}")
        else:
            if val.dtype != torch.int32:
                val = val.to(torch.int32)
            return val.data_ptr(), 0, val
    val = int(val)
    if not -2 ** 31 <= val < 2 ** 31:
        raise ValueError(f"decode_attention: {name}={val} out of int32 range")
    return None, val, None


def check_inputs(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor) -> int:
    """The kernel's checks on q and the caches; returns the dtype code.
    Reads only dtype, shape, strides and address, so it takes ``meta``
    tensors too (the CPU tests run it at the models' shapes)."""
    return _plan(q, k_cache, v_cache)[0]


def cost(q: torch.Tensor, k_cache: torch.Tensor, window):
    """(operations, bytes) of one call: its bound's counts (PERF.md §6)
    with every slot of the cache a key, or the window's last ``window``
    when it is shorter (a count the host can make without reading the
    length, an upper bound on what the call's data needs)."""
    B, H, d = q.shape
    _, K, KV, _ = k_cache.shape
    w = int(window) if not isinstance(window, torch.Tensor) else 0
    n = min(K, w) if w > 0 else K
    size = q.element_size()
    return (4 * B * H * d * n,
            2 * n * B * KV * d * k_cache.element_size() + 2 * B * H * d * size)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length,
                     window=0) -> torch.Tensor:
    """q (B, H, d); caches (B, K, KV, d), float32, bfloat16 or float16,
    one dtype; any d >= 1.
    Returns (B, H, d) in q's dtype.  CUDA tensors launch the kernel
    (counted in ``decode_attention.launches``); CPU tensors take the plain
    version."""
    route = backend.kernel_route("decode_attention", q, k_cache, v_cache)
    if route == "cpu":
        return backend.plain_route(
            "decode_attention", lambda: cost(q, k_cache, window),
            ref_decode_attention, q, k_cache, v_cache, length, window)
    dt, route_c, width, vec = _plan(q, k_cache, v_cache)
    if route == "meta":
        backend.record_kernel("decode_attention", lambda: cost(q, k_cache, window))
        return torch.empty_like(q)
    B, H, d = q.shape
    _, K, KV, _ = k_cache.shape
    # the third values hold any int32 copy made on the card until the
    # launch that reads it has been queued
    len_dev, len_host, _len = _runtime_scalar("length", length, q.device)
    win_dev, win_host, _win = _runtime_scalar("window", window, q.device)
    if q.numel() == 0 or K == 0:
        return torch.zeros_like(q)
    nsplit = _nsplit(q, k_cache, dt, route_c, width, vec)
    part_acc = torch.empty(B * H * nsplit * d, dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty(B * H * nsplit * 2, dtype=torch.float32,
                          device=q.device)
    out = torch.empty_like(q)
    with span("kernel.b5"):
        backend.launch("decode_attention", _lib().decode_attention_launch,
                       q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                       *k_cache.stride()[:3], *v_cache.stride()[:3],
                       B, H, KV, K, d, width, nsplit, len_dev, len_host,
                       win_dev, win_host, 1.0 / math.sqrt(d),
                       part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
                       dt, ROUTES[route_c], int(vec), device=q.device)
    decode_attention.launches += 1
    backend.record_kernel("decode_attention", lambda: cost(q, k_cache, window))
    return out


decode_attention.launches = 0
