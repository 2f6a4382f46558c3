"""Decode attention: the CUDA kernel's wrapper and its plain PyTorch
version.

Replaces ``repro/kernels/decode_attention.py::decode_attention`` (Pallas
``_decode_kernel``): one query token per sequence, ``q (B, H, d)``,
against K/V caches in the model layout ``(B, K, KV, d)``, GQA group
``H // KV`` per KV head, positions ``p < length`` and, for ``window > 0``,
``length - 1 - p < window``.  The caches are read through their strides
(no transposed copy).  ``length`` and ``window`` are Python ints or
one-element int32 tensors on the card, which the kernel reads from device
memory: no ``.item()``, no host synchronisation.  The kernel
(``csrc/decode_attention.cu``: split-K partials and a log-sum-exp
combine) says what bounds it and how its design answers that.
``decode_attention`` launches it for CUDA tensors and takes
``ref.ref_decode_attention`` for CPU tensors.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import backend, build
from repro_torch.kernels.ref import ref_decode_attention

HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 8                    # query heads per KV head kept in registers
MIN_SPLIT = 128                  # cache positions per block, at least
MAX_SPLITS = 64                  # blocks per (sequence, KV head), at most


def _lib():
    fn = build.load("decode_attention").decode_attention_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, ll, ll, ll, ll, ll, ll, i, i, i, i, i, i,
                       p, i, p, i, ctypes.c_float, p, p, p, i, p]
        fn.restype = ctypes.c_int
    return fn


def _runtime_scalar(name: str, val, device: torch.device):
    """``(device pointer or None, host int)`` for ``length`` /
    ``window``."""
    if isinstance(val, torch.Tensor):
        if val.numel() != 1 or val.dtype.is_floating_point:
            raise TypeError(f"decode_attention: {name} must be an int or a "
                            f"one-element integer tensor")
        if val.device.type == "cpu":
            val = int(val)       # already on the host: no synchronisation
        elif val.device != device or val.dtype != torch.int32:
            raise ValueError(f"decode_attention: {name} on the card must be "
                             f"int32 on {device}, got {val.dtype} on "
                             f"{val.device}")
        else:
            return val.data_ptr(), 0
    val = int(val)
    if not -2 ** 31 <= val < 2 ** 31:
        raise ValueError(f"decode_attention: {name}={val} out of int32 range")
    return None, val


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length,
                     window=0) -> torch.Tensor:
    """q (B, H, d); caches (B, K, KV, d), float32 or bfloat16, one dtype.
    Returns (B, H, d) in q's dtype.  CUDA tensors launch the kernel
    (counted in ``decode_attention.launches``); CPU tensors take the plain
    version."""
    if backend.kernel_route("decode_attention", q, k_cache, v_cache) == "cpu":
        return ref_decode_attention(q, k_cache, v_cache, length, window)
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
    if d not in HEAD_DIMS or H // KV > MAX_GROUP:
        raise ValueError(f"decode_attention: the kernel takes d in "
                         f"{HEAD_DIMS} and at most {MAX_GROUP} query heads "
                         f"per KV head, got d={d}, group {H // KV}")
    if not (q.is_contiguous() and backend.rows_aligned(q)
            and backend.rows_aligned(k_cache)
            and backend.rows_aligned(v_cache)):
        raise ValueError("decode_attention: q contiguous, and every row of "
                         "q and the caches unit-strided and 16-byte aligned")
    len_dev, len_host = _runtime_scalar("length", length, q.device)
    win_dev, win_host = _runtime_scalar("window", window, q.device)
    if q.numel() == 0 or K == 0:
        return torch.zeros_like(q)
    split = max(MIN_SPLIT, -(-K // MAX_SPLITS))
    nsplit = -(-K // split)
    part_acc = torch.empty(B * H * nsplit * d, dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty(B * H * nsplit * 2, dtype=torch.float32,
                          device=q.device)
    out = torch.empty_like(q)
    backend.launch("decode_attention", _lib(), q.data_ptr(),
                   k_cache.data_ptr(), v_cache.data_ptr(),
                   *k_cache.stride()[:3], *v_cache.stride()[:3],
                   B, H, KV, K, d, split, len_dev, len_host, win_dev,
                   win_host, 1.0 / math.sqrt(d),
                   part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
                   dt, device=q.device)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
