"""ELL frontier propagation to a fixed point: the CUDA round kernel, its
host loop, and the plain PyTorch version.

Replaces ``repro/kernels/ufa/propagation.py::fixed_point_ell`` (Pallas
``_round_kernel``).  The CSR adjacency is padded on the host to ELL form
(``ell_from_csr``: every caller row has exactly ``K`` callee slots, pad
slots closed=False), and one round is a dense gather:

    hit[s, u] = any_k  broken[s, ell_dst[u, k]] & ell_closed[u, k]
    new[s, u] = broken[s, u] | hit[s, u]

Rounds repeat until one changes nothing or ``n + 1`` rounds ran; the
final no-change round is counted, and ``S == 0 | n == 0 | K == 0``
returns ``(dark, 1)`` — the reference's exact round semantics, so
``broken`` and ``rounds`` are exact.  The kernel
(``csrc/fixed_point_ell.cu``) says what bounds it and how its design
answers that.  ``fixed_point_ell`` launches it for CUDA tensors and
takes ``ref_fixed_point`` for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import build


# ---------------------------------------------------------------------------
# host-side ELL precompute
# ---------------------------------------------------------------------------


def ell_from_csr(n: int, indptr: np.ndarray, dst: np.ndarray,
                 closed: np.ndarray, pad_to: int = 8
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CSR -> ELL: ``(ell_dst (n, K) int32, ell_closed (n, K) bool,
    slot (E,) int32)`` with ``K`` the max out-degree rounded up to
    ``pad_to`` (0 for an edge-free graph).  ``slot[e]`` is edge ``e``'s
    column in its caller's ELL row, so a fail-close mask update for edge
    ``e`` lands at ``ell_closed[src[e], slot[e]]`` (the planner's greedy
    loop flips edges in place).  Pad slots carry ``closed=False`` and
    never contribute a hit."""
    indptr = np.asarray(indptr, np.int64)
    dst = np.asarray(dst, np.int64)
    closed = np.asarray(closed, bool)
    deg = np.diff(indptr)
    kmax = int(deg.max(initial=0))
    if kmax == 0:
        return (np.zeros((n, 0), np.int32), np.zeros((n, 0), bool),
                np.zeros(len(dst), np.int32))
    K = -(-kmax // pad_to) * pad_to
    slot = np.arange(len(dst), dtype=np.int64) - np.repeat(indptr[:-1], deg)
    row = np.repeat(np.arange(n, dtype=np.int64), deg)
    ell_dst = np.zeros((n, K), np.int32)
    ell_closed = np.zeros((n, K), bool)
    ell_dst[row, slot] = dst
    ell_closed[row, slot] = closed
    return ell_dst, ell_closed, slot.astype(np.int32)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def ref_fixed_point(dark: torch.Tensor, ell_dst: torch.Tensor,
                    ell_closed: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Plain PyTorch version: the same Jacobi rounds as whole-slab
    gathers, ``(broken (S, n) bool, rounds)``."""
    S, n = dark.shape
    K = ell_dst.shape[1]
    if S == 0 or n == 0 or K == 0:
        return dark, 1
    idx = ell_dst.long()
    broken, rounds, changed = dark, 0, True
    while changed and rounds < n + 1:
        hit = (broken[:, idx] & ell_closed[None, :, :]).any(dim=2)
        new = broken | hit
        changed = bool((new != broken).any())
        broken, rounds = new, rounds + 1
    return broken, rounds


# ---------------------------------------------------------------------------
# the kernel's host loop
# ---------------------------------------------------------------------------


def _lib():
    lib = build.load("fixed_point_ell")
    fn = lib.ell_round_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, p, p]
        fn.restype = ctypes.c_int
    return fn


def fixed_point_ell(dark: torch.Tensor, ell_dst: torch.Tensor,
                    ell_closed: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Batched least fixed point over the ELL adjacency:
    ``dark (S, n) bool -> (broken (S, n) bool, rounds)``.  CUDA tensors
    run the round kernel (one launch per round, counted); CPU tensors
    take ``ref_fixed_point``."""
    if dark.device.type == "cpu":
        return ref_fixed_point(dark, ell_dst, ell_closed)
    if dark.device.type != "cuda":
        raise ValueError(f"fixed_point_ell: no kernel for {dark.device}")
    S, n = dark.shape
    K = ell_dst.shape[1]
    if (dark.dtype != torch.bool or ell_dst.dtype != torch.int32
            or ell_closed.dtype != torch.bool):
        raise TypeError("fixed_point_ell: dark bool, ell_dst int32, "
                        "ell_closed bool")
    if ell_dst.shape != (n, K) or ell_closed.shape != (n, K):
        raise ValueError("fixed_point_ell: ELL arrays must be (n, K)")
    if ell_dst.device != dark.device or ell_closed.device != dark.device:
        raise ValueError("fixed_point_ell: tensors on different devices")
    if S == 0 or n == 0 or K == 0:
        return dark, 1
    if bool(((ell_dst < 0) | (ell_dst >= n)).any()):
        raise ValueError("fixed_point_ell: ell_dst out of range [0, n)")
    ell_dst, ell_closed = ell_dst.contiguous(), ell_closed.contiguous()
    cur = dark.contiguous().clone()
    nxt = torch.empty_like(cur)
    changed = torch.zeros(1, dtype=torch.int32, device=dark.device)
    launch = _lib()
    rounds = 0
    with torch.cuda.device(dark.device):
        stream = torch.cuda.current_stream().cuda_stream
        while True:
            rc = launch(cur.data_ptr(), nxt.data_ptr(), ell_dst.data_ptr(),
                        ell_closed.data_ptr(), S, n, K, changed.data_ptr(),
                        stream)
            if rc != 0:
                raise RuntimeError(f"fixed_point_ell round kernel launch "
                                   f"failed: cudaError {rc}")
            fixed_point_ell.launches += 1
            rounds += 1
            if not changed.item() or rounds >= n + 1:
                return nxt, rounds
            cur, nxt = nxt, cur


fixed_point_ell.launches = 0
