"""ELL frontier propagation to a fixed point: the CUDA kernels, their
routes, and the plain PyTorch version.

Replaces ``repro/kernels/ufa/propagation.py::fixed_point_ell`` (Pallas
``_round_kernel``).  The CSR adjacency is padded on the host to ELL form
(``ell_from_csr``: every caller row has exactly ``K`` callee slots, pad
slots closed=False), and one round is a dense gather:

    hit[s, u] = any_k  broken[s, ell_dst[u, k]] & ell_closed[u, k]
    new[s, u] = broken[s, u] | hit[s, u]

Rounds repeat until one changes nothing or ``n + 1`` rounds ran; the
final no-change round is counted, and ``S == 0 | n == 0 | K == 0``
returns ``(dark, 1)`` — the reference's exact round semantics, so
``broken`` and ``rounds`` are exact.  Rows are independent, so the slab
may be cut into groups of rows: the whole slab's ``broken`` is the
groups' side by side and its ``rounds`` the largest group's.

``fixed_point_ell`` takes ``ref_fixed_point`` for CPU tensors.  For CUDA
tensors ``fixed_point_route`` picks, from the shape alone, one of the two
routes of ``csrc/fixed_point_ell.cu`` (which says what bounds each):
``"cluster"``, one thread-block-cluster launch per fixed point with the
rounds on the device, 32 rows a cluster, and one synchronise a call; or
``"rounds"``, one launch per round and a read of the device's flag after
each, for graphs whose share does not fit one CTA's shared memory.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import backend, build


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
# routes
# ---------------------------------------------------------------------------

CLUSTER_SIZES = (8, 16)    # CTAs a cluster: 8 is portable, 16 only if needed
GROUP_ROWS = 32            # dark-set rows a cluster: the bits of a word
MAX_GROUPS = 65_535        # clusters of one launch (the grid's y extent)


def cluster_smem(n: int, K: int, C: int) -> int:
    """Shared memory of one CTA of the cluster route, in bytes, when
    ``C`` CTAs share ``n`` callers: two flags (16 bytes), two word
    buffers, ``K`` callee addresses and a slot count per owned caller,
    for the worst case of every slot closed (``csrc/fixed_point_ell.cu``
    ``cluster_smem``)."""
    m = -(-n // C)
    return 16 + m * (8 + 4 * K + 2)


def fixed_point_cluster(n: int, K: int) -> int:
    """CTAs a cluster for this graph: the first of ``CLUSTER_SIZES`` whose
    CTAs each hold their share in ``backend.SMEM_OPTIN`` bytes, else 0."""
    for C in CLUSTER_SIZES:
        if cluster_smem(n, K, C) <= backend.SMEM_OPTIN:
            return C
    return 0


def fixed_point_route(U: int, n: int, K: int) -> str:
    """The CUDA route of a ``(U, n)`` slab over an ``(n, K)`` ELL graph:
    ``"cluster"`` when a cluster's CTAs hold the graph in shared memory
    and the ``ceil(U / 32)`` clusters fit one launch, else ``"rounds"``.
    A pure function of the shape: the route is never chosen by a
    failure, and a failed cluster launch raises."""
    if min(U, n, K) < 0:
        raise ValueError(f"fixed_point_route: negative shape {(U, n, K)}")
    if fixed_point_cluster(n, K) and -(-U // GROUP_ROWS) <= MAX_GROUPS:
        return "cluster"
    return "rounds"


# ---------------------------------------------------------------------------
# the kernels' host side
# ---------------------------------------------------------------------------


def _lib(entry: str = "ell_round_launch"):
    lib = build.load("fixed_point_ell")
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = {
            "ell_round_launch": [p, p, p, p, i, i, i, p, p],
            "ell_cluster_launch": [p, p, p, p, i, i, i, i, p, p],
        }[entry]
        fn.restype = ctypes.c_int
    return fn


def _check(dark: torch.Tensor, ell_dst: torch.Tensor,
           ell_closed: torch.Tensor) -> Tuple[int, int, int]:
    """``(S, n, K)``; raises for inputs the kernels do not take.  Reads
    only dtype and shape, so it takes ``meta`` tensors too."""
    if (dark.dtype != torch.bool or ell_dst.dtype != torch.int32
            or ell_closed.dtype != torch.bool):
        raise TypeError("fixed_point_ell: dark bool, ell_dst int32, "
                        "ell_closed bool")
    if dark.dim() != 2 or ell_dst.dim() != 2:
        raise ValueError("fixed_point_ell: dark (S, n), ELL arrays (n, K)")
    S, n = dark.shape
    K = ell_dst.shape[1]
    if ell_dst.shape != (n, K) or ell_closed.shape != (n, K):
        raise ValueError("fixed_point_ell: ELL arrays must be (n, K)")
    if max(S, n, K) >= 2 ** 31:
        raise ValueError(f"fixed_point_ell: shape {(S, n, K)} beyond int32")
    return S, n, K


def fixed_point_ell(dark: torch.Tensor, ell_dst: torch.Tensor,
                    ell_closed: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Batched least fixed point over the ELL adjacency:
    ``dark (S, n) bool -> (broken (S, n) bool, rounds)``.  CPU tensors
    take ``ref_fixed_point``; CUDA tensors take the route
    ``fixed_point_route`` names, each launch counted in
    ``fixed_point_ell.launches`` (one a call on the cluster route, one a
    round on the rounds route) and the rounds in
    ``fixed_point_ell.rounds``.  An ``ell_dst`` entry outside
    ``[0, n)`` raises ``ValueError``."""
    tensors = (dark, ell_dst, ell_closed)
    if all(t.device.type == "cpu" for t in tensors):
        return ref_fixed_point(dark, ell_dst, ell_closed)
    S, n, K = _check(*tensors)
    backend.kernel_route("fixed_point_ell", *tensors)
    if S == 0 or n == 0 or K == 0:
        return dark, 1
    ell_dst, ell_closed = ell_dst.contiguous(), ell_closed.contiguous()
    if fixed_point_route(S, n, K) == "cluster":
        return _cluster(dark.contiguous(), ell_dst, ell_closed)
    return _rounds(dark, ell_dst, ell_closed)


def _cluster(dark, ell_dst, ell_closed):
    """One launch; ``[rounds, error]`` come back in one device-to-host
    copy, the call's only synchronise."""
    S, n = dark.shape
    K = ell_dst.shape[1]
    broken = torch.empty_like(dark)
    out = torch.empty(2, dtype=torch.int32, device=dark.device)
    backend.launch("fixed_point_ell", _lib("ell_cluster_launch"),
                   dark.data_ptr(), broken.data_ptr(), ell_dst.data_ptr(),
                   ell_closed.data_ptr(), S, n, K, fixed_point_cluster(n, K),
                   out.data_ptr(), device=dark.device)
    fixed_point_ell.launches += 1
    rounds, error = out.cpu().tolist()
    if error:
        raise ValueError("fixed_point_ell: ell_dst out of range [0, n)")
    fixed_point_ell.rounds += rounds
    return broken, rounds


def _rounds(dark, ell_dst, ell_closed):
    """One launch a round; the host reads the device's flag after each."""
    S, n = dark.shape
    K = ell_dst.shape[1]
    if bool(((ell_dst < 0) | (ell_dst >= n)).any()):
        raise ValueError("fixed_point_ell: ell_dst out of range [0, n)")
    cur = dark.contiguous().clone()
    nxt = torch.empty_like(cur)
    changed = torch.zeros(1, dtype=torch.int32, device=dark.device)
    launch = _lib()
    rounds = 0
    while True:
        backend.launch("fixed_point_ell", launch, cur.data_ptr(),
                       nxt.data_ptr(), ell_dst.data_ptr(),
                       ell_closed.data_ptr(), S, n, K, changed.data_ptr(),
                       device=dark.device)
        fixed_point_ell.launches += 1
        fixed_point_ell.rounds += 1
        rounds += 1
        if not changed.item() or rounds >= n + 1:
            return nxt, rounds
        cur, nxt = nxt, cur


fixed_point_ell.launches = 0
fixed_point_ell.rounds = 0
