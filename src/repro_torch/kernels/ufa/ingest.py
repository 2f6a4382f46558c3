"""Outcome-code histogram of one telemetry chunk: the CUDA kernel and its
plain PyTorch version.

Replaces ``repro/kernels/ufa/ingest.py::ingest_hist`` (Pallas
``_hist_kernel``).  Each record gets the 2-bit outcome code

    code = 2 * callee_failed + caller_errored

and one pass counts ``(edge_id, code)`` pairs into an ``(n_edges, 4)``
int32 histogram — column 0 = clean call, 1 = error without failure, 2 =
failure absorbed, 3 = failure propagated — from which the detector's
four columns derive.  Ids outside ``[0, n_edges)`` are dropped: the
reference's positive pad sentinel is dropped as it is there, and a
negative id (which the reference would wrap; no caller makes one) is
dropped too.  Integer counts are exact on either device.  The kernel
(``csrc/ingest_hist.cu``) says what bounds it and how its design answers
that.  ``ingest_hist`` launches it for CUDA tensors and takes
``ref_ingest_hist`` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend, build

N_CODES = 4                      # 2-bit outcome code


def ref_ingest_hist(edge_id: torch.Tensor, callee_failed: torch.Tensor,
                    caller_errored: torch.Tensor,
                    n_edges: int) -> torch.Tensor:
    """Plain PyTorch version: mask the ids to ``[0, n_edges)``, then one
    ``bincount`` of ``id * 4 + code`` (64-bit bins)."""
    eid = edge_id.to(torch.int64)
    keep = (eid >= 0) & (eid < n_edges)
    code = (callee_failed.to(torch.int64) * 2
            + caller_errored.to(torch.int64))
    flat = torch.bincount((eid * N_CODES + code)[keep],
                          minlength=N_CODES * n_edges)
    return flat.view(-1, N_CODES).to(torch.int32)


def _lib():
    lib = build.load("ingest_hist")
    fn = lib.ingest_hist_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, ctypes.c_longlong, ctypes.c_int, p, p]
        fn.restype = ctypes.c_int
    return fn


def ingest_hist(edge_id: torch.Tensor, callee_failed: torch.Tensor,
                caller_errored: torch.Tensor, n_edges: int) -> torch.Tensor:
    """One chunk -> ``(n_edges, 4)`` int32 outcome-code histogram.
    ``edge_id`` (N,) int32, ``callee_failed`` and ``caller_errored`` (N,)
    bool.  CUDA tensors launch the kernel (counted in
    ``ingest_hist.launches``); CPU tensors take ``ref_ingest_hist``.  An
    empty chunk or ``n_edges == 0`` gives zeros without a launch."""
    if backend.kernel_route("ingest_hist", edge_id, callee_failed,
                            caller_errored) == "cpu":
        return ref_ingest_hist(edge_id, callee_failed, caller_errored,
                               n_edges)
    if (edge_id.dtype != torch.int32 or callee_failed.dtype != torch.bool
            or caller_errored.dtype != torch.bool):
        raise TypeError("ingest_hist: edge_id int32, callee_failed and "
                        "caller_errored bool")
    N = edge_id.shape[0]
    if (edge_id.dim() != 1 or callee_failed.shape != (N,)
            or caller_errored.shape != (N,)):
        raise ValueError("ingest_hist: three (N,) tensors")
    n_edges = int(n_edges)
    if not 0 <= n_edges < 2 ** 31:
        raise ValueError(f"ingest_hist: n_edges={n_edges} out of range")
    if N == 0 or n_edges == 0:
        return torch.zeros((n_edges, N_CODES), dtype=torch.int32,
                           device=edge_id.device)
    eid, failed, errored = (edge_id.contiguous(), callee_failed.contiguous(),
                            caller_errored.contiguous())
    counts = torch.empty((n_edges, N_CODES), dtype=torch.int32,
                         device=edge_id.device)
    backend.launch("ingest_hist", _lib(), eid.data_ptr(), failed.data_ptr(),
                   errored.data_ptr(), N, n_edges, counts.data_ptr(),
                   device=edge_id.device)
    ingest_hist.launches += 1
    return counts


ingest_hist.launches = 0
