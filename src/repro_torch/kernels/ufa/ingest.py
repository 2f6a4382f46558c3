"""Outcome-code histogram of one telemetry chunk: the CUDA kernels, their
routes, and the plain PyTorch version.

Replaces ``repro/kernels/ufa/ingest.py::ingest_hist`` (Pallas
``_hist_kernel``).  Each record gets the 2-bit outcome code

    code = 2 * callee_failed + caller_errored

and one pass counts ``(edge_id, code)`` pairs into an ``(n_edges, 4)``
int32 histogram — column 0 = clean call, 1 = error without failure, 2 =
failure absorbed, 3 = failure propagated — from which the detector's
four columns derive.  Ids outside ``[0, n_edges)`` are dropped: the
reference's positive pad sentinel is dropped as it is there, and a
negative id (which the reference would wrap; no caller makes one) is
dropped too.  Integer counts are exact on either device.

``ingest_hist`` takes ``ref_ingest_hist`` for CPU tensors.  For CUDA
tensors ``ingest_hist_route`` picks, from ``n_edges`` alone, one of the
two routes of ``csrc/ingest_hist.cu`` (which says what bounds each):
``"buckets"``, records partitioned into 16 bin ranges and each range
counted in CTAs' shared memory, or ``"global"``, one global atomic a
record, for universes whose sixteenth does not fit a CTA.
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


RANGES = 16                # bin ranges of the buckets route: edge e % 16
TILE = 8192                # records a partition CTA (csrc/ingest_hist.cu)
# the largest n_edges on the buckets route
LIMIT = backend.SMEM_OPTIN // (N_CODES * 4) * RANGES


def range_bytes(n_edges: int) -> int:
    """Shared memory of one counting CTA of the buckets route: a range's
    ``ceil(n_edges / 16)`` edges of four int32 codes."""
    return -(-n_edges // RANGES) * N_CODES * 4


def ingest_hist_route(n_edges: int) -> str:
    """The CUDA route for a universe of ``n_edges`` edges: ``"buckets"``
    when a CTA's shared memory holds a sixteenth of the histogram (up to
    232,448 edges), else ``"global"``.  A pure function of the shape: the
    route is never chosen by a failure."""
    if n_edges < 0:
        raise ValueError(f"ingest_hist_route: n_edges={n_edges}")
    if range_bytes(n_edges) <= backend.SMEM_OPTIN:
        return "buckets"
    return "global"


def _lib(entry: str = "ingest_hist_buckets_launch"):
    lib = build.load("ingest_hist")
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = {
            "ingest_hist_launch": [p, p, p, ll, i, p, p],
            "ingest_hist_buckets_launch": [p, p, p, ll, i, p, p, p, i, p, p],
        }[entry]
        fn.restype = ctypes.c_int
    return fn


_SM_COUNT = {}


def _sms(dev: torch.device) -> int:
    """The card's SM count (looked up once a device)."""
    if dev not in _SM_COUNT:
        _SM_COUNT[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SM_COUNT[dev]


def _check(edge_id: torch.Tensor, callee_failed: torch.Tensor,
           caller_errored: torch.Tensor, n_edges) -> int:
    """``n_edges`` as an int; raises for inputs the kernels do not take.
    Reads only dtype and shape, so it takes ``meta`` tensors too."""
    if (edge_id.dtype != torch.int32 or callee_failed.dtype != torch.bool
            or caller_errored.dtype != torch.bool):
        raise TypeError("ingest_hist: edge_id int32, callee_failed and "
                        "caller_errored bool")
    N = edge_id.shape[0] if edge_id.dim() == 1 else -1
    if (N < 0 or callee_failed.shape != (N,)
            or caller_errored.shape != (N,)):
        raise ValueError("ingest_hist: three (N,) tensors")
    n_edges = int(n_edges)
    if not 0 <= n_edges < 2 ** 31:
        raise ValueError(f"ingest_hist: n_edges={n_edges} out of range")
    return n_edges


def ingest_hist(edge_id: torch.Tensor, callee_failed: torch.Tensor,
                caller_errored: torch.Tensor, n_edges: int) -> torch.Tensor:
    """One chunk -> ``(n_edges, 4)`` int32 outcome-code histogram.
    ``edge_id`` (N,) int32, ``callee_failed`` and ``caller_errored`` (N,)
    bool.  CPU tensors take ``ref_ingest_hist``; CUDA tensors take the
    route ``ingest_hist_route`` names, each call counted once in
    ``ingest_hist.launches``.  An empty chunk or ``n_edges == 0`` gives
    zeros without a launch."""
    tensors = (edge_id, callee_failed, caller_errored)
    if all(t.device.type == "cpu" for t in tensors):
        return ref_ingest_hist(edge_id, callee_failed, caller_errored,
                               n_edges)
    n_edges = _check(*tensors, n_edges)
    backend.kernel_route("ingest_hist", *tensors)
    N = edge_id.shape[0]
    dev = edge_id.device
    if N == 0 or n_edges == 0:
        return torch.zeros((n_edges, N_CODES), dtype=torch.int32,
                           device=dev)
    eid, failed, errored = (t.contiguous() for t in tensors)
    counts = torch.empty((n_edges, N_CODES), dtype=torch.int32, device=dev)
    if ingest_hist_route(n_edges) == "buckets":
        # one partial histogram a counting CTA of a range: as many as
        # fill the card at one CTA an SM, at most one a tile; the keys,
        # the offsets and the partials share one scratch buffer
        tiles = -(-N // TILE)
        parts = max(1, min(tiles, _sms(dev) // RANGES))
        sizes = (2 * tiles * TILE, 4 * tiles * (RANGES + 1),
                 parts * RANGES * range_bytes(n_edges))
        at = [0]
        for size in sizes:
            at.append(at[-1] + -(-size // 256) * 256)
        scratch = torch.empty(at[-1], dtype=torch.uint8, device=dev)
        base = scratch.data_ptr()
        backend.launch("ingest_hist", _lib(), eid.data_ptr(),
                       failed.data_ptr(), errored.data_ptr(), N, n_edges,
                       base + at[0], base + at[1], base + at[2], parts,
                       counts.data_ptr(), device=dev)
    else:
        backend.launch("ingest_hist", _lib("ingest_hist_launch"),
                       eid.data_ptr(), failed.data_ptr(),
                       errored.data_ptr(), N, n_edges, counts.data_ptr(),
                       device=dev)
    ingest_hist.launches += 1
    return counts


ingest_hist.launches = 0
