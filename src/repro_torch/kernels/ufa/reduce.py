"""Segmented timeline verdict reduction: the CUDA kernel and its plain
PyTorch version.

Replaces ``repro/kernels/ufa/reduce.py::timeline_reduce`` (Pallas
``_reduce_kernel``).  Per scenario row of the ``(S, T)`` step series:

    avail_int  = sum_t availability * dt        (dt[0] = 0, scan parity)
    avail_min  = min(1, min_t availability)
    util_peak  = max(0, max_t util_model)
    cloud_peak = max(0, max_t cloud_used)
    below      = tier_frac < thresh             (S, T, R)
    seen       = cumulative-OR_t below
    restore_t  = min_t { ts[t] : seen[t] & ~below[t] }   (inf if never)
    below_seen = seen[:, -1, :]

Min/max/first-crossing outputs are exact against the reference's
sequential scan; ``avail_int`` is a float32 sum in another order
(float32-tight).  The kernel (``csrc/timeline_reduce.cu``) says what
bounds it and how its design answers that.  ``timeline_reduce`` launches
it for CUDA tensors and takes ``ref_timeline_reduce`` for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import build

MAX_TIERS = 8                   # the kernel keeps per-tier state in registers


def ref_timeline_reduce(avail: torch.Tensor, util: torch.Tensor,
                        cloud: torch.Tensor, tier_frac: torch.Tensor,
                        ts: torch.Tensor, *, thresh: float
                        ) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version: same math, whole-slab tensor ops."""
    dt = torch.clamp(torch.diff(ts, prepend=ts[:1]), min=0.0)
    below = tier_frac < thresh
    seen = torch.cumsum(below, dim=1, dtype=torch.int32) > 0
    crossed = seen & ~below
    return {
        "avail_int": (avail * dt[None, :]).sum(dim=1),
        "avail_min": torch.clamp(avail.amin(dim=1), max=1.0),
        "util_peak": torch.clamp(util.amax(dim=1), min=0.0),
        "cloud_peak": torch.clamp(cloud.amax(dim=1), min=0.0),
        "restore_t": torch.where(crossed, ts[None, :, None],
                                 float("inf")).amin(dim=1),
        "below_seen": seen[:, -1, :],
    }


def _lib():
    lib = build.load("timeline_reduce")
    fn = lib.timeline_reduce_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, ctypes.c_float,
                       p, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def timeline_reduce(avail: torch.Tensor, util: torch.Tensor,
                    cloud: torch.Tensor, tier_frac: torch.Tensor,
                    ts: torch.Tensor, *, thresh: float
                    ) -> Dict[str, torch.Tensor]:
    """avail/util/cloud (S, T) f32, tier_frac (S, T, R) f32, ts (T,) f32
    -> the scan-carry equivalents: four (S,) f32, restore_t (S, R) f32,
    below_seen (S, R) bool.  CUDA tensors launch the kernel; CPU tensors
    take ``ref_timeline_reduce``."""
    if avail.device.type == "cpu":
        return ref_timeline_reduce(avail, util, cloud, tier_frac, ts,
                                   thresh=thresh)
    if avail.device.type != "cuda":
        raise ValueError(f"timeline_reduce: no kernel for {avail.device}")
    S, T = avail.shape
    R = tier_frac.shape[2]
    args = (avail, util, cloud, tier_frac, ts)
    if any(a.dtype != torch.float32 or a.device != avail.device
           for a in args):
        raise TypeError("timeline_reduce: float32 tensors on one device")
    if (util.shape != (S, T) or cloud.shape != (S, T)
            or tier_frac.shape != (S, T, R) or ts.shape != (T,)):
        raise ValueError("timeline_reduce: inconsistent shapes")
    if T < 1 or R > MAX_TIERS:
        raise ValueError(f"timeline_reduce: needs T >= 1 and R <= "
                         f"{MAX_TIERS}, got T={T}, R={R}")
    avail, util, cloud, tier_frac, ts = (a.contiguous() for a in args)
    f32 = dict(dtype=torch.float32, device=avail.device)
    out = {"avail_int": torch.empty(S, **f32),
           "avail_min": torch.empty(S, **f32),
           "util_peak": torch.empty(S, **f32),
           "cloud_peak": torch.empty(S, **f32),
           "restore_t": torch.empty((S, R), **f32),
           "below_seen": torch.empty((S, R), dtype=torch.bool,
                                     device=avail.device)}
    if S == 0:
        return out
    launch = _lib()
    with torch.cuda.device(avail.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(avail.data_ptr(), util.data_ptr(), cloud.data_ptr(),
                    tier_frac.data_ptr(), ts.data_ptr(), S, T, R,
                    float(thresh), out["avail_int"].data_ptr(),
                    out["avail_min"].data_ptr(), out["util_peak"].data_ptr(),
                    out["cloud_peak"].data_ptr(), out["restore_t"].data_ptr(),
                    out["below_seen"].data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"timeline_reduce kernel launch failed: "
                           f"cudaError {rc}")
    timeline_reduce.launches += 1
    return out


timeline_reduce.launches = 0
