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
(float32-tight).

``timeline_reduce`` launches the kernel (``csrc/timeline_reduce.cu``,
which says what bounds it and how its design answers that) for CUDA
tensors and takes ``ref_timeline_reduce`` for CPU tensors.  The kernel
writes one ``(S, 4)`` stats array, the Pallas kernel's layout, whose
columns the result's four ``(S,)`` entries are.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import backend, build

MAX_TIERS = 8       # the kernel keeps tier r in lane r and picks it from 8 ballots


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
    fn = build.load("timeline_reduce").timeline_reduce_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, ctypes.c_float,
                       p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def _outputs(S: int, R: int, device):
    """One float32 buffer of ``S * (4 + R)`` values (stats ``(S, 4)``,
    the Pallas kernel's layout, then restore_t ``(S, R)``) and one bool
    ``(S, R)``; returns them and the result's views under its keys."""
    buf = torch.empty(S * (4 + R), dtype=torch.float32, device=device)
    seen = torch.empty((S, R), dtype=torch.bool, device=device)
    view = buf.as_strided       # one call a view: the wrapper's host time
    return buf, seen, {"avail_int": view((S,), (4,), 0),
                       "avail_min": view((S,), (4,), 1),
                       "util_peak": view((S,), (4,), 2),
                       "cloud_peak": view((S,), (4,), 3),
                       "restore_t": view((S, R), (R, 1), 4 * S),
                       "below_seen": seen}


def timeline_reduce(avail: torch.Tensor, util: torch.Tensor,
                    cloud: torch.Tensor, tier_frac: torch.Tensor,
                    ts: torch.Tensor, *, thresh: float
                    ) -> Dict[str, torch.Tensor]:
    """avail/util/cloud (S, T) f32, tier_frac (S, T, R) f32, ts (T,) f32
    -> the scan-carry equivalents: four (S,) f32, restore_t (S, R) f32,
    below_seen (S, R) bool.  CPU tensors take ``ref_timeline_reduce``;
    CUDA tensors launch the kernel (the four (S,) results are columns of
    one (S, 4) array)."""
    args = (avail, util, cloud, tier_frac, ts)
    if backend.kernel_route("timeline_reduce", *args) == "cpu":
        return ref_timeline_reduce(*args, thresh=thresh)
    S, T = avail.shape
    R = tier_frac.shape[2]
    if any(a.dtype != torch.float32 for a in args):
        raise TypeError("timeline_reduce: float32 tensors")
    if (util.shape != (S, T) or cloud.shape != (S, T)
            or tier_frac.shape != (S, T, R) or ts.shape != (T,)):
        raise ValueError("timeline_reduce: inconsistent shapes")
    if T < 1 or not 1 <= R <= MAX_TIERS:
        raise ValueError(f"timeline_reduce: needs T >= 1 and 1 <= R <= "
                         f"{MAX_TIERS}, got T={T}, R={R}")
    buf, seen, out = _outputs(S, R, avail.device)
    if S == 0:
        return out
    args = tuple(a.contiguous() for a in args)   # alive until the launch
    stats = buf.data_ptr()
    backend.launch("timeline_reduce", _lib(),
                   *[a.data_ptr() for a in args], S, T, R,
                   float(thresh), stats, stats + 16 * S, seen.data_ptr(),
                   device=avail.device)
    timeline_reduce.launches += 1
    return out


timeline_reduce.launches = 0
