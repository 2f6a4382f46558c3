"""Cost recorder: FLOPs, bytes, peak live bytes and collectives of a run.

The port's cost source for the dry run and the roofline (the reference
reads XLA's ``cost_analysis`` and HLO text; a torch program has
neither).  Inside ``with CostRecorder() as rec:``

  * FLOPs come from ``torch.utils.flop_counter.FlopCounterMode`` (the
    matrix products, attention and convolutions of every aten op), plus
    each model kernel's own operations: B4-B8 launch through ctypes,
    where no dispatch mode sees them, so each wrapper adds its count
    (``add_kernel``, the counts of its bound in ``PERF.md`` §6);
  * bytes are the sum over aten ops of their input and output bytes
    (views and allocations excluded), an upper bound like XLA's "bytes
    accessed", plus each kernel's bound bytes;
  * ``peak_bytes`` is the most tensor storage alive at once: the
    ``base`` tensors given, plus every op output until it is freed;
  * ``collectives`` are ``dist.smap``'s records ``(kind, result bytes,
    group size, nvlink)``.

A kernel wrapper's plain version (the CPU route) runs with the modes
suspended (``plain()``) and the kernel's count is added instead, so a
CPU, a CUDA and a ``meta`` run of one program count the same FLOPs.
While a recorder is active, and only then, the wrappers take a ``meta``
route (``kernels.backend.kernel_route``): the kernel's checks, an empty
output of the right shape, and the count.
"""

from __future__ import annotations

import weakref
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes,
                                          _get_current_dispatch_mode_stack)
from torch.utils.flop_counter import FlopCounterMode

# allocations and metadata ops: no bytes move
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "lift_fresh", "detach", "alias",
             "_local_scalar_dense"}


def active() -> Optional["CostRecorder"]:
    """The innermost active recorder, or None: found on the dispatch
    mode stack, which autograd carries to its device threads (a CUDA
    backward, the remat recompute in it, runs on one of them)."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, _BytesMode):
            return mode.rec
    return None


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor):
    try:
        st = t.untyped_storage()
        return st._cdata, st.nbytes()
    except Exception:       # a tensor without storage (sparse, nested)
        return None, 0


class _BytesMode(TorchDispatchMode):
    """Counts each aten op's input and output bytes and tracks the live
    storage of its outputs."""

    def __init__(self, rec: "CostRecorder"):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if func.is_view or name in _NO_BYTES:
            if not func.is_view:
                self.rec._track(out, args, kwargs)
            return out
        seen = set()
        moved = 0
        for t in _tensors(args) + _tensors(kwargs) + _tensors(out):
            if id(t) not in seen:
                seen.add(id(t))
                moved += _nbytes(t)
        self.rec.op_bytes += moved
        self.rec._track(out, args, kwargs)
        return out


class CostRecorder:
    """``with CostRecorder(base=tree) as rec:`` records the run inside;
    read ``rec.flops``, ``rec.bytes``, ``rec.peak_bytes``,
    ``rec.collectives`` and ``rec.kernels`` after (or during) it."""

    def __init__(self, base=None):
        self.kernel_flops = 0
        self.kernel_bytes = 0
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.op_bytes = 0
        self.collectives: List[Tuple[str, int, int, bool]] = []
        self._storages: Dict[int, List[int]] = {}
        seen = set()
        self.base_bytes = 0
        for t in _tensors(base):
            key, n = _storage_key(t)
            if key is not None and key not in seen:
                seen.add(key)
                self.base_bytes += n
        self.live = self.base_bytes
        self.peak_bytes = self.base_bytes
        self._flops = FlopCounterMode(display=False)
        self._bytes = _BytesMode(self)

    # -- recording ------------------------------------------------------
    def _track(self, out, args, kwargs):
        inputs = {id(t) for t in _tensors(args) + _tensors(kwargs)}
        for t in _tensors(out):
            if id(t) in inputs:
                continue                       # in place: nothing new
            key, n = _storage_key(t)
            if key is None:
                continue
            entry = self._storages.get(key)
            if entry is None:
                self._storages[key] = entry = [n, 0]
                self.live += n
                self.peak_bytes = max(self.peak_bytes, self.live)
            entry[1] += 1
            weakref.finalize(t, self._release, key)

    def _release(self, key):
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._storages[key]

    def add_kernel(self, name: str, flops: int, nbytes: int) -> None:
        self.kernel_flops += int(flops)
        self.kernel_bytes += int(nbytes)
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                           "bytes": 0})
        k["calls"] += 1
        k["flops"] += int(flops)
        k["bytes"] += int(nbytes)

    def add_collective(self, kind: str, nbytes: int, group: int,
                       nvlink: bool) -> None:
        self.collectives.append((kind, int(nbytes), int(group), bool(nvlink)))

    # -- totals ---------------------------------------------------------
    @property
    def flops(self) -> int:
        return int(self._flops.get_total_flops()) + self.kernel_flops

    @property
    def bytes(self) -> int:
        return self.op_bytes + self.kernel_bytes

    def __enter__(self):
        self._flops.__enter__()
        self._bytes.__enter__()
        return self

    def __exit__(self, *exc):
        self._bytes.__exit__(*exc)
        self._flops.__exit__(*exc)
        return False


@contextmanager
def plain():
    """Run the body unseen by the active recorder's dispatch modes (a
    kernel wrapper's plain version, whose kernel count is added
    instead)."""
    with _disable_current_modes():
        yield
