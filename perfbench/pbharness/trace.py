"""The traced run: ranges around the program's layers, the profiler's
device trace, and what the per-layer metrics read from them.

The benchmark opens its ranges from its own code: each span a metric
names (``SPANS`` in ``metrics/<name>.py``, a module attribute of the
program such as ``repro_torch.kernels.ops.flash_attention``) is wrapped
(``Patches``) so that, while tracing, each call opens a
``torch.profiler`` range named ``pb:<attribute>`` and records its
arguments' shapes and dtypes.  A device operation belongs to every range open on the
host thread when it was launched (linked by the profiler's correlation
id), so a layer's device time includes its kernels'.
"""

from __future__ import annotations

import bisect
import importlib
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch

PREFIX = "pb:"
STEP = "pb:step"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _describe(a):
    if isinstance(a, torch.Tensor):
        return {"shape": list(a.shape), "dtype": a.dtype,
                "itemsize": a.element_size()}
    if isinstance(a, (int, float, bool, str)) or a is None:
        return a
    return type(a).__name__


class Patches:
    """Module attributes of the program replaced by wrappers, and put
    back: the one way the benchmark hooks the program.  The program calls
    these through their modules' attributes, so a wrapper sees every
    call.  Wrappers of one attribute stack; ``remove`` undoes them in
    reverse order."""

    def __init__(self):
        self._undo = []

    def wrap(self, path: str, make: Callable) -> None:
        """Replace the attribute ``path`` (``module.attr``) by
        ``make(original)``."""
        mod_name, attr = path.rsplit(".", 1)
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr)
        wrapper = make(fn)
        wrapper.__wrapped__ = fn
        setattr(mod, attr, wrapper)
        self._undo.append((mod, attr, fn))

    def remove(self) -> None:
        for mod, attr, fn in reversed(self._undo):
            setattr(mod, attr, fn)
        self._undo = []


class Spans:
    """Ranges around module attributes of the program; they record and
    open ranges only while ``active``."""

    def __init__(self, paths: List[str], patches: Patches):
        self.active = False
        self.calls: Dict[str, List[dict]] = defaultdict(list)
        for path in dict.fromkeys(paths):
            patches.wrap(path, lambda fn, path=path: self._wrap(path, fn))

    def _wrap(self, path, fn):
        label = PREFIX + path

        def wrapper(*args, **kwargs):
            if not self.active:
                return fn(*args, **kwargs)
            self.calls[path].append({
                "args": [_describe(a) for a in args],
                "kwargs": {k: _describe(v) for k, v in kwargs.items()}})
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return wrapper


class Profile:
    """``torch.profiler`` over the traced steps of a run."""

    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile
        self.cuda = torch.device(device).type == "cuda"
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if self.cuda else [])
        self.prof = profile(activities=acts)
        self.events: Optional[list] = None

    def start(self):
        self.prof.start()

    def stop(self):
        if self.cuda:
            torch.cuda.synchronize()
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)


class TraceView:
    """What the per-layer metrics read: device seconds inside each range,
    the calls each span saw, the traced steps and their window."""

    def __init__(self, events: list, spans: Spans, steps: int,
                 window_s: float, context: dict):
        self.context = context
        self.steps = steps
        self.window_s = window_s
        self.calls = spans.calls
        self.device_s: Dict[str, float] = defaultdict(float)
        self.kernel_s: Dict[str, float] = defaultdict(float)
        self.unattributed_s = 0.0
        dev = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in DEVICE_CATS]
        launches = {e["args"]["correlation"]: e for e in events
                    if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS
                    and "correlation" in e.get("args", {})}
        ranges = [e for e in events if e.get("ph") == "X"
                  and e.get("cat") == "user_annotation"
                  and str(e.get("name", "")).startswith(PREFIX)]
        self._index_ranges(ranges)
        self.busy_s = _union_s(dev)
        for e in dev:
            self.kernel_s[e["name"]] += e["dur"] / 1e6
            launch = launches.get(e.get("args", {}).get("correlation"))
            names = self._open_at(launch) if launch else None
            if not names:
                self.unattributed_s += e["dur"] / 1e6
            for n in names or ():
                self.device_s[n] += e["dur"] / 1e6
        self.gaps = self._gaps(dev, launches)

    # -- ranges open on a thread at a host time --------------------------
    def _index_ranges(self, ranges):
        self._by_tid = defaultdict(list)
        for r in ranges:
            self._by_tid[r.get("tid")].append(
                (r["ts"], r["ts"] + r["dur"], r["name"][len(PREFIX):]))
        for rs in self._by_tid.values():
            rs.sort()
        self._starts = {t: [r[0] for r in rs] for t, rs in self._by_tid.items()}
        steps = [r for r in ranges if r["name"] == STEP]
        self.trace_window = ((min(r["ts"] for r in steps),
                              max(r["ts"] + r["dur"] for r in steps))
                             if steps else None)

    def _open_at(self, launch) -> List[str]:
        tid, ts = launch.get("tid"), launch["ts"]
        rs = self._by_tid.get(tid, [])
        hi = bisect.bisect_right(self._starts.get(tid, []), ts)
        return [name for s, e, name in rs[:hi] if s <= ts <= e]

    def innermost(self, launch) -> str:
        names = self._open_at(launch) if launch else []
        inner = [n for n in names if n != STEP[len(PREFIX):]]
        if inner:
            return inner[-1]
        return names[-1] if names else "outside the benchmark's ranges"

    def _gaps(self, dev, launches) -> Dict[str, float]:
        """Idle seconds of the device inside the traced steps, by the
        range the host had open when it launched the operation that ended
        each gap (what the device was waiting for)."""
        out: Dict[str, float] = defaultdict(float)
        if self.trace_window is None:
            return out
        lo, hi = self.trace_window
        t = lo
        for e in sorted(dev, key=lambda e: e["ts"]):
            if e["ts"] > t:
                gap_end = min(e["ts"], hi)
                if gap_end > t:
                    launch = launches.get(e.get("args", {}).get("correlation"))
                    out[self.innermost(launch)] += (gap_end - t) / 1e6
            t = max(t, e["ts"] + e["dur"])
        if hi > t:
            out["after the last operation of a step"] += (hi - t) / 1e6
        return out

    # -- for the metrics --------------------------------------------------
    def span_device_s(self, path: str) -> float:
        return self.device_s.get(path, 0.0)

    def breakdown(self, n: int = 10) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k[:160], v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def _union_s(dev: list) -> float:
    total, end = 0.0, None
    for e in sorted(dev, key=lambda e: e["ts"]):
        s, t = e["ts"], e["ts"] + e["dur"]
        if end is None or s > end:
            total += t - s
            end = t
        elif t > end:
            total += t - end
            end = t
    return total / 1e6
