"""Structured span/event tracing with Chrome trace-event JSON export.

A ``Tracer`` collects *spans* (things with a beginning and a duration)
and *instants* (point events) and serialises them to the Chrome
trace-event format — ``chrome://tracing`` / https://ui.perfetto.dev
load the file directly, so a failover becomes a scrollable timeline:
MBB eviction waves, burst-capacity conversion, cloud restores and
traffic-shift milestones each render as real-width bars.

Two clock domains share one trace, kept apart as separate *processes*
(Perfetto renders them as separate tracks):

  * **sim** (pid ``SIM_PID``) — discrete-event simulation time.  The
    event loop runs handlers in zero sim-time, so a span's extent is
    *scheduled-at → fired-at*: exactly the window the orchestrator was
    "waiting on" that action, which is what an operator wants to see
    (a 45 s MBB wave shows up 45 s wide).  Handler host wall-time is
    attached as an arg instead.
  * **host** (pid ``HOST_PID``) — wall-clock phases from
    ``Profiler``/``Tracer.span()`` (ingest, compile, sweep, export) and
    the program's own spans (``span`` below).  Its clock is the one
    ``torch.profiler`` writes: microseconds from a zero taken when the
    ``Tracer`` is made, that zero's wall-clock time written as the
    export's ``baseTimeNanoseconds``, so ``ts + baseTimeNanoseconds /
    1e3`` is the same instant in this file and in a profiler's export.
    Durations are read on the monotonic clock from that zero, so a step
    of the wall clock moves no span.

Timestamps are microseconds (the format's native unit); sim seconds
map 1 s → 1 µs·1e6 so durations read naturally in Perfetto's ruler.

The program's spans and counters (``tracing``, ``span``, ``add``,
``counters``) sit on the model path behind one gate: they are on while
a ``Tracer`` is attached (``set_tracer``) or while a ``torch.profiler``
records, and cost one check each when off.  A span on opens a
``torch.profiler.record_function`` range named ``SPAN_PREFIX + name``
while a profiler records, so it sits in the profiler's trace on the
device trace's clock and the kernels launched inside it correlate to
it, and adds a bar to the attached ``Tracer``'s host track.  Importing
this module pulls in no torch: torch is reached only through
``sys.modules``, once a caller has imported it.
"""

from __future__ import annotations

import itertools
import json
import sys
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

SIM_PID = 1       # simulation-time track
HOST_PID = 2      # wall-clock track
SPAN_PREFIX = "ufa:"  # the program's ranges in a profiler's trace

_S_TO_US = 1e6


class Tracer:
    """Collects trace events; thread-safe; cheap to leave attached."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self.base_ns = time.time_ns()           # the zero, wall clock
        self._zero_ns = time.perf_counter_ns()  # the zero, monotonic
        self._meta_done = set()
        self._meta(SIM_PID, "sim (event loop)")
        self._meta(HOST_PID, "host (wall clock)")

    # -- low-level emitters --------------------------------------------
    def _meta(self, pid: int, name: str, tid: int = 0):
        key = (pid, tid)
        if key in self._meta_done:
            return
        self._meta_done.add(key)
        self._events.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": name}})
        self._events.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": name}})

    def complete(self, name: str, ts_us: float, dur_us: float,
                 pid: int = SIM_PID, tid: int = 0,
                 args: Optional[Dict[str, Any]] = None):
        """A 'X' (complete) event: one bar from ts to ts+dur."""
        ev: Dict[str, Any] = {
            "name": name, "ph": "X", "pid": pid, "tid": tid,
            "ts": float(ts_us), "dur": max(float(dur_us), 0.0),
            "cat": "sim" if pid == SIM_PID else "host"}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def instant(self, name: str, ts_us: float, pid: int = SIM_PID,
                tid: int = 0, args: Optional[Dict[str, Any]] = None):
        """An 'i' (instant) event: a point-in-time marker."""
        ev: Dict[str, Any] = {
            "name": name, "ph": "i", "pid": pid, "tid": tid,
            "ts": float(ts_us), "s": "p",
            "cat": "sim" if pid == SIM_PID else "host"}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    # -- sim-time conveniences (seconds in, µs stored) ------------------
    def sim_span(self, name: str, t_start_s: float, t_end_s: float,
                 args: Optional[Dict[str, Any]] = None):
        self.complete(name, t_start_s * _S_TO_US,
                      (t_end_s - t_start_s) * _S_TO_US,
                      pid=SIM_PID, args=args)

    def sim_instant(self, name: str, t_s: float,
                    args: Optional[Dict[str, Any]] = None):
        self.instant(name, t_s * _S_TO_US, pid=SIM_PID, args=args)

    # -- host wall-clock span ------------------------------------------
    def host_us(self, t_ns: int) -> float:
        """A ``time.perf_counter_ns()`` reading on the host track's
        clock."""
        return (t_ns - self._zero_ns) / 1e3

    def _host_now_us(self) -> float:
        return self.host_us(time.perf_counter_ns())

    @contextmanager
    def span(self, name: str, **args):
        """Wall-clock span on the host track (profiler phases)."""
        t0 = self._host_now_us()
        try:
            yield self
        finally:
            self.complete(name, t0, self._host_now_us() - t0,
                          pid=HOST_PID, args=args or None)

    # -- export ---------------------------------------------------------
    def to_chrome(self) -> Dict[str, Any]:
        with self._lock:
            return {"traceEvents": list(self._events),
                    "displayTimeUnit": "ms",
                    "baseTimeNanoseconds": self.base_ns}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path

    def __len__(self) -> int:
        return len(self._events)


# ---------------------------------------------------------------------------
# Optional process-global tracer (None unless a run attaches one).
# ---------------------------------------------------------------------------

_TRACER: Optional[Tracer] = None


def get_tracer() -> Optional[Tracer]:
    return _TRACER


def set_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    global _TRACER
    prev, _TRACER = _TRACER, tracer
    return prev


# ---------------------------------------------------------------------------
# The program's spans and counters, behind one gate.
# ---------------------------------------------------------------------------

_profiler_enabled = None   # torch's own check, bound once torch is loaded


def _profiling() -> bool:
    global _profiler_enabled
    if _profiler_enabled is None:
        torch = sys.modules.get("torch")
        if torch is None:          # no torch, so no profiler records
            return False
        _profiler_enabled = torch._C._autograd._profiler_enabled
    return _profiler_enabled()


def tracing() -> bool:
    """True while a ``Tracer`` is attached or a torch profiler records:
    the gate of ``span`` and ``add``."""
    return _TRACER is not None or _profiling()


class _NullSpan:
    """What ``span`` returns when tracing is off: one shared object."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()
_span_ids = itertools.count(1)
_open = threading.local()         # the spans open on each thread
_counts: Dict[str, Any] = {}
_totals_lock = threading.Lock()   # the totals take adds from any thread


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "_range", "_t0")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        parent = stack[-1] if stack else None
        self.id = next(_span_ids)
        self.parent = parent.id if parent is not None else None
        if parent is not None and parent.attrs:   # a call's id, the layer
            self.attrs = {**parent.attrs, **self.attrs}
        stack.append(self)
        # the clock is read outside the range: its first opening in a
        # process takes most of a millisecond after its own start
        self._t0 = time.perf_counter_ns()
        self._range = None
        if _profiling():
            self._range = sys.modules["torch"].autograd.profiler \
                .record_function(SPAN_PREFIX + self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
        t1 = time.perf_counter_ns()
        _open.stack.pop()
        tracer = _TRACER
        if tracer is not None:
            tracer.complete(SPAN_PREFIX + self.name, tracer.host_us(self._t0),
                            (t1 - self._t0) / 1e3, pid=HOST_PID,
                            args={"id": self.id, "parent": self.parent,
                                  **self.attrs})
        return False


def span(name: str, **attrs):
    """A span of the program around a block: a do-nothing context shared
    by every call when tracing is off; when on, a ``torch.profiler``
    range ``SPAN_PREFIX + name`` (while a profiler records) and a bar on
    the attached ``Tracer``'s host track with its id, its parent span's id
    and ``attrs`` (a child carries its parents' attrs)."""
    if not tracing():
        return _NULL_SPAN
    return _Span(name, attrs)


def _in_backward() -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and torch._C._current_graph_task_id() >= 0


def add(name: str, value) -> None:
    """Add ``value`` (a Python number or a 0-d tensor, summed on its
    device without a synchronise) to the counter ``name``; nothing when
    tracing is off, nor inside autograd's backward pass, where a
    checkpointed layer runs its forward a second time."""
    if not tracing() or _in_backward():
        return
    with _totals_lock:
        prev = _counts.get(name)
        _counts[name] = value if prev is None else prev + value


def counters() -> Dict[str, float]:
    """The counters' totals as host numbers (integers where counted in
    integers); one synchronise a device, here."""
    with _totals_lock:
        counts = dict(_counts)
    out = {k: v for k, v in counts.items() if isinstance(v, (int, float))}
    by_device = defaultdict(list)
    for k, v in counts.items():
        if k not in out:
            by_device[v.device].append((k, v))
    for kvs in by_device.values():
        torch = sys.modules["torch"]
        vals = torch.stack([v.detach().to(torch.float64)
                            for _, v in kvs]).tolist()
        for (k, v), x in zip(kvs, vals):
            out[k] = x if v.is_floating_point() else int(x)
    return out


def reset_counters() -> None:
    """Clear the counters."""
    with _totals_lock:
        _counts.clear()


def validate_chrome_trace(obj: Any) -> List[str]:
    """Schema-check a Chrome trace object; returns a list of problems
    (empty == valid).  Used by tests and the CI smoke step."""
    errs: List[str] = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["top level must be an object with 'traceEvents'"]
    evs = obj["traceEvents"]
    if not isinstance(evs, list) or not evs:
        return ["'traceEvents' must be a non-empty list"]
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            errs.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "i", "I", "M", "B", "E", "C"):
            errs.append(f"event {i}: bad ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str):
            errs.append(f"event {i}: missing name")
        if not isinstance(ev.get("pid"), int):
            errs.append(f"event {i}: missing pid")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errs.append(f"event {i}: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"event {i}: bad dur {dur!r}")
    return errs
