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
    ``Profiler``/``Tracer.span()`` (ingest, compile, sweep, export).

Timestamps are microseconds (the format's native unit); sim seconds
map 1 s → 1 µs·1e6 so durations read naturally in Perfetto's ruler.
Zero third-party deps — stdlib ``json`` and ``time`` only.
"""

from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

SIM_PID = 1       # simulation-time track
HOST_PID = 2      # wall-clock track

_S_TO_US = 1e6


class Tracer:
    """Collects trace events; thread-safe; cheap to leave attached."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._t0_host = time.perf_counter()
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
    def _host_now_us(self) -> float:
        return (time.perf_counter() - self._t0_host) * _S_TO_US

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
                    "displayTimeUnit": "ms"}

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
