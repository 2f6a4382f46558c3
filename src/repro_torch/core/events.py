"""Minimal deterministic discrete-event simulation kernel.

OMG orchestration, drills and the failover benchmarks all run on this: a
priority queue of (time, seq, fn) with a monotonically advancing clock.

Observability: attaching a ``repro_torch.obs.Tracer`` (``loop.tracer = t``, or
``Orchestrator(..., tracer=t)``) turns every fired event into a sim-time
span on the Chrome trace — spanning *scheduled-at → fired-at*, i.e. the
window the orchestration was waiting on that action (handlers run in
zero sim-time; their host wall-time is attached as an arg) — and every
``log()`` into an instant marker.  With no tracer attached the loop does
no per-event bookkeeping at all.
"""

from __future__ import annotations

import heapq
import itertools
import time
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch import obs


class EventLoop:
    def __init__(self):
        # (fire_time, seq, fn, label)
        self._q: List[Tuple[float, int, Callable, str]] = []
        self._seq = itertools.count()
        self.now: float = 0.0
        self._trace: List[Tuple[float, str]] = []
        self.tracer = None                    # optional repro_torch.obs.Tracer
        self._sched: Dict[int, float] = {}    # seq -> scheduled-at (tracer only)

    def schedule(self, delay: float, fn: Callable, label: str = ""):
        assert delay >= 0, delay
        seq = next(self._seq)
        if self.tracer is not None:
            self._sched[seq] = self.now
        heapq.heappush(self._q, (self.now + delay, seq, fn, label))

    def log(self, msg: str):
        self._trace.append((self.now, msg))
        if self.tracer is not None:
            self.tracer.sim_instant(msg, self.now)

    @property
    def trace(self):
        return list(self._trace)

    def run(self, until: Optional[float] = None,
            max_events: int = 10_000_000) -> int:
        n = 0
        while self._q:
            if n >= max_events:
                # fail LOUDLY: a schedule that re-enqueues itself (e.g. a
                # buggy chaos-storm schedule) used to spin to the cap and
                # silently return a half-run simulation
                head_t, _, head_fn, head_label = self._q[0]
                raise RuntimeError(
                    f"EventLoop.run exceeded max_events={max_events} at "
                    f"sim time {self.now:.3f}s with {len(self._q)} events "
                    f"still queued (next: "
                    f"{head_label or getattr(head_fn, '__name__', 'event')!r}"
                    f" at t={head_t:.3f}s) — a schedule is likely "
                    f"re-enqueueing itself; raise max_events if the "
                    f"workload is legitimately this large")
            t, seq, fn, label = heapq.heappop(self._q)
            if until is not None and t > until:
                # re-push with the ORIGINAL seq: a fresh seq would reorder
                # this event behind later-scheduled same-time events on the
                # next run() call
                heapq.heappush(self._q, (t, seq, fn, label))
                break
            self.now = max(self.now, t)
            if self.tracer is not None:
                name = label or getattr(fn, "__name__", "event")
                t_sched = self._sched.pop(seq, t)
                host0 = time.perf_counter()
                fn()
                self.tracer.sim_span(
                    name, t_sched, t,
                    args={"host_ms": round(
                        (time.perf_counter() - host0) * 1e3, 3)})
            else:
                fn()
            if obs.enabled():
                obs.inc("ufa_orch_events_total",
                        label=label or getattr(fn, "__name__", "event"))
            n += 1
        return n
