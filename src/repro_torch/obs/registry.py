"""Labeled metrics registry — the substrate of the observability plane.

Prometheus-shaped primitives (``Counter`` / ``Gauge`` / ``Histogram``,
each optionally labeled) collected into a ``Registry``, plus one
process-global *default* registry that every instrumented call site in
the repro reports into.  Two properties matter more than features:

  * **off by default, free when off** — the default registry starts
    disabled, and the hot-path helpers in ``repro_torch.obs`` bail on a single
    module-level bool before touching any metric object, so the fused
    sweep engine / telemetry ingest pay one branch per *call* (not per
    record) when observability is off;
  * **zero dependencies** — plain Python + a ``threading.Lock``; nothing
    here imports jax/numpy, so ``repro_torch.core`` modules can import the
    plane without ordering constraints.

Updates are lock-protected (callbacks may fire from worker threads or
re-entrantly from inside event-loop handlers); child creation is
idempotent, so ``registry.counter(name, ...)`` at a call site is a cheap
get-or-create, not a redefinition.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# default histogram buckets: wall-time seconds from sub-ms dispatch to
# multi-minute end-to-end phases
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0)

LabelKey = Tuple[Tuple[str, str], ...]      # sorted ((name, value), ...)


def _label_key(names: Tuple[str, ...], kw: Dict[str, object]) -> LabelKey:
    if set(kw) != set(names):
        raise ValueError(f"labels {sorted(kw)} != declared {sorted(names)}")
    return tuple(sorted((k, str(v)) for k, v in kw.items()))


class _Child:
    """One labeled series of a metric (or the metric's only series when
    it is label-less)."""

    __slots__ = ("_m", "value", "bucket_counts", "sum", "count")

    def __init__(self, metric: "Metric"):
        self._m = metric
        self.value = 0.0
        if metric.kind == "histogram":
            self.bucket_counts = [0] * len(metric.buckets)
            self.sum = 0.0
            self.count = 0

    # -- counter / gauge ------------------------------------------------
    def inc(self, v: float = 1.0):
        m = self._m
        if not m.registry.enabled:
            return
        if m.kind == "counter" and v < 0:
            raise ValueError(f"counter {m.name} decremented by {v}")
        with m.registry._lock:
            self.value += v

    def dec(self, v: float = 1.0):
        self.inc(-v)

    def set(self, v: float):
        m = self._m
        if not m.registry.enabled:
            return
        if m.kind != "gauge":
            raise ValueError(f"set() on {m.kind} {m.name}")
        with m.registry._lock:
            self.value = float(v)

    # -- histogram ------------------------------------------------------
    def observe(self, v: float):
        m = self._m
        if not m.registry.enabled:
            return
        if m.kind != "histogram":
            raise ValueError(f"observe() on {m.kind} {m.name}")
        v = float(v)
        with m.registry._lock:
            for i, le in enumerate(m.buckets):
                if v <= le:
                    self.bucket_counts[i] += 1
            self.sum += v
            self.count += 1


class Metric:
    """One named metric: a family of labeled children."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labels: Sequence[str] = (),
                 registry: Optional["Registry"] = None,
                 buckets: Optional[Sequence[float]] = None):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help
        self.label_names: Tuple[str, ...] = tuple(labels)
        for ln in self.label_names:
            if not _LABEL_RE.match(ln) or ln.startswith("__"):
                raise ValueError(f"invalid label name {ln!r}")
        self.registry = registry if registry is not None else _DEFAULT
        if self.kind == "histogram":
            b = tuple(float(x) for x in
                      (DEFAULT_BUCKETS if buckets is None else buckets))
            if list(b) != sorted(b) or len(set(b)) != len(b):
                raise ValueError("histogram buckets must be sorted, unique")
            if not b or not math.isinf(b[-1]):
                b = b + (math.inf,)
            self.buckets: Tuple[float, ...] = b
        self._children: Dict[LabelKey, _Child] = {}
        if not self.label_names:
            self._children[()] = _Child(self)

    # ------------------------------------------------------------------
    def labels(self, **kw) -> _Child:
        key = _label_key(self.label_names, kw)
        child = self._children.get(key)
        if child is None:
            with self.registry._lock:
                child = self._children.setdefault(key, _Child(self))
        return child

    def _default_child(self) -> _Child:
        if self.label_names:
            raise ValueError(f"{self.name} is labeled "
                             f"{self.label_names}; use .labels(...)")
        return self._children[()]

    # label-less convenience: metric.inc(...) / .set(...) / .observe(...)
    def inc(self, v: float = 1.0):
        self._default_child().inc(v)

    def dec(self, v: float = 1.0):
        self._default_child().dec(v)

    def set(self, v: float):
        self._default_child().set(v)

    def observe(self, v: float):
        self._default_child().observe(v)

    # ------------------------------------------------------------------
    def samples(self) -> List[Tuple[LabelKey, _Child]]:
        return sorted(self._children.items())


class Counter(Metric):
    kind = "counter"


class Gauge(Metric):
    kind = "gauge"


class Histogram(Metric):
    kind = "histogram"


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Registry:
    """A set of metrics + the enabled switch their updates check."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.RLock()
        self._metrics: Dict[str, Metric] = {}

    # -- get-or-create (idempotent at call sites) -----------------------
    def _get_or_create(self, cls, name: str, help: str,
                       labels: Sequence[str],
                       buckets: Optional[Sequence[float]] = None) -> Metric:
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls) or m.label_names != tuple(labels):
                raise ValueError(
                    f"metric {name} re-registered as {cls.kind} "
                    f"labels={tuple(labels)} (was {m.kind} "
                    f"labels={m.label_names})")
            return m
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, labels, registry=self, buckets=buckets)
                self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels, buckets)

    # ------------------------------------------------------------------
    def metrics(self) -> List[Metric]:
        return [self._metrics[k] for k in sorted(self._metrics)]

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def value(self, name: str, /, **labels) -> float:
        """Read one sample's value (counters/gauges) — tests and
        acceptance checks read the plane back through this."""
        m = self._metrics[name]
        child = (m.labels(**labels) if m.label_names else
                 m._default_child())
        return child.value

    def collect(self) -> List[Dict[str, object]]:
        """Snapshot every sample: a list of dicts, one per labeled child
        (histograms carry buckets/sum/count), deterministically ordered.
        The single source for both exporters."""
        out: List[Dict[str, object]] = []
        with self._lock:
            for m in self.metrics():
                for key, child in m.samples():
                    row: Dict[str, object] = {
                        "name": m.name, "kind": m.kind, "help": m.help,
                        "labels": dict(key)}
                    if m.kind == "histogram":
                        row["buckets"] = [
                            [le, c] for le, c in
                            zip(m.buckets, child.bucket_counts)]
                        row["sum"] = child.sum
                        row["count"] = child.count
                    else:
                        row["value"] = child.value
                    out.append(row)
        return out

    def reset(self):
        """Drop all metrics (tests; a fresh run starts clean)."""
        with self._lock:
            self._metrics.clear()


# ---------------------------------------------------------------------------
# The process-global default registry: off until someone turns the plane on.
# ---------------------------------------------------------------------------

_DEFAULT = Registry(enabled=False)


def default_registry() -> Registry:
    return _DEFAULT


def enabled() -> bool:
    """The one check hot paths make before doing any metric work."""
    return _DEFAULT.enabled


def enable() -> Registry:
    _DEFAULT.enabled = True
    return _DEFAULT


def disable():
    _DEFAULT.enabled = False
