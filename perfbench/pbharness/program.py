"""What the per-layer metric files that read the program's own
instrumentation share.

The program (``repro_torch.obs.trace``) keeps its counters only while
tracing is on, which in a traced run is while the profiler records:
exactly the traced steps.  Its phases are functions called through
their modules' attributes, so a metric times one by naming it in
``SPANS`` as any span.  An older program, which opens no spans of its
own, lacks them; a reader then wraps nothing, reads nothing and returns
None.  Each reader returns None where the trace holds no device time, as
a CPU run's does.
"""

from __future__ import annotations

import importlib
import sys
from typing import Iterable, List, Optional

from pbharness.readers import span_ms
from repro_torch.obs import trace as program_trace


def _has(path: str) -> bool:
    mod, attr = path.rsplit(".", 1)
    return callable(getattr(importlib.import_module(mod), attr, None))


def present(paths: Iterable[str]) -> List[str]:
    """``paths``, module attributes of the program, for a metric's
    ``SPANS`` where the program has every one of them, else none.  A
    program that opens its own spans (``SPAN_PREFIX``) and lacks one has
    renamed or fused a phase: that is said on standard error, and the
    metric reads nothing rather than a part of its phase."""
    paths = list(paths)
    missing = [p for p in paths if not _has(p)]
    if missing and hasattr(program_trace, "SPAN_PREFIX"):
        print(f"perfbench: the program opens its own spans but has no "
              f"{', '.join(missing)}: the metric that times {paths} reads "
              f"nothing", file=sys.stderr, flush=True)
    return [] if missing else paths


def spans_ms(t, paths: Iterable[str]) -> Optional[float]:
    """Device milliseconds a traced step spends in the kernels launched
    inside the ranges of ``paths``, summed over those that saw a call;
    None where none did or the trace holds no device time."""
    got = [v for v in (span_ms(t, p) for p in paths) if v is not None]
    return sum(got) if got else None


def counter_pct(t, num: str, den: str) -> Optional[float]:
    """100 x the program's counter ``num`` over its counter ``den``, as
    counted over the traced steps; None without device time or where the
    program keeps no such counter."""
    read = getattr(program_trace, "counters", None)
    if t.busy_s <= 0 or read is None:
        return None
    c = read()
    if not c.get(den):
        return None
    return 100.0 * c.get(num, 0) / c[den]
