"""What the per-layer metric files share: a span's device milliseconds
a step, and a kernel's share of its roofline."""

from __future__ import annotations

from typing import Optional

from pbharness import peaks


def span_ms(t, path: str) -> Optional[float]:
    """Device milliseconds a traced step spends in the kernels launched
    inside ``path``'s ranges; None where the span saw no call or the
    trace holds no device time."""
    s = t.span_device_s(path)
    if not t.calls.get(path) or s <= 0:
        return None
    return 1e3 * s / t.steps


def roofline_pct(t, path: str, count: str) -> Optional[float]:
    """100 x the least time of every call the span saw (operations at the
    peak rate of their inputs' dtype, or bytes at the memory bandwidth,
    whichever is longer, as ``counts/<count>.py`` counts them) over the
    device time inside its ranges; None where nothing was read or the
    card has no peaks in the table."""
    pk = t.context["peaks"]
    calls = t.calls.get(path)
    s = t.span_device_s(path)
    if pk is None or not calls or s <= 0:
        return None
    fn = t.context["count"](count).count
    least = sum(peaks.least_seconds(pk, *fn(c)) for c in calls)
    return 100.0 * least / s
