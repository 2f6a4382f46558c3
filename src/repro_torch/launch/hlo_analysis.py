"""Collective byte volumes of a per-rank program (port of
``repro/launch/hlo_analysis.py``).

The reference scans XLA's per-device HLO text for collectives.  A torch
program has no HLO: ``dist.smap`` logs each collective it runs (or, on an
abstract mesh, stands in for) while an ``obs.cost.CostRecorder`` is
active, as a record ``(kind, result bytes, group size[, nvlink])`` with
the reference's kind names.  This module applies the reference's
per-kind formulas to those records, from the result's bytes and the
group size:

  all-gather:        operand = result / group          (result is gathered)
  reduce-scatter:    operand = result * group
  all-reduce / all-to-all / collective-permute: operand = result

``bytes``     = per-device operand payload.
``wire_bytes``= ring-algorithm link-traffic estimate per device:
  all-gather / reduce-scatter: (g-1)/g * full payload
  all-reduce: 2 * (g-1)/g * payload
  all-to-all: (g-1)/g * payload;  collective-permute: payload.

Every collective is logged once where it runs, so nothing is scaled by
a loop's trip count (the reference's HLO shows a while-loop body once).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, Tuple

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")


def _one(kind: str, res_bytes: float, g: int) -> Tuple[float, float]:
    """(operand bytes, wire bytes) of one collective."""
    g = max(1, int(g))
    if kind == "all-gather":
        payload = res_bytes          # full gathered size
        return res_bytes / g, (g - 1) / g * payload
    if kind == "reduce-scatter":
        payload = res_bytes * g
        return payload, (g - 1) / g * payload
    if kind == "all-reduce":
        return res_bytes, 2 * (g - 1) / g * res_bytes
    if kind == "all-to-all":
        return res_bytes, (g - 1) / g * res_bytes
    if kind == "collective-permute":
        return res_bytes, res_bytes
    raise ValueError(f"unknown collective kind {kind!r}")


def parse_collectives(records: Iterable[tuple]
                      ) -> Dict[str, Dict[str, float]]:
    """Returns {kind: {count, bytes, wire_bytes}} from the records
    ``(kind, result bytes, group size[, nvlink])``."""
    stats: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"count": 0, "bytes": 0.0, "wire_bytes": 0.0})
    for rec in records:
        kind, res_bytes, g = rec[0], float(rec[1]), rec[2]
        operand, wire = _one(kind, res_bytes, g)
        stats[kind]["count"] += 1
        stats[kind]["bytes"] += float(operand)
        stats[kind]["wire_bytes"] += float(wire)
    return dict(stats)


def collective_summary(records: Iterable[tuple]
                       ) -> Tuple[float, Dict[str, Dict[str, float]]]:
    records = list(records)
    stats = parse_collectives(records)
    total = sum(v["wire_bytes"] for v in stats.values())
    return total, stats


def wire_by_link(records: Iterable[tuple]) -> Dict[str, float]:
    """Wire bytes a device split by link: ``"nvlink"`` for groups inside
    one node, ``"node"`` for wider ones (records without the nvlink field
    count as ``"node"``)."""
    out = {"nvlink": 0.0, "node": 0.0}
    for rec in records:
        _, wire = _one(rec[0], float(rec[1]), rec[2])
        out["nvlink" if len(rec) > 3 and rec[3] else "node"] += wire
    return out
