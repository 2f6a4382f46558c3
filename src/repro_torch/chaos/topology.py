"""N>2-region failure topologies on the fused engine's scenario axis.

Host code, copied from ``repro/chaos/topology.py``.

The analytic and temporal kernels model ONE surviving region absorbing
shed traffic — the paper's 2-region operating point is the special case
``traffic_mult = 2.0``.  For N regions the per-survivor picture is the
same model with a different multiplier: a survivor holding share ``w_r``
of the traffic absorbs ``w_r / W_surv`` of the shed load, so its load
step is ``1 + shed / W_surv`` (uniform 3-region single failure ->
1.5x, the 2-region case -> 2.0x).  :func:`expand_failures` therefore
maps *(failure pattern, surviving region)* pairs onto scenario rows —
the engine's scenario axis IS the region axis — and
:func:`reduce_pattern_verdicts` folds row verdicts back per pattern
(a pattern passes iff EVERY surviving region passes).

Partial-region degradation composes orthogonally: per-survivor
fractional capacity loss rides the ``region_degradation`` knob.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

__all__ = ["RegionTopology", "expand_failures", "reduce_pattern_verdicts"]


@dataclasses.dataclass(frozen=True)
class RegionTopology:
    """Traffic shares of an N-region deployment (normalized to sum 1)."""

    weights: Tuple[float, ...]
    names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.weights) != len(self.names):
            raise ValueError("weights and names length mismatch")
        if len(self.weights) < 2:
            raise ValueError("a topology needs at least 2 regions")
        w = np.asarray(self.weights, np.float64)
        if (w <= 0).any():
            raise ValueError("region weights must be positive")
        object.__setattr__(self, "weights",
                           tuple((w / w.sum()).tolist()))

    @classmethod
    def uniform(cls, n: int, prefix: str = "region") -> "RegionTopology":
        return cls(weights=tuple([1.0 / n] * n),
                   names=tuple(f"{prefix}-{i}" for i in range(n)))

    @property
    def n(self) -> int:
        return len(self.weights)

    def single_failures(self) -> np.ndarray:
        """(N, N) bool: pattern i fails exactly region i."""
        return np.eye(self.n, dtype=bool)


def expand_failures(topo: RegionTopology, failed,
                    degradation=None,
                    base_traffic_mult: float = 1.0
                    ) -> Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray]:
    """Expand failure patterns into engine scenario rows.

    Parameters
    ----------
    failed:
        ``(P, N)`` bool — which regions are dark in each pattern.  Every
        pattern must leave at least one survivor.
    degradation:
        optional ``(P, N)`` float in [0, 1) — fractional capacity loss
        of each *surviving* region (ignored for failed regions).
    base_traffic_mult:
        pre-failure load factor of each region (1.0 = regions at their
        steady share).

    Returns ``(grid, pattern_id, region_id)``: a scenario grid with one
    row per (pattern, survivor) containing ``traffic_mult`` and
    ``region_degradation`` columns, plus the row -> pattern and row ->
    region index maps for :func:`reduce_pattern_verdicts`.
    """
    failed = np.atleast_2d(np.asarray(failed, bool))
    if failed.shape[1] != topo.n:
        raise ValueError(
            f"failed has {failed.shape[1]} columns, topology has {topo.n}")
    if degradation is None:
        degradation = np.zeros(failed.shape, np.float64)
    degradation = np.atleast_2d(np.asarray(degradation, np.float64))
    if degradation.shape != failed.shape:
        raise ValueError("degradation shape must match failed")

    w = np.asarray(topo.weights, np.float64)
    mult_rows, degr_rows, pattern_id, region_id = [], [], [], []
    for p in range(failed.shape[0]):
        surv = np.flatnonzero(~failed[p])
        if surv.size == 0:
            raise ValueError(f"pattern {p} fails every region")
        shed = w[failed[p]].sum()
        w_surv = w[surv].sum()
        # each survivor absorbs shed load proportionally to its own
        # share: load step = 1 + shed / W_surv, identical for every
        # survivor under proportional routing
        mult = base_traffic_mult * (1.0 + shed / w_surv)
        for r in surv:
            mult_rows.append(mult)
            degr_rows.append(float(np.clip(degradation[p, r], 0.0, 0.999)))
            pattern_id.append(p)
            region_id.append(int(r))
    grid = {"traffic_mult": np.asarray(mult_rows, np.float64),
            "region_degradation": np.asarray(degr_rows, np.float64)}
    return grid, np.asarray(pattern_id, np.int32), np.asarray(
        region_id, np.int32)


def reduce_pattern_verdicts(result: Dict[str, np.ndarray],
                            pattern_id: np.ndarray,
                            topo: RegionTopology,
                            region_id: np.ndarray,
                            n_patterns: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Fold per-(pattern, survivor) rows back to per-pattern verdicts.

    A pattern meets the SLA iff every surviving region does; pattern
    availability is the traffic-weighted mean over survivors (failed
    regions shed all traffic, so they carry no weight).  Returns
    ``{"sla_ok", "availability", "worst_region"}`` arrays of length P.
    """
    pattern_id = np.asarray(pattern_id)
    region_id = np.asarray(region_id)
    n_p = int(n_patterns if n_patterns is not None
              else pattern_id.max() + 1)
    ok = np.asarray(result["sla_ok"], bool)[: len(pattern_id)]
    if "t_sla_ok" in result:
        ok = ok & np.asarray(result["t_sla_ok"], bool)[: len(pattern_id)]
    avail = np.asarray(result["availability"],
                       np.float64)[: len(pattern_id)]
    w = np.asarray(topo.weights, np.float64)[region_id]

    out_ok = np.ones(n_p, bool)
    out_avail = np.zeros(n_p, np.float64)
    out_worst = np.full(n_p, -1, np.int32)
    for p in range(n_p):
        rows = np.flatnonzero(pattern_id == p)
        if rows.size == 0:
            out_ok[p] = False
            continue
        out_ok[p] = bool(ok[rows].all())
        wr = w[rows] / w[rows].sum()
        out_avail[p] = float((avail[rows] * wr).sum())
        out_worst[p] = int(region_id[rows[np.argmin(avail[rows])]])
    return {"sla_ok": out_ok, "availability": out_avail,
            "worst_region": out_worst}
