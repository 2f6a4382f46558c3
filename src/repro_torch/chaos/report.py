"""Campaign reports: frontier coordinates, counterexamples, re-verification.

Host code, copied from ``repro/chaos/report.py``; ``verify_report``
replays through the port's ``SweepEngine``, whose rows do not depend on
the batch they run in (the verdict reduction reduces each row on its
own, the propagation's routes are both exact).

A :class:`CampaignReport` is the durable artifact of a chaos campaign —
per-ray frontier severities in knob coordinates ("max survivable
quota shortfall at the 2.0x operating point"), the minimal-severity
counterexample per violated ray, and the full probe log.  The probe log
makes the campaign *auditable*: :func:`verify_report` replays every
logged scenario row through a fresh engine in one batch and asserts the
verdicts are bit-identical — same engine code, same stage seeds,
so any drift is a real reproducibility bug, not noise.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["RayResult", "CampaignReport", "verify_report"]


@dataclasses.dataclass(frozen=True)
class RayResult:
    """Outcome of the frontier search along one fault-severity ray."""

    name: str
    direction: Dict[str, float]
    status: str                  # localized | no_violation | active | degenerate
    lo: float                    # highest severity known to pass
    hi: float                    # lowest severity known to fail
    frontier_severity: Optional[float]   # (lo+hi)/2 when localized
    counterexample: Optional[Dict[str, float]]  # knob values at hi
    n_probes: int
    # severity-space axes the campaign searched (None: engine FAMILIES)
    families: Optional[Tuple[str, ...]] = None

    def frontier_knobs(self) -> Optional[Dict[str, float]]:
        """Frontier severity mapped onto scenario-knob coordinates."""
        if self.frontier_severity is None:
            return None
        from .faults import FAMILIES, ray_severities, severity_grid
        fams = tuple(self.families) if self.families else FAMILIES
        sev = ray_severities(self.direction, [self.frontier_severity], fams)
        return {k: float(v[0]) for k, v in severity_grid(sev, fams).items()}


@dataclasses.dataclass(frozen=True)
class CampaignReport:
    seed: int
    tol: float
    op_ok: bool                  # fleet passes at its own operating point
    rays: List[RayResult]
    n_evals: int                 # engine scenario-evaluations submitted
    n_rounds: int                # bisection rounds (excl. the probe round)
    grid_equiv_evals: int        # exhaustive per-ray grid at the same tol
    probe_log: List[dict]        # every probe: grid row + verdict snapshot

    @property
    def n_localized(self) -> int:
        return sum(r.status == "localized" for r in self.rays)

    @property
    def speedup_vs_grid(self) -> Optional[float]:
        if self.n_evals == 0 or self.grid_equiv_evals == 0:
            return None
        return self.grid_equiv_evals / self.n_evals

    def ray(self, name: str) -> RayResult:
        for r in self.rays:
            if r.name == name:
                return r
        raise KeyError(name)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["n_localized"] = self.n_localized
        d["speedup_vs_grid"] = self.speedup_vs_grid
        return d

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    def render(self) -> str:
        """Human-readable frontier table."""
        lines = [
            f"chaos campaign  seed={self.seed}  tol=1/{round(1 / self.tol)}"
            f"  operating point: {'PASS' if self.op_ok else 'FAIL'}",
            f"{self.n_evals} engine evals over {self.n_rounds} bisection "
            f"rounds (exhaustive grid at this resolution: "
            f"{self.grid_equiv_evals} evals"
            + (f", {self.speedup_vs_grid:.1f}x saved)"
               if self.speedup_vs_grid else ")"),
            "",
            f"{'ray':<22}{'status':<14}{'frontier':<10}bracket / "
            "counterexample",
        ]
        for r in self.rays:
            front = (f"{r.frontier_severity:.4f}"
                     if r.frontier_severity is not None else "-")
            if r.status == "localized" and r.counterexample:
                knobs = {k: round(v, 4) for k, v in r.counterexample.items()
                         if not math.isclose(
                             v, _base_knob(k), abs_tol=1e-12)}
                detail = f"[{r.lo:.4f}, {r.hi:.4f}]  fails at {knobs}"
            elif r.status == "no_violation":
                detail = "survives severity 1.0"
            elif r.status == "degenerate":
                detail = "operating point already violates SLA"
            else:
                detail = f"[{r.lo:.4f}, {r.hi:.4f}] (budget exhausted)"
            lines.append(f"{r.name:<22}{r.status:<14}{front:<10}{detail}")
        return "\n".join(lines)


def _base_knob(knob: str) -> float:
    from .faults import FAULT_LIBRARY
    for fam in FAULT_LIBRARY.values():
        if fam.knob == knob:
            return fam.base
    return float("nan")


def verify_report(report: CampaignReport, engine=None, *,
                  temporal: bool = True,
                  oracle: Optional[Callable] = None) -> dict:
    """Replay every logged probe through ``engine`` (or a campaign
    ``oracle``) and compare bitwise.

    ``engine`` must be built with the same fleet/graph and stage seeds
    (e.g. a second ``campaign_for_fleet(...).oracle`` engine from the
    same campaign seed).  All probes are resubmitted as ONE batch — row
    results must be bit-identical regardless of the batch composition
    they were originally evaluated in, because every engine row is
    evaluated independently and every drill-oracle row is an independent
    deterministic drill.

    ``oracle`` replays campaigns that never had an engine (request-plane
    drill campaigns): it receives the replayed grid and must return
    ``(ok, result)`` like the original oracle did.

    Returns ``{"n_probes", "mismatches"}`` and raises ``AssertionError``
    on any verdict drift.
    """
    if engine is None and oracle is None:
        raise ValueError("verify_report needs an engine or an oracle")
    probes = report.probe_log
    if not probes:
        return {"n_probes": 0, "mismatches": []}
    row_keys = list(probes[0]["row"])
    grid = {k: np.asarray([p["row"][k] for p in probes], np.float64)
            for k in row_keys}
    if oracle is not None:
        ok_replayed, res = oracle(grid)
        ok_replayed = np.asarray(ok_replayed, bool)
    else:
        res = engine.run(grid, temporal=temporal)
        ok_replayed = None

    mismatches = []
    verdict_keys = list(probes[0]["verdict"])
    for k in verdict_keys:
        got = np.asarray(res[k])[: len(probes)]
        want = np.asarray([p["verdict"][k] for p in probes]).astype(got.dtype)
        if not np.array_equal(want, got, equal_nan=got.dtype.kind == "f"):
            bad = np.flatnonzero(
                ~_eq(want, got))
            for i in bad[:8]:
                mismatches.append({
                    "probe": int(i), "key": k, "ray": probes[i]["ray"],
                    "severity": probes[i]["severity"],
                    "logged": want[i].item(), "replayed": got[i].item()})
    if ok_replayed is not None:
        ok = ok_replayed[: len(probes)]
    else:
        ok = np.asarray(res["sla_ok"], bool)[: len(probes)]
        if "t_sla_ok" in res:
            ok = ok & np.asarray(res["t_sla_ok"], bool)[: len(probes)]
    for i, p in enumerate(probes):
        if bool(ok[i]) != p["ok"]:
            mismatches.append({
                "probe": int(i), "key": "ok", "ray": p["ray"],
                "severity": p["severity"],
                "logged": p["ok"], "replayed": bool(ok[i])})
    assert not mismatches, (
        f"campaign replay drifted on {len(mismatches)} verdict(s): "
        f"{mismatches[:3]}")
    return {"n_probes": len(probes), "mismatches": mismatches}


def _eq(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if a.dtype.kind == "f":
        return (a == b) | (np.isnan(a) & np.isnan(b))
    return a == b
