"""Frontier-hunting chaos campaigns over the fused sweep engine.

Port of ``repro/chaos/campaign.py``: host code around the port's
``SweepEngine``; ``campaign_for_fleet`` builds the engine on ``device``.

A campaign searches along *fault-severity rays* — directions in the
``faults.FAMILIES`` severity space — for the lowest severity at which
the fleet violates its SLA.  The search is bisection per ray with a
bandit allocator across rays: each round, the rays with the widest
remaining brackets (largest uncertainty, so largest information gain
per probe) get the round's probe budget, all probes are fused into ONE
bucket-padded ``SweepEngine.run`` batch, and the batched ``sla_ok``
verdicts refine every bracket at once.

Localizing a frontier to severity resolution ``tol`` costs
``~log2(1/tol)`` engine evaluations per ray instead of the
``1/tol + 1`` an exhaustive grid at the same resolution needs — the
bench asserts the >=10x saving on the paper-scale fleet.

Every probe's verdict row is logged so ``report.verify_report`` can
re-evaluate the whole campaign on a fresh engine and assert the
verdicts are bit-identical (same engine code, same stage seeds).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core.scenarios import stage_seed

from .faults import FAMILIES, FAULT_LIBRARY, ray_severities, severity_grid
from .report import CampaignReport, RayResult

__all__ = ["Ray", "default_rays", "Campaign", "engine_oracle",
           "campaign_for_fleet", "VERDICT_KEYS"]

# Result keys snapshotted per probe for bit-exact re-verification.
# Only keys present in the engine result are logged.
VERDICT_KEYS: Tuple[str, ...] = (
    "sla_ok", "t_sla_ok", "availability", "t_availability_mean",
    "rl_done_s", "t_rl_done_s", "util_peak", "t_util_peak",
    # request-plane drill oracles (serving.workload.drill_oracle)
    "crit_availability", "crit_p99_s", "pre_restore_s",
)


@dataclasses.dataclass(frozen=True)
class Ray:
    """A direction in fault-severity space.

    ``direction`` maps family name -> weight in (0, 1]; severity ``s``
    along the ray puts ``s * weight`` into each named family (other
    families stay at their operating point).  ``fixed`` pins extra
    scenario knobs for every probe on this ray.
    """

    name: str
    direction: Mapping[str, float]
    fixed: Mapping[str, float] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not self.direction:
            raise ValueError(f"ray {self.name!r} has an empty direction")
        for fam, w in self.direction.items():
            if fam not in FAULT_LIBRARY:
                raise KeyError(f"unknown fault family {fam!r}")
            if not 0.0 < float(w) <= 1.0:
                raise ValueError(
                    f"ray {self.name!r}: weight for {fam} must be in "
                    f"(0, 1], got {w}")


def default_rays(families: Sequence[str] = FAMILIES) -> Tuple[Ray, ...]:
    """One single-family ray per fault family, plus the paper's
    compound incident (blackhole with traffic spike + quota shortfall)."""
    rays = [Ray(name, {name: 1.0}) for name in families]
    compound = {"traffic_spike": 1.0, "quota_shortfall": 0.75,
                "evict_shortfall": 0.5}
    if all(f in families for f in compound):
        rays.append(Ray("correlated_incident", compound))
    return tuple(rays)


@dataclasses.dataclass
class _RayState:
    ray: Ray
    lo: float = 0.0             # highest severity known to PASS
    hi: float = 1.0             # lowest severity known to FAIL
    status: str = "active"      # active | localized | no_violation | degenerate
    n_probes: int = 0

    @property
    def width(self) -> float:
        return self.hi - self.lo


def engine_oracle(engine, *, temporal: bool = True) -> Callable:
    """Wrap a ``SweepEngine`` as a campaign oracle.

    The oracle maps a scenario grid to ``(ok, result)`` where ``ok``
    is the per-row boolean SLA verdict (analytic AND temporal when the
    temporal kernel runs) and ``result`` the raw engine result dict.
    """

    def oracle(grid: Dict[str, np.ndarray]):
        res = engine.run(grid, temporal=temporal)
        ok = np.asarray(res["sla_ok"], bool)
        if "t_sla_ok" in res:
            ok = ok & np.asarray(res["t_sla_ok"], bool)
        return ok, res

    return oracle


class Campaign:
    """Bandit-allocated bisection along fault-severity rays.

    Parameters
    ----------
    engine:
        A ``SweepEngine`` (or None when ``oracle`` is injected, e.g. in
        property tests with a synthetic oracle).
    rays:
        Rays to search; defaults to :func:`default_rays`.
    tol:
        Target severity resolution of the localized frontier bracket.
    round_budget:
        Max rays probed per bisection round (bandit budget).  ``None``
        probes every active ray each round.
    max_rounds:
        Hard cap on bisection rounds (excludes the probe round).
    seed:
        Campaign seed, recorded in the report.  The engine's own draws
        are seeded at construction; ``campaign_for_fleet`` derives both
        from one seed via ``stage_seed``.
    """

    def __init__(self, engine=None, *, rays: Optional[Sequence[Ray]] = None,
                 tol: float = 1.0 / 256.0, round_budget: Optional[int] = None,
                 max_rounds: int = 64, temporal: bool = True, seed: int = 0,
                 oracle: Optional[Callable] = None, profiler=None,
                 families: Optional[Sequence[str]] = None):
        if oracle is None and engine is None:
            raise ValueError("need an engine or an oracle")
        if not 0.0 < tol < 1.0:
            raise ValueError(f"tol must be in (0, 1), got {tol}")
        self.engine = engine            # for report re-verification
        self.oracle = oracle or engine_oracle(engine, temporal=temporal)
        # severity-space axes: engine campaigns stay on the engine-knob
        # FAMILIES; drill campaigns pass faults.REQUEST_FAMILIES so only
        # request-plane knobs reach their oracle
        self.families = tuple(families) if families is not None else FAMILIES
        self.rays = tuple(rays if rays is not None
                          else default_rays(self.families))
        if not self.rays:
            raise ValueError("campaign needs at least one ray")
        self.tol = float(tol)
        self.round_budget = round_budget
        self.max_rounds = int(max_rounds)
        self.seed = int(seed)
        self.profiler = profiler
        self.n_evals = 0
        self.n_rounds = 0
        self.probe_log: List[dict] = []    # every probe: row + verdict snapshot

    # -- one fused engine batch for a list of (ray_index, severity) ---------
    def _grid_for(self, probes: Sequence[Tuple[int, float]]
                  ) -> Dict[str, np.ndarray]:
        sev = np.zeros((len(probes), len(self.families)), np.float64)
        for i, (ri, s) in enumerate(probes):
            sev[i] = ray_severities(self.rays[ri].direction, [s],
                                    self.families)[0]
        grid = severity_grid(sev, self.families)
        for i, (ri, _) in enumerate(probes):
            for knob, val in self.rays[ri].fixed.items():
                if knob not in grid:
                    # constant column at the knob's default so only this
                    # ray's rows deviate; engine fills true defaults for
                    # keys we never mention
                    fam = next((f for f in FAULT_LIBRARY.values()
                                if f.knob == knob), None)
                    base = fam.base if fam is not None else float(val)
                    grid[knob] = np.full(len(probes), base, np.float64)
                grid[knob][i] = float(val)
        return grid

    def _evaluate(self, probes: Sequence[Tuple[int, float]]) -> np.ndarray:
        grid = self._grid_for(probes)
        ok, res = self.oracle(grid)
        ok = np.asarray(ok, bool)
        self.n_evals += len(probes)
        keys = [k for k in VERDICT_KEYS if k in res]
        for i, (ri, s) in enumerate(probes):
            self.probe_log.append({
                "ray": self.rays[ri].name,
                "severity": float(s),
                "ok": bool(ok[i]),
                "row": {k: float(grid[k][i]) for k in grid},
                "verdict": {k: np.asarray(res[k])[i].item() for k in keys},
            })
        if obs.enabled():
            obs.inc("ufa_chaos_evals_total", len(probes))
        return ok

    # -- bandit allocator: widest bracket first -----------------------------
    def _allocate(self, states: List[_RayState]) -> List[int]:
        active = [i for i, st in enumerate(states) if st.status == "active"]
        # widest remaining bracket = largest uncertainty = largest
        # information gain per bisection probe (greedy bandit)
        active.sort(key=lambda i: (-states[i].width, i))
        if self.round_budget is not None:
            active = active[: self.round_budget]
        return active

    def run(self) -> CampaignReport:
        phase = (self.profiler.phase if self.profiler is not None
                 else _null_phase)
        states = [_RayState(ray=r) for r in self.rays]

        # Round 0: the shared operating point (severity 0) plus each
        # ray's worst case (severity 1) — establishes every bracket.
        with phase("chaos-probe"):
            probes = [(0, 0.0)] + [(i, 1.0) for i in range(len(states))]
            ok = self._evaluate(probes)
        op_ok = bool(ok[0])
        for i, st in enumerate(states):
            st.n_probes += 1
            if not op_ok:
                st.status = "degenerate"   # fleet fails at its own
            elif ok[1 + i]:                # operating point: nothing to hunt
                st.status = "no_violation"

        while any(st.status == "active" for st in states) \
                and self.n_rounds < self.max_rounds:
            chosen = self._allocate(states)
            if not chosen:
                break
            with phase("chaos-bisect"):
                probes = [(i, (states[i].lo + states[i].hi) / 2.0)
                          for i in chosen]
                ok = self._evaluate(probes)
            for (i, mid), good in zip(probes, ok):
                st = states[i]
                st.n_probes += 1
                if good:
                    st.lo = mid
                else:
                    st.hi = mid
                if st.width <= self.tol:
                    st.status = "localized"
            self.n_rounds += 1
            if obs.enabled():
                obs.inc("ufa_chaos_rounds_total")

        return self._report(states, op_ok)

    def _report(self, states: List[_RayState], op_ok: bool) -> CampaignReport:
        results = []
        for st in states:
            frontier = (st.lo + st.hi) / 2.0 if st.status == "localized" \
                else None
            counterexample = None
            if st.status in ("localized", "active"):
                # active/localized both imply st.hi was CONFIRMED failing
                # (severity 1.0 failed in the probe round, and hi only
                # ever moves to a severity the oracle rejected) — the
                # knob values at hi are the minimal known counterexample
                sev = ray_severities(st.ray.direction, [st.hi],
                                     self.families)
                counterexample = {
                    k: float(v[0])
                    for k, v in severity_grid(sev, self.families).items()}
            results.append(RayResult(
                name=st.ray.name, direction=dict(st.ray.direction),
                status=st.status, lo=st.lo, hi=st.hi,
                frontier_severity=frontier, counterexample=counterexample,
                n_probes=st.n_probes, families=self.families))
        grid_points_per_ray = int(math.ceil(1.0 / self.tol)) + 1
        searched = [r for r in results
                    if r.status in ("localized", "no_violation")]
        grid_equiv = grid_points_per_ray * len(searched)
        report = CampaignReport(
            seed=self.seed, tol=self.tol, op_ok=op_ok, rays=results,
            n_evals=self.n_evals, n_rounds=self.n_rounds,
            grid_equiv_evals=grid_equiv, probe_log=list(self.probe_log))
        if obs.enabled():
            obs.set_gauge("ufa_chaos_rays_localized", report.n_localized)
            if report.speedup_vs_grid is not None:
                obs.set_gauge("ufa_chaos_speedup_vs_grid",
                              report.speedup_vs_grid)
            for r in results:
                if r.frontier_severity is not None:
                    obs.set_gauge("ufa_chaos_frontier_severity",
                                  r.frontier_severity, ray=r.name)
        return report


class _null_phase:
    def __init__(self, _name: str = ""):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def campaign_for_fleet(fs, *, seed: int = 0, with_graph: bool = True,
                       temporal: bool = True, t_end_s: float = 7200.0,
                       t_points: int = 240, scale: float = 1.0,
                       device=None, **campaign_kw) -> Campaign:
    """Build a fully seeded campaign over a fleet state.

    ONE ``seed`` reproduces the whole campaign: the engine's blackhole
    and storm draws get independent streams via ``stage_seed`` inside
    ``SweepEngine``; the deterministic bisection consumes no randomness
    beyond the engine's; the report records the same seed.

    The fleet is placed by a fresh ``Orchestrator`` (steady state) so
    the engine sees post-placement pool occupancy, exactly like the
    fused-sweep bench.  The engine runs on ``device`` (default: the CUDA
    card).
    """
    from repro_torch.core.capacity import RegionCapacity
    from repro_torch.core.omg import Orchestrator
    from repro_torch.core.timeline_sim import default_ts
    from repro_torch.graph import CallGraph

    region = RegionCapacity.for_fleet("chaos", fs)
    orch = Orchestrator(fs, region, scale=scale)
    graph = CallGraph.from_fleet_state(fs) if with_graph else None
    ts = default_ts(t_end_s, t_points) if temporal else None
    engine = orch.sweep_engine(graph=graph,
                               seed=stage_seed(seed, "sweep-engine"), ts=ts,
                               device=device)
    return Campaign(engine, temporal=temporal, seed=seed, **campaign_kw)
