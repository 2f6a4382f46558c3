"""Canary regression gate (paper §6, third layer).

Always-On / Active-Migrate deployments entering the canary zone get a
5-minute window during which traffic to ALL Restore-Later/Terminate
services is blocked; if the canary's error metrics regress, the deployment
rolls back — a new fail-close dependency was about to ship.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.service import ServiceSpec
from repro_torch.core.tiers import FailureClass


@dataclasses.dataclass
class Deployment:
    service: str
    # newly introduced dependency (callee, fail_open) or None
    new_dep: Optional[Tuple[str, bool]] = None


@dataclasses.dataclass
class GateResult:
    deployment: Deployment
    passed: bool
    error_rate: float


class CanaryRegressionGate:
    """5-minute blackhole of preemptible callees + metric comparison."""

    BASELINE_ERROR = 0.0008
    BASELINE_SIGMA = 0.0002
    REGRESSION_THRESHOLD = 0.004
    UNSAFE_DEP_ERROR = 0.25           # per blackholed fail-close dep
    HARD_FAILURE_BUMP = (0.2, 0.6)    # new fail-close dep under the block

    def __init__(self, fleet: Dict[str, ServiceSpec], seed: int = 0):
        self.fleet = fleet
        self.rng = random.Random(seed)
        self._np_rng = np.random.default_rng(seed)
        self.rolled_back: List[Deployment] = []

    def _canary_error_rate(self, dep: Deployment) -> float:
        """Error rate observed while preemptible callees are blackholed."""
        base = max(0.0, self.rng.gauss(self.BASELINE_ERROR,
                                       self.BASELINE_SIGMA))
        spec = self.fleet.get(dep.service)
        if spec is None:
            return base
        # existing unsafe deps toward preemptible callees surface here too
        for callee in spec.unsafe_deps():
            if self.fleet[callee].failure_class.preemptible:
                base += self.UNSAFE_DEP_ERROR
        if dep.new_dep is not None:
            callee, fail_open = dep.new_dep
            c = self.fleet.get(callee)
            if (c is not None and c.failure_class.preemptible
                    and not fail_open):
                base += self.rng.uniform(*self.HARD_FAILURE_BUMP)
        return min(1.0, base)

    def evaluate(self, dep: Deployment) -> GateResult:
        spec = self.fleet.get(dep.service)
        if spec is None or not spec.failure_class.survives_failover:
            return GateResult(dep, True, 0.0)  # gate targets critical classes
        err = self._canary_error_rate(dep)
        passed = err < self.REGRESSION_THRESHOLD
        if not passed:
            self.rolled_back.append(dep)
        return GateResult(dep, passed, err)

    def run_window(self, n_deployments: int, regression_rate: float = 6e-5
                   ) -> Dict[str, object]:
        """Simulate a deployment stream (paper: ~8,000/week, 3 regressions
        caught in a 45-day window => ~4e-4 regression rate post-static).

        Vectorized: one array draw per decision — deployed service,
        regression injection, gaussian baseline error, hard-failure bump
        under the 5-minute blackhole — instead of a Python loop over 48k
        deployments; the model constants are the class attributes
        ``evaluate`` uses.  Rolled-back deployments still land on
        ``self.rolled_back`` (there are few; the stream itself is never
        materialized)."""
        stats = [(n, sum(1 for c in s.unsafe_deps()
                         if self.fleet[c].failure_class.preemptible))
                 for n, s in self.fleet.items()
                 if s.failure_class.survives_failover]
        names = [n for n, _ in stats]
        preemptible = [n for n, s in self.fleet.items()
                       if s.failure_class.preemptible]
        # existing unsafe deps toward preemptible callees surface under the
        # blackhole exactly as in the scalar model
        unsafe_bump = self.UNSAFE_DEP_ERROR * np.asarray(
            [k for _, k in stats], np.float64)
        rng = self._np_rng
        n = n_deployments
        svc = rng.integers(0, len(stats), n)
        err = np.clip(rng.normal(self.BASELINE_ERROR, self.BASELINE_SIGMA,
                                 n), 0.0, None)
        err += unsafe_bump[svc]
        regressed = (np.zeros(n, bool) if not preemptible
                     else rng.random(n) < regression_rate)
        # an injected regression is a new fail-close dep on a preemptible
        # callee: a hard failure while the canary blackhole is up
        err += np.where(regressed, rng.uniform(*self.HARD_FAILURE_BUMP, n),
                        0.0)
        err = np.minimum(err, 1.0)
        passed = err < self.REGRESSION_THRESHOLD
        failed = np.flatnonzero(~passed)
        callee = rng.integers(0, max(1, len(preemptible)), len(failed))
        for j, i in enumerate(failed):
            new_dep = ((preemptible[callee[j]], False)
                       if regressed[i] else None)
            self.rolled_back.append(Deployment(names[svc[i]], new_dep))
        return {"deployments": n_deployments,
                "regressions_caught": int((regressed & ~passed).sum()),
                "regressions_shipped": int((regressed & passed).sum())}
