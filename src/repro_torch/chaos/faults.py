"""Composable fault families and the correlated fault sampler.

Port of ``repro/chaos/faults.py``: the fault library and the grid
helpers are the reference's host code; the sampler draws its Gaussian
copula on the device from a ``torch.Generator`` (the reference's
``jax.random`` bits cannot be reproduced, so the sampler is held to the
same statistical contracts instead: Uniform(0, max) marginals, one draw
per seed, the requested rank correlations).

A *fault family* maps a dimensionless severity in ``[0, 1]`` onto one
scenario knob of the fused sweep engine: severity 0 is the paper
operating point, severity 1 the worst modelled value.  Campaigns search
along *rays* in this severity space; the sampler below draws joint
severities with an explicit correlation structure (Gaussian copula with
uniform marginals), so "the blackhole that also spikes traffic and eats
the cloud quota" is one reproducible draw, not three independent knobs.

Everything random derives from ONE campaign seed via
``core.scenarios.stage_seed(seed, "faults")``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.scenarios import stage_seed
from repro_torch.kernels.backend import resolve_device

__all__ = [
    "FaultFamily", "FAULT_LIBRARY", "FAMILIES", "REQUEST_FAULT_LIBRARY",
    "REQUEST_FAMILIES", "severity_grid", "ray_severities",
    "DEFAULT_CORR_PAIRS", "correlation_matrix", "sample_faults",
]


@dataclasses.dataclass(frozen=True)
class FaultFamily:
    """One severity axis: ``knob = base + severity * (worst - base)``."""

    name: str
    knob: str        # scenario-grid key the severity maps onto
    base: float      # knob value at severity 0 (paper operating point)
    worst: float     # knob value at severity 1
    doc: str = ""

    def value(self, severity):
        """Knob value(s) for severity in [0, 1] (scalar or array)."""
        return self.base + np.asarray(severity, np.float64) * (
            self.worst - self.base)

    def severity(self, value):
        """Inverse of :meth:`value` (for reporting observed knobs)."""
        return (np.asarray(value, np.float64) - self.base) / (
            self.worst - self.base)


# Canonical fault library, one entry per scenario knob the engine sweeps.
# ``base`` is the §6 operating point; ``worst`` the harshest value the
# analytic/temporal models are calibrated for.
FAULT_LIBRARY: Dict[str, FaultFamily] = {
    f.name: f for f in (
        FaultFamily(
            "traffic_spike", "traffic_mult", 2.0, 4.0,
            "surviving-region load beyond the 2.0x single-failover step"),
        FaultFamily(
            "preheat_stall", "burst_delay_s", 270.0, 1800.0,
            "cloud burst capacity arrives late (preheat pipeline stalled)"),
        FaultFamily(
            "burst_shortfall", "burst_availability", 1.0, 0.0,
            "fraction of requested burst capacity that never materializes"),
        FaultFamily(
            "quota_shortfall", "cloud_quota_frac", 1.0, 0.0,
            "cloud provider delivers only a fraction of the reserved quota"),
        FaultFamily(
            "evict_shortfall", "evict_fraction", 1.0, 0.0,
            "preemptible eviction frees less capacity than planned"),
        FaultFamily(
            "region_degradation", "region_degradation", 0.0, 0.8,
            "surviving region loses a fraction of its own capacity"),
        FaultFamily(
            "dependency_storm", "storm_refrac", 0.0, 1.0,
            "restored services re-darken mid-recovery (cascading storm)"),
    )
}

# Canonical ordering — the column order of every severity matrix.
# Deliberately frozen to the ENGINE families above (before the
# request-plane families register below): ``severity_grid(..., FAMILIES)``
# must only emit knobs the sweep engine's ``validate_grid`` accepts.
FAMILIES: Tuple[str, ...] = tuple(FAULT_LIBRARY)

# Request-plane fault families (serving.workload drills): severities map
# onto workload knobs, not engine scenario knobs — campaigns over these
# pass ``families=REQUEST_FAMILIES`` and a drill oracle instead of a
# SweepEngine.  Registered in FAULT_LIBRARY so ``Ray`` validates them.
REQUEST_FAULT_LIBRARY: Dict[str, FaultFamily] = {
    f.name: f for f in (
        FaultFamily(
            "arrival_spike", "arrival_mult", 1.0, 8.0,
            "open-loop arrival-rate multiplier beyond the absorbed 2.0x"),
        FaultFamily(
            "retry_storm", "retry_storm", 0.0, 1.0,
            "speculative client-duplicate amplification per arrival"),
    )
}
FAULT_LIBRARY.update(REQUEST_FAULT_LIBRARY)
REQUEST_FAMILIES: Tuple[str, ...] = tuple(REQUEST_FAULT_LIBRARY)


def severity_grid(severity, families: Sequence[str] = FAMILIES
                  ) -> Dict[str, np.ndarray]:
    """Map a severity matrix onto an engine scenario grid.

    ``severity`` is ``(n, F)`` with column ``j`` the severity of
    ``families[j]``.  Returns a dict of ``(n,)`` float64 columns — one
    per family knob — suitable for ``SweepEngine.run``.  Every family's
    knob is always emitted (at its base value for zero severity) so grid
    keys, and therefore the engine's parameter set, stay constant
    across campaign rounds.
    """
    sev = np.atleast_2d(np.asarray(severity, np.float64))
    if sev.shape[1] != len(families):
        raise ValueError(
            f"severity has {sev.shape[1]} columns, expected "
            f"{len(families)} for families {families}")
    grid: Dict[str, np.ndarray] = {}
    for j, name in enumerate(families):
        fam = FAULT_LIBRARY[name]
        if fam.knob in grid:
            raise ValueError(f"duplicate knob {fam.knob!r}")
        grid[fam.knob] = fam.value(sev[:, j])
    return grid


def ray_severities(direction: Mapping[str, float], s,
                   families: Sequence[str] = FAMILIES) -> np.ndarray:
    """Severity matrix for scalar severities ``s`` along a ray.

    ``direction`` maps family name -> weight in (0, 1]; row ``i`` has
    ``s[i] * weight`` in each named family's column, zero elsewhere.
    """
    s = np.atleast_1d(np.asarray(s, np.float64))
    sev = np.zeros((s.shape[0], len(families)), np.float64)
    for name, w in direction.items():
        if name not in families:
            raise KeyError(f"unknown fault family {name!r}")
        sev[:, list(families).index(name)] = s * float(w)
    return sev


# ---------------------------------------------------------------------------
# Correlated sampler: Gaussian copula with Uniform(0, max_severity)
# marginals.  Positive off-diagonals make the *bad* tails co-occur —
# the paper's compound incidents (regional blackhole + traffic spike +
# quota shortfall) are the motivating case.
# ---------------------------------------------------------------------------

DEFAULT_CORR_PAIRS: Dict[Tuple[str, str], float] = {
    ("evict_shortfall", "traffic_spike"): 0.6,
    ("traffic_spike", "quota_shortfall"): 0.5,
    ("evict_shortfall", "quota_shortfall"): 0.4,
    ("dependency_storm", "region_degradation"): 0.3,
}


def correlation_matrix(families: Sequence[str] = FAMILIES,
                       pairs: Optional[Mapping[Tuple[str, str], float]] = None
                       ) -> np.ndarray:
    """Dense (F, F) correlation matrix from sparse named pairs."""
    pairs = DEFAULT_CORR_PAIRS if pairs is None else pairs
    idx = {name: j for j, name in enumerate(families)}
    corr = np.eye(len(families), dtype=np.float64)
    for (a, b), rho in pairs.items():
        if a in idx and b in idx:
            corr[idx[a], idx[b]] = corr[idx[b], idx[a]] = float(rho)
    # fail fast if the requested structure is not a valid correlation
    np.linalg.cholesky(corr)
    return corr


def _copula_severities(g: torch.Generator, chol: torch.Tensor,
                       max_sev: float, n: int) -> torch.Tensor:
    """(n, F) float32 severities: correlated normals -> uniform marginals
    (IEEE float32 product: ``resolve_device`` keeps TF32 off)."""
    z = torch.randn((n, chol.shape[0]), generator=g, dtype=torch.float32,
                    device=chol.device) @ chol.T
    u = torch.special.ndtr(z)                # Uniform(0,1) marginals
    return u * max_sev


def sample_faults(seed: int, n: int, *,
                  families: Sequence[str] = FAMILIES,
                  corr: Optional[np.ndarray] = None,
                  max_severity: float = 1.0,
                  device=None) -> Dict[str, object]:
    """Draw ``n`` correlated joint faults from one campaign seed on
    ``device`` (default: the CUDA card).

    Returns ``{"severity": (n, F) array, "families": tuple, "grid":
    scenario-grid dict}``.  Marginals are Uniform(0, max_severity);
    the rank correlation follows ``corr`` (Gaussian copula).  The
    stream is a ``torch.Generator`` on ``device`` seeded from
    ``stage_seed(seed, "faults")``, independent of the engine's
    blackhole/storm draws for the same campaign seed; one seed gives
    one draw on a given device.
    """
    dev = resolve_device(device)
    if corr is None:
        corr = correlation_matrix(families)
    corr = np.asarray(corr, np.float64)
    if corr.shape != (len(families),) * 2:
        raise ValueError(
            f"corr shape {corr.shape} != ({len(families)}, {len(families)})")
    chol = np.linalg.cholesky(corr)
    g = torch.Generator(device=dev)
    g.manual_seed(stage_seed(seed, "faults"))
    sev = _copula_severities(
        g, torch.from_numpy(chol.astype(np.float32)).to(dev),
        float(np.float32(max_severity)), int(n))
    sev = np.asarray(sev.cpu().numpy(), np.float64)
    sev = np.clip(sev, 0.0, max_severity)    # guard cdf rounding at the edges
    return {"severity": sev, "families": tuple(families),
            "grid": severity_grid(sev, families)}
