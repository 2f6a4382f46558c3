"""Vectorized Monte-Carlo overcommit simulator (paper §4.4).

Port of ``repro/core/overcommit_sim.py``.  The paper: "We built a
simulator that models cluster configurations and workloads, which
recommended a 1.5x overcommit factor."  Candidate factors x trials x
hosts are one broadcast on the device:

  - each host packs critical pods to ~stateless fill plus preemptible pods
    filling (factor-1) x capacity of extended resource;
  - per-pod demand is a correlated diurnal level + lognormal noise;
  - a factor is SAFE if P(host busy > evict threshold) stays under a target
    violation rate (QoS evictions are disruptive, so they must stay rare).

The recommendation is the largest safe factor on the grid, additionally
clamped by the analytic O_max memory bound (= 1.66x with paper constants).

The reference draws inside its kernel from ``jax.random``; here the draw
step (``_draws``: a host ``torch.Generator`` seeded from ``cfg.seed``, so
one seed gives the same draws on every device) is apart from the compute
step (``_host_busy``), which takes the draws — and so can take the
reference's realised draws too.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.tiers import QOS_EVICT_UTILIZATION, o_max
from repro_torch.kernels.backend import resolve_device


@dataclasses.dataclass(frozen=True)
class OvercommitSimConfig:
    n_hosts: int = 512
    n_trials: int = 64
    host_cores: float = 100.0
    critical_fill: float = 0.45       # fraction of physical cores requested
    critical_demand_mean: float = 0.40  # demand per requested core
    preempt_demand_mean: float = 0.40
    demand_sigma: float = 0.38        # lognormal sigma
    diurnal_amp: float = 0.30         # correlated load swing
    evict_threshold: float = QOS_EVICT_UTILIZATION
    max_violation_rate: float = 0.02  # hosts-over-threshold budget
    seed: int = 0


def _draws(cfg: OvercommitSimConfig, device=None) -> Dict[str, torch.Tensor]:
    """The simulator's random draws, float32 on ``device`` (default: the
    CUDA card): ``phase_u`` (n_trials, 1) Uniform(0, 1) per trial (the
    diurnal phase), ``z_crit`` and ``z_pre`` (n_trials, n_hosts) standard
    normals.  Drawn on the host from ``cfg.seed``, shared by every
    factor."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(int(cfg.seed))
    shape = (cfg.n_trials, cfg.n_hosts)
    out = {"phase_u": torch.rand((cfg.n_trials, 1), generator=g),
           "z_crit": torch.randn(shape, generator=g),
           "z_pre": torch.randn(shape, generator=g)}
    return {k: v.to(dev) for k, v in out.items()}


def _host_busy(cfg: OvercommitSimConfig, factor: torch.Tensor,
               draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Busy-core fraction of (n_trials, n_hosts) hosts at each factor:
    ``factor`` of shape ``(F,)`` gives ``(F, n_trials, n_hosts)``, a 0-d
    factor ``(n_trials, n_hosts)``."""
    # correlated diurnal phase per trial (cluster-wide load level)
    phase = draws["phase_u"] * 2 * np.pi
    diurnal = 1.0 + cfg.diurnal_amp * torch.sin(phase)
    ln = lambda z: torch.exp(cfg.demand_sigma * z
                             - 0.5 * cfg.demand_sigma ** 2)
    crit_req = cfg.critical_fill * cfg.host_cores
    f = factor.reshape(factor.shape + (1, 1))
    pre_req = (f - 1.0) * cfg.host_cores
    crit_busy = crit_req * cfg.critical_demand_mean * ln(draws["z_crit"]) \
        * diurnal
    pre_busy = pre_req * cfg.preempt_demand_mean * ln(draws["z_pre"]) \
        * diurnal
    return (crit_busy + pre_busy) / torch.full(
        (), cfg.host_cores, dtype=torch.float32, device=factor.device)


def violation_rate(cfg: OvercommitSimConfig, factor: float,
                   device=None) -> float:
    dev = resolve_device(device)
    busy = _host_busy(cfg, torch.tensor(factor, dtype=torch.float32,
                                        device=dev), _draws(cfg, dev))
    return float((busy > cfg.evict_threshold).to(torch.float32).mean())


def _grid_violation_rates(cfg: OvercommitSimConfig, factors: torch.Tensor,
                          draws: Optional[Dict[str, torch.Tensor]] = None
                          ) -> torch.Tensor:
    """Per-factor violation rates over the whole factors x trials x hosts
    grid in one broadcast, on ``factors``' device (``draws`` default:
    ``_draws(cfg)`` there)."""
    draws = _draws(cfg, factors.device) if draws is None else draws
    busy = _host_busy(cfg, factors, draws)
    return (busy > cfg.evict_threshold).to(torch.float32).mean(dim=(1, 2))


def factor_grid(grid_lo: float, grid_hi: float,
                grid_step: float) -> np.ndarray:
    """Candidate-factor grid with an exact endpoint (rounding a
    ``linspace`` over the rounded step count keeps every factor and the
    endpoint exact, where ``np.arange`` drifts)."""
    n = max(0, int(round((grid_hi - grid_lo) / grid_step)))
    return np.round(np.linspace(grid_lo, grid_lo + n * grid_step, n + 1), 9)


def recommend_factor(cfg: OvercommitSimConfig = OvercommitSimConfig(),
                     grid_lo: float = 1.0, grid_hi: float = 2.0,
                     grid_step: float = 0.05, device=None
                     ) -> Dict[str, object]:
    """Sweep the factor grid on ``device`` (default: the CUDA card) and
    pick the largest safe factor, clamped by O_max.

    The result carries an explicit ``safe`` flag: when NO factor on the
    grid clears the violation budget and the O_max bound, ``recommended``
    falls back to ``grid_lo`` *without* implying it is safe."""
    dev = resolve_device(device)
    factors = factor_grid(grid_lo, grid_hi, grid_step)
    rates = _grid_violation_rates(
        cfg, torch.from_numpy(factors.astype(np.float32)).to(dev)
    ).cpu().numpy()
    omax = o_max()
    valid = (rates <= cfg.max_violation_rate) & (factors <= omax)
    safe = bool(valid.any())
    # grid is ascending: the argmax over the reversed mask is the largest
    # safe factor
    best = (float(factors[len(valid) - 1 - int(np.argmax(valid[::-1]))])
            if safe else grid_lo)
    return {
        "factors": [round(float(f), 3) for f in factors],
        "violation_rates": [float(r) for r in rates],
        "o_max": omax,
        "safe": safe,
        "recommended": round(best, 3),
    }
