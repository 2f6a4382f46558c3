"""repro_torch.chaos — adversarial chaos-campaign engine (port of
``repro.chaos``).

Instead of sweeping rectangular scenario grids, a campaign *hunts* the
SLA-violating frontier: composable fault families with an explicit
correlation structure ([`faults`](faults.py)), bandit-allocated bisection
along fault-severity rays driven by the fused sweep engine's batched
verdicts ([`campaign`](campaign.py)), per-family frontier reports with
minimal-severity counterexamples and a bit-exact re-verification pass
([`report`](report.py)), and N>2-region failure topologies expanded onto
the engine's scenario axis ([`topology`](topology.py)).

The whole loop reuses ``SweepEngine`` — each round submits one
bucket-padded batch to the engine on its device — and every random
stage (blackhole draws, storm draws, fault sampling) derives an
independent stream from ONE campaign seed via
``core.scenarios.stage_seed``.
"""

from .campaign import Campaign, Ray, campaign_for_fleet, default_rays
from .faults import (FAMILIES, FAULT_LIBRARY, REQUEST_FAMILIES,
                     FaultFamily, correlation_matrix, sample_faults,
                     severity_grid)
from .report import CampaignReport, RayResult, verify_report
from .topology import RegionTopology, expand_failures, reduce_pattern_verdicts

__all__ = [
    "Campaign", "Ray", "campaign_for_fleet", "default_rays",
    "FAMILIES", "FAULT_LIBRARY", "REQUEST_FAMILIES", "FaultFamily",
    "correlation_matrix", "sample_faults", "severity_grid",
    "CampaignReport", "RayResult", "verify_report",
    "RegionTopology", "expand_failures", "reduce_pattern_verdicts",
]
