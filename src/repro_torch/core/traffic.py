"""City traffic model, peak detection, and the failover-mode rule.

The orchestrator's peak/non-peak decision (§4.1) is:
    mode = PEAK  iff  tv_failover >= T * tv_peak
with tv_peak the past week's peak and T the periodically-recomputed
threshold (the paper pins the *definition* of a peak failure at 85% of
weekly peak riders-on-trip).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence

from repro_torch.core.tiers import FULL_FAILOVER_CITY_FRACTION, PEAK_TRAFFIC_FRACTION


@dataclasses.dataclass(frozen=True)
class City:
    name: str
    weight: float          # share of global traffic
    home_region: str


def make_cities(n: int = 100, seed: int = 0,
                regions: Sequence[str] = ("regionA", "regionB")) -> List[City]:
    """Zipf-weighted cities split across two home regions."""
    ws = [1.0 / (i + 1) ** 0.8 for i in range(n)]
    tot = sum(ws)
    return [City(f"city-{i:03d}", ws[i] / tot, regions[i % len(regions)])
            for i in range(n)]


def diurnal_traffic(t_seconds: float, base: float = 1.0) -> float:
    """Global traffic level: daily double-hump + weekly modulation, in
    arbitrary units with weekly peak ~= base."""
    day = 86400.0
    week = 7 * day
    tod = (t_seconds % day) / day
    # two rush-hour humps
    hump = (math.exp(-((tod - 0.35) ** 2) / 0.008) +
            1.25 * math.exp(-((tod - 0.75) ** 2) / 0.01))
    dow = 0.85 + 0.15 * math.sin(2 * math.pi * ((t_seconds % week) / week) - 1.2)
    return base * (0.25 + 0.55 * hump) * dow


def weekly_peak(base: float = 1.0, samples: int = 2048) -> float:
    week = 7 * 86400.0
    return max(diurnal_traffic(i * week / samples, base) for i in range(samples))


@dataclasses.dataclass
class FailoverModeDetector:
    """Implements: peak iff tv_failover >= T * tv_peak."""
    threshold_fraction: float = PEAK_TRAFFIC_FRACTION
    tv_peak: float = 1.0

    def recompute_threshold(self, base: float = 1.0):
        self.tv_peak = weekly_peak(base)

    def mode(self, tv_failover: float) -> str:
        return ("peak" if tv_failover >= self.threshold_fraction * self.tv_peak
                else "non-peak")


def is_full_failover(cities_failed: int, cities_total: int) -> bool:
    return cities_failed > FULL_FAILOVER_CITY_FRACTION * cities_total


def region_traffic(cities: Sequence[City], assignment: Dict[str, str],
                   t_seconds: float, base: float = 1.0) -> Dict[str, float]:
    """Traffic per region given a city->region routing assignment."""
    g = diurnal_traffic(t_seconds, base)
    out: Dict[str, float] = {}
    for c in cities:
        r = assignment.get(c.name, c.home_region)
        out[r] = out.get(r, 0.0) + g * c.weight
    return out
