"""Struct-of-arrays fleet representation — the vectorized simulation core.

The seed implementation carried one Python ``SEState`` object per
service-environment, so every orchestrator phase was a dict loop and the
whole stack only ran at ``scale=0.02``.  ``FleetState`` holds the same
state as parallel numpy arrays (one row per service-environment); the
orchestrator, QoS controller, drills and the scenario-ensemble driver all
operate on boolean masks and reductions over these arrays, which is what
lets ``scale=1.0`` (~22k services, paper Table 3) synthesize and fail over
in seconds and lets JAX vmap scenario ensembles over the aggregates.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core.tiers import (BASELINE_CORES, DEFAULT_CLASS_OF_TIER,
                              SERVICES_PER_TIER, FailureClass, Tier)

# ---------------------------------------------------------------------------
# Codes (int8 columns)
# ---------------------------------------------------------------------------

PLACEMENT_STEADY, PLACEMENT_BURST, PLACEMENT_CLOUD, PLACEMENT_DOWN = range(4)
PLACEMENT_NAMES = ("steady", "burst", "cloud", "down")
PLACEMENT_CODE = {n: i for i, n in enumerate(PLACEMENT_NAMES)}

# steady-pool occupancy: set by the orchestrator at placement time;
# POOL_NONE = not (yet) accounted against any pool — never released
POOL_STATELESS, POOL_OVERCOMMIT, POOL_NONE = 0, 1, 2

_FC_ORDER = (FailureClass.ALWAYS_ON, FailureClass.ACTIVE_MIGRATE,
             FailureClass.RESTORE_LATER, FailureClass.TERMINATE)
FCLASS_CODE: Dict[FailureClass, int] = {fc: i for i, fc in enumerate(_FC_ORDER)}
CODE_FCLASS: Dict[int, FailureClass] = {i: fc for fc, i in FCLASS_CODE.items()}
AO, AM, RL, TM = (FCLASS_CODE[fc] for fc in _FC_ORDER)


@dataclasses.dataclass
class EdgeArrays:
    """Dependency edges in array form (for vectorized drills/analysis)."""
    src: np.ndarray            # caller row index, int32
    dst: np.ndarray            # callee row index, int32
    fail_open: np.ndarray      # bool — False = fail-close (UNSAFE)
    # per-edge RPC volume (Table 2 cell volume split across the cell's
    # edges) — the graph engine uses it to rank hardening candidates
    weight: Optional[np.ndarray] = None   # float32

    @property
    def n(self) -> int:
        return len(self.src)


@dataclasses.dataclass
class FleetState:
    """Parallel arrays over service-environments (row = one SE)."""
    names: List[str]
    tier: np.ndarray               # int8 Tier value
    fclass: np.ndarray             # int8 FCLASS_CODE
    cores_per_replica: np.ndarray  # float64
    replicas: np.ndarray           # int64 — steady-state spec
    replicas_live: np.ndarray      # int64
    placement: np.ndarray          # int8 PLACEMENT_*
    pool: np.ndarray               # int8 POOL_* — steady pool occupied
    locked: np.ndarray             # bool
    traffic_enabled: np.ndarray    # bool
    edges: Optional[EdgeArrays] = None
    index: Dict[str, int] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not self.index:
            self.index = {n: i for i, n in enumerate(self.names)}

    # ------------------------------------------------------------------
    @property
    def n(self) -> int:
        return len(self.names)

    @property
    def spec_cores(self) -> np.ndarray:
        return self.cores_per_replica * self.replicas

    @property
    def cores_live(self) -> np.ndarray:
        return self.cores_per_replica * self.replicas_live

    @property
    def preemptible(self) -> np.ndarray:
        return self.fclass >= RL

    @property
    def survives(self) -> np.ndarray:
        return self.fclass <= AM

    def class_mask(self, fc) -> np.ndarray:
        code = FCLASS_CODE[fc] if isinstance(fc, FailureClass) else fc
        return self.fclass == code

    def class_cores(self, fc, placement: Optional[str] = None) -> float:
        m = self.class_mask(fc)
        if placement is not None:
            m = m & (self.placement == PLACEMENT_CODE[placement])
        return float(self.cores_live[m].sum())

    def class_envs(self, fc, placement: str) -> int:
        m = (self.class_mask(fc)
             & (self.placement == PLACEMENT_CODE[placement])
             & (self.replicas_live > 0))
        return int(np.count_nonzero(m))

    def class_core_totals(self) -> Tuple[float, float, float, float]:
        """(always_on, active_migrate, restore_later, terminate) spec cores."""
        cores = self.spec_cores
        return tuple(float(cores[self.fclass == c].sum())
                     for c in (AO, AM, RL, TM))

    def apply_ufa_target_classes(self) -> int:
        """Array analogue of ``service.apply_ufa_target_classes``:
        T1 Always-On -> Active-Migrate (paper Table 5 goal state)."""
        m = (self.tier == int(Tier.T1)) & (self.fclass == AO)
        self.fclass[m] = AM
        return int(np.count_nonzero(m))

    # ------------------------------------------------------------------
    @classmethod
    def from_specs(cls, fleet: Dict[str, "object"],
                   with_edges: bool = False) -> "FleetState":
        names = list(fleet)
        n = len(names)
        tier = np.empty(n, np.int8)
        fclass = np.empty(n, np.int8)
        cpr = np.empty(n, np.float64)
        replicas = np.empty(n, np.int64)
        for i, s in enumerate(fleet.values()):
            tier[i] = int(s.tier)
            fclass[i] = FCLASS_CODE[s.failure_class]
            cpr[i] = s.cores_per_replica
            replicas[i] = s.replicas
        fs = cls(names=names, tier=tier, fclass=fclass,
                 cores_per_replica=cpr, replicas=replicas,
                 replicas_live=replicas.copy(),
                 placement=np.zeros(n, np.int8),
                 pool=np.full(n, POOL_NONE, np.int8),
                 locked=np.zeros(n, bool),
                 traffic_enabled=np.ones(n, bool))
        if with_edges:
            fs.edges = edges_from_specs(fleet, fs.index)
        return fs


def edges_from_specs(fleet: Dict[str, "object"],
                     index: Optional[Dict[str, int]] = None) -> EdgeArrays:
    index = index or {n: i for i, n in enumerate(fleet)}
    src, dst, fo = [], [], []
    for name, s in fleet.items():
        i = index[name]
        for d in s.deps:
            j = index.get(d)
            if j is None:
                continue
            src.append(i)
            dst.append(j)
            fo.append(bool(s.fail_open.get(d, True)))
    src_a = np.asarray(src, np.int32)
    dst_a = np.asarray(dst, np.int32)
    tier = np.fromiter((int(s.tier) for s in fleet.values()), np.int8,
                       len(fleet))
    return EdgeArrays(src=src_a, dst=dst_a,
                      fail_open=np.asarray(fo, bool),
                      weight=_edge_weights(tier, src_a, dst_a))


def _edge_weights(tier: np.ndarray, src: np.ndarray,
                  dst: np.ndarray) -> np.ndarray:
    """Per-edge RPC volume: the Table 2 cell volume split evenly across the
    edges in that (caller_tier, callee_tier) cell — the same rule
    ``dependency.generate_traces`` uses to weight its sampled traffic."""
    from repro_torch.core.service import _TABLE2
    n_tiers = len(_T)
    vol = np.asarray([[_TABLE2[t][c] for c in range(n_tiers)] for t in _T],
                     np.float64)
    cell = tier[src].astype(np.int64) * n_tiers + tier[dst]
    counts = np.bincount(cell, minlength=n_tiers * n_tiers)
    return (vol.ravel()[cell]
            / np.maximum(counts[cell], 1)).astype(np.float32)


# ---------------------------------------------------------------------------
# Array-native fleet synthesis (fast path for paper scale)
# ---------------------------------------------------------------------------

_T = list(Tier)
_REPLICA_OPTIONS = np.array([0.5, 1.0, 2.0, 4.0])


def synthesize_fleet_state(scale: float = 1.0, seed: int = 0,
                           unsafe_fraction: float = 0.08,
                           mean_deps: float = 6.0,
                           demand_fraction: float = 0.25,
                           with_edges: bool = True,
                           unsafe_chain_fraction: float = 0.0) -> FleetState:
    """Array-native analogue of ``service.synthesize_fleet``: same tier
    structure (Tables 1-3), same footprint distribution, no per-service
    Python objects.  ~22k services synthesize in well under a second.

    unsafe_chain_fraction plants fail-close edges between *critical*
    services (caller and callee both survive failover).  These edges break
    nothing on their own — critical services never go dark — but they relay
    breakage: a critical caller whose critical callee breaks through an
    unsafe preemptible dependency breaks too.  They are the transitive
    failure chains the graph engine's multi-hop propagation exists to find
    (default 0.0 keeps the one-hop fleet shape the seed tests pin down).
    """
    from repro_torch.core.service import _TABLE2   # single source for Table 2
    rng = np.random.default_rng(seed)

    tiers, cprs, reps = [], [], []
    counts = {}
    for tier in _T:
        n = max(2, int(round(SERVICES_PER_TIER[tier] * scale)))
        counts[tier] = n
        tier_cores = BASELINE_CORES[tier] * scale * demand_fraction
        w = rng.lognormal(0.0, 1.2, n)
        cores = tier_cores * w / w.sum()
        # options c in (0.5, 1, 2, 4) with c <= 2*cores; 0.5 as fallback
        k = np.searchsorted(_REPLICA_OPTIONS, 2 * cores, side="right")
        pick = rng.integers(0, np.maximum(k, 1))
        cpr = _REPLICA_OPTIONS[np.where(k > 0, pick, 0)]
        tiers.append(np.full(n, int(tier), np.int8))
        cprs.append(cpr)
        reps.append(np.maximum(1, np.round(cores / cpr)).astype(np.int64))

    tier_arr = np.concatenate(tiers)
    cpr_arr = np.concatenate(cprs)
    rep_arr = np.concatenate(reps)
    n = len(tier_arr)
    fclass = np.empty(n, np.int8)
    for t in _T:
        fclass[tier_arr == int(t)] = FCLASS_CODE[DEFAULT_CLASS_OF_TIER[t]]
    names = [f"{Tier(int(t)).name.lower()}-svc-{i:05d}"
             for i, t in enumerate(tier_arr)]

    fs = FleetState(names=names, tier=tier_arr, fclass=fclass,
                    cores_per_replica=cpr_arr, replicas=rep_arr,
                    replicas_live=rep_arr.copy(),
                    placement=np.zeros(n, np.int8),
                    pool=np.full(n, POOL_NONE, np.int8),
                    locked=np.zeros(n, bool),
                    traffic_enabled=np.ones(n, bool))

    if with_edges:
        # tier start offsets in the concatenated arrays
        starts, off = {}, 0
        for t in _T:
            starts[t] = off
            off += counts[t]
        n_deps = np.maximum(0, rng.normal(mean_deps, 2.0, n)).astype(np.int64)
        src = np.repeat(np.arange(n, dtype=np.int32), n_deps)
        m = len(src)
        # callee tier ~ Table 2 row of the caller's tier
        row_cdf = {int(t): np.cumsum(np.asarray(_TABLE2[t], np.float64)
                                     / sum(_TABLE2[t])) for t in _T}
        u = rng.random(m)
        callee_tier = np.empty(m, np.int8)
        for t in _T:
            sel = tier_arr[src] == int(t)
            callee_tier[sel] = np.searchsorted(row_cdf[int(t)], u[sel])
        callee_tier = np.minimum(callee_tier, len(_T) - 1)
        # uniform callee within the tier
        base = np.array([starts[Tier(int(c))] for c in range(len(_T))],
                        np.int64)
        span = np.array([counts[Tier(int(c))] for c in range(len(_T))],
                        np.int64)
        dst = (base[callee_tier]
               + rng.integers(0, span[callee_tier])).astype(np.int32)
        keep = src != dst
        src, dst, callee_tier = src[keep], dst[keep], callee_tier[keep]
        # fail-close only on tier-inverted (critical -> preemptible) edges
        inverted = (fclass[src] <= AM) & (fclass[dst] >= RL)
        fail_close = inverted & (rng.random(len(src)) < unsafe_fraction)
        if unsafe_chain_fraction > 0.0:
            # relay edges: fail-close between critical services (multi-hop
            # chains).  Drawn AFTER the inverted-edge draw so that
            # unsafe_chain_fraction=0.0 is bit-identical to the seed stream.
            chain = (fclass[src] <= AM) & (fclass[dst] <= AM)
            fail_close |= chain & (rng.random(len(src))
                                   < unsafe_chain_fraction)
        fs.edges = EdgeArrays(src=src, dst=dst, fail_open=~fail_close,
                              weight=_edge_weights(tier_arr, src, dst))
    return fs
