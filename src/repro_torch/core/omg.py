"""OMG — the UFA failover/failback orchestrator (paper §4.1, Figs 5/6).

Drives the full peak-failover sequence over the discrete-event loop:

  detect mode -> lockdown -> BBM-evict Terminate/Restore-Later ->
  batch->burst conversion (preheat: evict batch jobs + prefetch images) ->
  MBB-migrate Active-Migrate into burst, city-by-city traffic shift ->
  Always-On in-place scale-up into freed headroom ->
  Restore-Later restore in burst (+cloud as last resort, honoring cloud
  provisioning latency) within 1h RTO ->
  (operator-triggered) failback mirroring the MBB flow.

The orchestrator is fully vectorized over a ``FleetState`` struct-of-arrays:
every phase is a masked batch update and every snapshot a handful of array
reductions, so a paper-scale fleet (~22k service-environments) fails over
in well under a second of wall time.  ``orch.se`` exposes per-service views
backed by the arrays for tests, examples and callbacks.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch import obs
from repro_torch.core.capacity import RegionCapacity
from repro_torch.core.events import EventLoop
from repro_torch.core.fleet_state import (AM, AO, PLACEMENT_BURST, PLACEMENT_CLOUD,
                                    PLACEMENT_DOWN, PLACEMENT_NAMES,
                                    PLACEMENT_STEADY, POOL_NONE,
                                    POOL_OVERCOMMIT, POOL_STATELESS, RL, TM,
                                    CODE_FCLASS, FleetState)
from repro_torch.core.service import ServiceSpec
from repro_torch.core.tiers import RTO_SECONDS, FailureClass, Tier
from repro_torch.core.traffic import FailoverModeDetector


def _first_fit(cores: np.ndarray, free: float) -> np.ndarray:
    """Greedy first-fit in array order against ``free`` capacity.  Returns
    the boolean take-mask.  The common all-fit case is one cumsum; the
    overflow tail (rare — regions are sized so everything fits) falls back
    to a scalar walk, matching per-item ``PoolState.alloc`` semantics."""
    m = len(cores)
    if m == 0:
        return np.zeros(0, bool)
    csum = np.cumsum(cores)
    taken = csum <= free + 1e-9
    k = int(np.count_nonzero(taken))
    if k == m:
        return taken
    rem = free - (csum[k - 1] if k > 0 else 0.0)
    for i in range(k, m):
        if cores[i] <= rem + 1e-9:
            taken[i] = True
            rem -= cores[i]
    return taken


class SEView:
    """Read view of one service-environment row (compat with the seed's
    ``SEState`` object API: tests and examples read these attributes)."""

    __slots__ = ("_fs", "_i", "_spec")

    def __init__(self, fs: FleetState, i: int, spec: Optional[ServiceSpec]):
        self._fs = fs
        self._i = i
        self._spec = spec

    @property
    def spec(self) -> ServiceSpec:
        if self._spec is None:
            fs, i = self._fs, self._i
            self._spec = ServiceSpec(
                name=fs.names[i], tier=Tier(int(fs.tier[i])),
                failure_class=CODE_FCLASS[int(fs.fclass[i])],
                cores_per_replica=float(fs.cores_per_replica[i]),
                replicas=int(fs.replicas[i]))
        return self._spec

    @property
    def placement(self) -> str:
        return PLACEMENT_NAMES[self._fs.placement[self._i]]

    @property
    def replicas_live(self) -> int:
        return int(self._fs.replicas_live[self._i])

    @property
    def locked(self) -> bool:
        return bool(self._fs.locked[self._i])

    @property
    def traffic_enabled(self) -> bool:
        return bool(self._fs.traffic_enabled[self._i])

    @property
    def cores_live(self) -> float:
        return float(self._fs.cores_live[self._i])


SEState = SEView   # seed-name compat


@dataclasses.dataclass
class Timeline:
    """Snapshot log: every series stays aligned with ``t``.

    A metric may join mid-run (e.g. ``burst_online`` only appears during
    the conversion ramp): its series is NaN-backfilled for the snapshots
    it missed, and NaN-padded whenever a later snapshot omits it, so
    ``as_arrays`` always returns equal-length arrays — never ragged."""
    t: List[float] = dataclasses.field(default_factory=list)
    series: Dict[str, List[float]] = dataclasses.field(default_factory=dict)

    def snap(self, now: float, **metrics: float):
        self.t.append(now)
        n = len(self.t)
        for k, v in metrics.items():
            col = self.series.get(k)
            if col is None:
                col = [float("nan")] * (n - 1)
                self.series[k] = col
            col.append(float(v))
        for col in self.series.values():
            if len(col) < n:
                col.append(float("nan"))

    def at(self, key: str) -> List[Tuple[float, float]]:
        return [(t, v) for t, v in zip(self.t, self.series[key])
                if v == v]          # skip NaN (snapshots without this key)

    def as_arrays(self) -> Dict[str, np.ndarray]:
        """Deterministically ordered (``t`` first, then sorted keys),
        every array aligned to ``len(t)``."""
        out = {"t": np.asarray(self.t, np.float64)}
        for k in sorted(self.series):
            out[k] = np.asarray(self.series[k], np.float64)
        return out


@dataclasses.dataclass
class FailoverReport:
    mode: str
    timeline: Timeline
    burst_full_at_s: Optional[float] = None
    am_migrated_at_s: Optional[float] = None
    rl_restored_at_s: Optional[float] = None
    rl_rto_met: bool = False
    cloud_cores_used: float = 0.0
    cloud_provision_s: float = 0.0     # provisioning latency spent (§4.6)
    always_on_ok: bool = True
    evictions_first_hour: int = 0
    notes: List[str] = dataclasses.field(default_factory=list)


class Orchestrator:
    """UFA failover orchestration for one surviving region."""

    # tunables calibrated to the paper's reported behavior
    KILL_LATENCY_S = 5.0                 # cluster-level kill, bypasses workflows
    BATCH_EVICT_S = 90.0                 # preemptible batch jobs drain
    PREFETCH_S = 180.0                   # p2p image prefetch into burst zones
    SPAWN_CORES_PER_HOST_S = 0.45        # fig 7: burst fully online ~8 min
    MBB_WAVE_S = 45.0                    # one parallel migration wave
    MBB_PARALLELISM = 2000               # envs per wave (paper §4.3)
    RL_RESTORE_WAVE_S = 120.0
    CITY_WAVE_S = 30.0                   # city-group traffic moves
    TRAFFIC_MULTIPLIER = 2.0             # surviving region absorbs 2x

    def __init__(self, fleet: Union[Dict[str, ServiceSpec], FleetState],
                 region: RegionCapacity,
                 loop: Optional[EventLoop] = None, scale: float = 1.0,
                 on_evict: Optional[Callable] = None,
                 on_migrate: Optional[Callable] = None,
                 on_restore: Optional[Callable] = None,
                 tracer=None):
        if isinstance(fleet, FleetState):
            self.fleet: Optional[Dict[str, ServiceSpec]] = None
            self.fs = fleet
        else:
            self.fleet = fleet
            self.fs = FleetState.from_specs(fleet)
        self.region = region
        self.loop = loop or EventLoop()
        if tracer is not None:
            # every scheduled wave/grant/restore becomes a sim-time span
            self.loop.tracer = tracer
        self.scale = scale
        self.on_evict = on_evict
        self.on_migrate = on_migrate
        self.on_restore = on_restore
        self.detector = FailoverModeDetector()
        self.timeline = Timeline()
        self._se_views: Optional[Dict[str, SEView]] = None
        self._place_steady_state()
        self.report: Optional[FailoverReport] = None
        self._state = "steady"
        self._cloud_ready_at = 0.0
        self._pending_cloud = 0
        self._rl_waves_done = False

    # ------------------------------------------------------------------
    @property
    def se(self) -> Dict[str, SEView]:
        """Per-service views over the arrays (lazy; tests/examples only)."""
        if self._se_views is None:
            get = self.fleet.get if self.fleet is not None else lambda _n: None
            self._se_views = {
                name: SEView(self.fs, i, get(name))
                for i, name in enumerate(self.fs.names)}
        return self._se_views

    def _spec_of(self, i: int) -> ServiceSpec:
        return self.se[self.fs.names[i]].spec

    def _emit(self, cb: Optional[Callable], mask: np.ndarray):
        if cb is None:
            return
        for i in np.flatnonzero(mask):
            cb(self._spec_of(int(i)))

    # ------------------------------------------------------------------
    def _place_steady_state(self):
        """Steady state: Always-On/Active-Migrate in the stateless pool,
        Restore-Later/Terminate opportunistically in the overcommit pool
        (overflow spills into stateless fragmentation slack — tracked, so
        eviction later frees the pool each SE actually occupies)."""
        fs = self.fs
        cores = fs.spec_cores
        pre = fs.preemptible
        fs.pool[:] = POOL_NONE

        idx = np.flatnonzero(pre)
        taken = _first_fit(cores[idx], self.region.steady.overcommit.free)
        oc_idx = idx[taken]
        fs.pool[oc_idx] = POOL_OVERCOMMIT
        self.region.steady.overcommit.used += float(cores[oc_idx].sum())

        overflow = np.zeros(fs.n, bool)
        overflow[idx[~taken]] = True
        sl_idx = np.flatnonzero(~pre | overflow)
        taken_sl = _first_fit(cores[sl_idx], self.region.steady.stateless.free)
        fs.pool[sl_idx[taken_sl]] = POOL_STATELESS
        self.region.steady.stateless.used += float(cores[sl_idx[taken_sl]].sum())

    # ------------------------------------------------------------------
    def timeline_config(self):
        """Extract the aggregate inputs the array-native timeline kernel
        (``repro_torch.core.timeline_sim``) needs so that the ``lax.scan``
        simulator and this orchestrator consume *identical* state: class
        core totals, the post-placement pool occupancy (including the
        overcommit-spill split), batch/cloud sizing and the wave/ramp
        tunables.  Call in steady state (before ``failover``)."""
        from repro_torch.core.timeline_sim import extract_timeline_config
        return extract_timeline_config(self)

    # ------------------------------------------------------------------
    def sweep_engine(self, *, graph=None, seed: int = 0, ts=None,
                     device=None):
        """Fused sweep engine over THIS orchestrator's steady state: the
        analytic model, the timeline scan and (with ``graph``) the
        dependency propagation composed in one jitted, device-parallel
        pipeline (``repro_torch.core.sweep_engine``).  Call in steady state —
        it snapshots ``timeline_config()``; the returned engine then runs
        arbitrary scenario grids (256 .. 100k+) without touching the
        orchestrator again."""
        from repro_torch.core.scenarios import FleetAggregates
        from repro_torch.core.sweep_engine import SweepEngine
        agg = (FleetAggregates.from_fleet_state(self.fs)
               if hasattr(self.fs, "fclass")
               else FleetAggregates.from_fleet(self.fs))
        return SweepEngine(agg, self.timeline_config(), graph=graph,
                           seed=seed, ts=ts, device=device)

    # ------------------------------------------------------------------
    def class_cores(self, fc: FailureClass, placement: Optional[str] = None
                    ) -> float:
        return self.fs.class_cores(fc, placement)

    def class_envs(self, fc: FailureClass, placement: str) -> int:
        return self.fs.class_envs(fc, placement)

    def _snap(self, **extra):
        fs = self.fs
        burst = (self.region.batch.burst.used
                 if self.region.batch.burst else 0.0)
        burst_cap = (self.region.batch.burst.capacity
                     if self.region.batch.burst else 0.0)
        pl, fc = fs.placement, fs.fclass
        down = pl == PLACEMENT_DOWN
        live = fs.replicas_live > 0
        steady_live = (pl == PLACEMENT_STEADY) & live

        def envs(cmask, pcode):
            return int(np.count_nonzero(cmask & (pl == pcode) & live))

        rl_m, tm_m, am_m = fc == RL, fc == TM, fc == AM
        self.timeline.snap(
            self.loop.now,
            steady_used=self.region.steady.stateless.used,
            overcommit_used=self.region.steady.overcommit.used,
            burst_capacity=burst_cap,
            burst_used=burst,
            cloud_used=self.region.cloud.provisioned,
            rl_t_steady=int(np.count_nonzero((rl_m | tm_m) & steady_live)),
            rl_bursted=(envs(rl_m, PLACEMENT_BURST)
                        + envs(rl_m, PLACEMENT_CLOUD)),
            rl_not_bursted=int(np.count_nonzero(rl_m & down)),
            terminated=int(np.count_nonzero(tm_m & down)),
            am_steady=envs(am_m, PLACEMENT_STEADY),
            am_bursted=envs(am_m, PLACEMENT_BURST),
            utilization=self._utilization(),
            **extra)

    def _utilization(self) -> float:
        # demand-weighted: live cores x traffic multiplier on critical SEs
        fs = self.fs
        mult = self.TRAFFIC_MULTIPLIER if self._state != "steady" else 1.0
        steady = fs.placement == PLACEMENT_STEADY
        pre = fs.preemptible
        demand = np.where(pre, 0.35, 0.62)
        m = np.where(fs.survives, mult, 1.0)
        busy = float((fs.cores_live * demand * m)[steady].sum())
        return min(1.0, busy / max(1.0, self.region.steady.physical_cores))

    # ------------------------------------------------------------------
    # Failover
    # ------------------------------------------------------------------
    def failover(self, tv_failover: float = 1.0) -> FailoverReport:
        fs = self.fs
        mode = self.detector.mode(tv_failover)
        rep = FailoverReport(mode=mode, timeline=self.timeline)
        self.report = rep
        self._state = "failover"
        self.loop.log(f"failover start, mode={mode}")
        self._snap()
        if mode == "non-peak":
            # only city traffic moves; nothing is preempted
            self.loop.schedule(self.CITY_WAVE_S * 4, lambda: self._snap(),
                               "city-traffic")
            rep.always_on_ok = True
            rep.rl_rto_met = True
            self.loop.run()
            return rep

        # ---- peak mode ----
        t0 = self.loop.now
        # 1. lockdown
        fs.locked[fs.fclass != AO] = True
        self.loop.log("lockdown complete")

        # 2. immediate BBM eviction of Terminate + Restore-Later
        def evict_all():
            mask = fs.preemptible & (fs.placement == PLACEMENT_STEADY)
            cores = fs.cores_live
            self.region.steady.overcommit.release(
                float(cores[mask & (fs.pool == POOL_OVERCOMMIT)].sum()))
            self.region.steady.stateless.release(
                float(cores[mask & (fs.pool == POOL_STATELESS)].sum()))
            fs.placement[mask] = PLACEMENT_DOWN
            fs.replicas_live[mask] = 0
            fs.traffic_enabled[mask] = False
            fs.pool[mask] = POOL_NONE
            self._emit(self.on_evict, mask)
            obs.inc("ufa_orch_envs_total", int(mask.sum()), action="evicted")
            self.loop.log(f"BBM evicted {int(mask.sum())} preemptible SEs")
            self._snap()
        self.loop.schedule(self.KILL_LATENCY_S, evict_all, "bbm-evict")

        # 3. batch -> burst conversion (preheat)
        burst_pool_holder: Dict[str, object] = {}

        def start_conversion():
            pool = self.region.batch.convert()
            pool_full = pool.capacity
            burst_pool_holder["pool"] = pool
            # capacity comes online progressively (spawner ramp, rate
            # proportional to batch-cluster host count -> scale-invariant)
            steps = 10
            rate = self.SPAWN_CORES_PER_HOST_S * self.region.batch.n_hosts
            ramp_total = pool_full / rate if pool_full > 0 else 0.0
            self._online = 0.0

            def make_tick(i):
                def tick():
                    frac = (i + 1) / steps
                    self._online = pool_full * frac
                    self._snap(burst_online=self._online)
                    if i == steps - 1:
                        rep.burst_full_at_s = self.loop.now - t0
                        self.loop.log("burst capacity fully online")
                        migrate_am()
                        restore_rl()
                return tick
            for i in range(steps):
                self.loop.schedule(ramp_total * (i + 1) / steps, make_tick(i),
                                   "burst-tick")
        self.loop.schedule(self.BATCH_EVICT_S + self.PREFETCH_S,
                           start_conversion, "burst-conversion")

        # 4. MBB migration of Active-Migrate into burst (masked waves)
        def migrate_am():
            pool = burst_pool_holder["pool"]
            ams = np.flatnonzero((fs.fclass == AM)
                                 & (fs.placement == PLACEMENT_STEADY))
            waves = [ams[i:i + self.MBB_PARALLELISM]
                     for i in range(0, len(ams), self.MBB_PARALLELISM)]

            def run_wave(idx):
                def w():
                    wave = waves[idx]
                    cores = fs.cores_live[wave]
                    taken = _first_fit(cores, pool.free)
                    moved = wave[taken]
                    pool.used += float(cores[taken].sum())
                    # make-before-break: new up, traffic re-pointed,
                    # old instances terminated -> steady capacity freed
                    # (only for SEs actually accounted in the pool)
                    self.region.steady.stateless.release(float(
                        fs.cores_live[moved[fs.pool[moved]
                                            == POOL_STATELESS]].sum()))
                    fs.placement[moved] = PLACEMENT_BURST
                    fs.pool[moved] = POOL_NONE
                    for i in wave[~taken]:
                        rep.notes.append(
                            f"burst full; {fs.names[i]} stays in steady")
                    if self.on_migrate is not None:
                        for i in moved:
                            self.on_migrate(self._spec_of(int(i)))
                    obs.inc("ufa_orch_envs_total", int(len(moved)),
                            action="migrated")
                    self._snap()
                    if idx + 1 < len(waves):
                        self.loop.schedule(self.MBB_WAVE_S, run_wave(idx + 1),
                                           "mbb-wave")
                    else:
                        rep.am_migrated_at_s = self.loop.now - t0
                        self.loop.log("Active-Migrate migration complete")
                        scale_always_on()
                return w
            if waves:
                self.loop.schedule(self.MBB_WAVE_S, run_wave(0), "mbb-wave")
            else:
                rep.am_migrated_at_s = self.loop.now - t0
                scale_always_on()

        # 5. Always-On in-place expansion to absorb 2x traffic
        def scale_always_on():
            ao_mask = fs.fclass == AO
            need = float(fs.cores_live[ao_mask].sum()) * \
                (self.TRAFFIC_MULTIPLIER - 1.0)
            got = self.region.steady.stateless.alloc(need)
            if not got:
                # failover buffer + freed overcommit cover it by construction;
                # flag if not
                rep.always_on_ok = False
                rep.notes.append(
                    f"Always-On scale-up short by "
                    f"{need - self.region.steady.stateless.free:.0f} cores")
            else:
                fs.replicas_live[ao_mask] = (
                    fs.replicas_live[ao_mask]
                    * self.TRAFFIC_MULTIPLIER).astype(np.int64)
            self.loop.log("Always-On scaled for 2x traffic")
            self._snap()

        # 6. Restore-Later restoration within 1h RTO (burst, then cloud —
        #    cloud grants arrive after their provisioning delay, §4.6)
        def finalize_rl():
            rep.rl_restored_at_s = self.loop.now - t0
            rep.rl_rto_met = (rep.rl_restored_at_s <=
                              RTO_SECONDS[FailureClass.RESTORE_LATER])
            rep.cloud_cores_used = self.region.cloud.provisioned
            self.loop.log("Restore-Later restoration complete")

        def restore_rl():
            pool = burst_pool_holder["pool"]
            rls_idx = np.flatnonzero((fs.fclass == RL)
                                     & (fs.placement == PLACEMENT_DOWN))
            rls = rls_idx[np.argsort(fs.tier[rls_idx], kind="stable")]
            spec_cores = fs.spec_cores

            def activate(items: np.ndarray, pcode: int):
                fs.placement[items] = pcode
                fs.replicas_live[items] = fs.replicas[items]
                fs.traffic_enabled[items] = True
                if self.on_restore is not None:
                    for i in items:
                        self.on_restore(self._spec_of(int(i)))
                obs.inc("ufa_orch_envs_total", int(len(items)),
                        action="restored")

            def restore_batch(start):
                def w():
                    wave = rls[start:start + self.MBB_PARALLELISM]
                    cores = spec_cores[wave]
                    taken = _first_fit(cores, pool.free)
                    cloud_pos = np.flatnonzero(~taken)
                    cloud_cores = cores[cloud_pos]
                    quota_left = (self.region.cloud.quota_cores
                                  - self.region.cloud.provisioned)
                    granted = (np.cumsum(cloud_cores)
                               <= quota_left + 1e-9) if len(cloud_pos) else \
                        np.zeros(0, bool)
                    broke = bool(len(cloud_pos)) and not granted.all()
                    if broke:
                        # the first cloud failure aborts the wave: nothing
                        # after that SE (burst-eligible or not) is processed
                        j = int(cloud_pos[int(np.argmin(granted))])
                        rep.notes.append(
                            f"cloud quota exhausted at {fs.names[wave[j]]}")
                        wave, cores, taken = wave[:j], cores[:j], taken[:j]
                        cloud_pos = np.flatnonzero(~taken)
                    count = len(wave)
                    # burst restores are immediate
                    pool.used += float(cores[taken].sum())
                    activate(wave[taken], PLACEMENT_BURST)
                    # cloud restores wait for provisioning
                    if len(cloud_pos):
                        base = max(self.loop.now, self._cloud_ready_at)
                        items = wave[cloud_pos]
                        for i in items:
                            dt = self.region.cloud.provision_time(
                                spec_cores[i])
                            self.region.cloud.provision(spec_cores[i])
                            base += dt
                            rep.cloud_provision_s += dt
                        self._cloud_ready_at = base
                        self._pending_cloud += 1

                        def arrive(items=items):
                            activate(items, PLACEMENT_CLOUD)
                            self._pending_cloud -= 1
                            self._snap()
                            if self._pending_cloud == 0 and \
                                    self._rl_waves_done:
                                finalize_rl()
                        self.loop.schedule(base - self.loop.now, arrive,
                                           "cloud-provision")
                    self._snap()
                    nxt = start + count
                    if nxt < len(rls) and count > 0:
                        self.loop.schedule(self.RL_RESTORE_WAVE_S,
                                           restore_batch(nxt),
                                           "rl-restore-wave")
                    else:
                        self._rl_waves_done = True
                        if self._pending_cloud == 0:
                            finalize_rl()
                return w
            self.loop.schedule(self.RL_RESTORE_WAVE_S, restore_batch(0),
                               "rl-restore-wave")

        self.loop.run()
        self._snap()
        return rep

    # ------------------------------------------------------------------
    def failback(self) -> None:
        """Operator-triggered recovery (paper §4.7 / Fig 6)."""
        fs = self.fs
        self._state = "failback"
        self.loop.log("failback start")

        def move_back():
            away = ((fs.placement == PLACEMENT_BURST)
                    | (fs.placement == PLACEMENT_CLOUD))
            cores = fs.spec_cores
            for group, pool, code in (
                    (away & fs.preemptible, self.region.steady.overcommit,
                     POOL_OVERCOMMIT),
                    (away & ~fs.preemptible, self.region.steady.stateless,
                     POOL_STATELESS)):
                idx = np.flatnonzero(group)
                taken = _first_fit(cores[idx], pool.free)
                pool.used += float(cores[idx[taken]].sum())
                fs.pool[idx[taken]] = code
                fs.pool[idx[~taken]] = POOL_NONE
            fs.placement[away] = PLACEMENT_STEADY
            fs.replicas_live[away] = fs.replicas[away]
            ao_mask = fs.fclass == AO
            fs.replicas_live[ao_mask] = fs.replicas[ao_mask]  # shrink to 1x
            self._snap()

        def reenable_terminate():
            mask = (fs.fclass == TM) & (fs.placement == PLACEMENT_DOWN)
            fs.placement[mask] = PLACEMENT_STEADY
            fs.replicas_live[mask] = fs.replicas[mask]
            fs.traffic_enabled[mask] = True
            idx = np.flatnonzero(mask)
            cores = fs.cores_live
            taken = _first_fit(cores[idx], self.region.steady.overcommit.free)
            self.region.steady.overcommit.used += float(cores[idx[taken]].sum())
            fs.pool[idx[taken]] = POOL_OVERCOMMIT
            fs.pool[idx[~taken]] = POOL_NONE
            self._snap()

        def release_resources():
            # wait until 40% of batch capacity is freed before batch resumes
            self.region.batch.release()
            self.region.cloud.release_all()
            fs.locked[:] = False
            self._state = "steady"
            self.loop.log("failback complete; locks released")
            self._snap()

        self.loop.schedule(self.CITY_WAVE_S * 4, move_back, "traffic-back")
        self.loop.schedule(self.CITY_WAVE_S * 6, reenable_terminate,
                           "reenable-terminate")
        self.loop.schedule(self.CITY_WAVE_S * 10, release_resources,
                           "release-resources")
        self.loop.run()
