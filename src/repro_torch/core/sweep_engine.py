"""Fused sweep engine: full-peak scenario ensembles on one CUDA card.

Port of ``repro/core/sweep_engine.py`` (hard path, one device).  For
every scenario of a grid, on the device and with no host round trip
between stages:

  * the dependency stage: the unique dark sets of the grid (blackhole
    draws keyed on ``evict_fraction`` plus the cascade-storm draws, see
    ``graph.propagation.combined_dark_uniques``) are propagated to their
    fixed point once, by the ELL round kernel, and every scenario gathers
    its broken-critical fraction and counts by index;
  * the closed-form analytic model (``scenarios.scenario_outcome``);
  * the 240-step timeline: the ``(S, T)`` series in closed form and the
    carry through the verdict-reduction kernel
    (``timeline_sim.timeline_verdicts_batch``).

The scenario axis is bucket-padded to ``(n_chunks, width)`` (powers of
two, padded with the last scenario) and the chunks run in turn, so a
chunk's ``(width, T, R)`` working set stays bounded at any grid size.
Against the reference's scan path, booleans and counts are exact and
floats float32-tight (``t_availability_mean`` is a reordered sum; other
floats can differ in the last bit where the reference's CPU program
fuses a multiply-add).  The card's run and the port's CPU run differ
only in ``t_availability_mean``.

Not ported yet: ``soft_tau`` (ROADMAP Queue A item 5), multi-device
sharding, and ``compiled_variants``: the port compiles no program per
shape, so it sets neither ``ufa_sweep_compiled_variants`` nor
``ufa_sweep_compile_misses_total``.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.scenarios import (FleetAggregates, analytic_consts,
                                        scenario_grid, scenario_outcome,
                                        stage_seed)
from repro_torch.core.timeline_sim import (PARAM_KEYS, TimelineConfig,
                                           default_scenario, default_ts,
                                           timeline_verdicts_batch,
                                           validate_grid)
from repro_torch.kernels.backend import resolve_device

# mega-batch width: the (width, T, R) working set of one chunk stays well
# inside device memory while filling the card
CHUNK = 4096
# smallest padded width — tiny interactive grids don't pay for a full
# 4096-wide chunk
MIN_BUCKET = 256


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def bucket_shape(n: int, chunk: int = CHUNK) -> tuple[int, int]:
    """Padded ``(n_chunks, width)`` for an ``n``-scenario grid: width is a
    power of two in [MIN_BUCKET, chunk], the chunk count a power of two."""
    if n <= chunk:
        return 1, max(MIN_BUCKET, _pow2_ceil(n))
    return _pow2_ceil(-(-n // chunk)), chunk


class SweepEngine:
    """One fleet's fused sweep pipeline: constants uploaded once, then
    ``run`` executes arbitrary scenario grids end to end on the device.

    Parameters
      agg       class-level fleet aggregates (the analytic model's input)
      timeline  ``TimelineConfig`` (from ``Orchestrator.timeline_config()``
                or ``config_for_fleet``)
      graph     optional ``CallGraph`` — enables the in-pipeline
                dependency stage (per-scenario blackholes keyed on
                ``evict_fraction``, shared draws under ``seed``)
      ts        time grid for the timeline (default 2h / 240 steps)
      chunk     mega-batch width (power of two; default ``CHUNK``)
      device    where the pipeline runs (default: the CUDA card; raises
                when there is none)
      analytic_extra  optional kwargs dict forwarded to
                ``analytic_consts`` (``ao_buffer`` / ``spawn_mult``)
    """

    def __init__(self, agg: FleetAggregates, timeline: TimelineConfig, *,
                 graph=None, seed: int = 0,
                 ts: Optional[np.ndarray] = None,
                 chunk: int = CHUNK,
                 device=None,
                 analytic_extra: Optional[Dict] = None):
        self.device = resolve_device(device)
        self.consts = {"a": analytic_consts(agg, device=self.device,
                                            **(analytic_extra or {})),
                       "t": timeline.as_consts(self.device)}
        self._preheat = timeline.preheat_s
        self.ts = np.asarray(default_ts() if ts is None else ts, np.float64)
        self._ts_dev = torch.from_numpy(
            self.ts.astype(np.float32)).to(self.device)
        self.chunk = int(chunk)
        self.graph = graph
        self.seed = seed
        if graph is not None:
            from repro_torch.graph.propagation import dep_consts
            self.dep = dep_consts(graph, self.device)
            # the cascade-storm stage draws from a stream independent of
            # the blackhole draws, derived from the one engine seed
            self.storm_seed = stage_seed(seed, "storm")

    # ------------------------------------------------------------------
    def _params(self, grid: Dict[str, np.ndarray], n: int, shape) -> Dict:
        """Bucket-pad + chunk the scenario axes to float32 ``shape``
        tensors on the device (missing axes filled with the
        operating-point defaults)."""
        defaults = default_scenario(burst_delay_s=self._preheat)
        out = {}
        for k in PARAM_KEYS:
            if k in ("dep_broken_frac", "storm_broken_frac"):
                continue                    # computed stages, not axes
            col = (np.asarray(grid[k], np.float32) if k in grid
                   else np.full(n, defaults[k], np.float32))
            out[k] = self._upload(self._chunked(col, shape))
        return out

    def _chunked(self, col: np.ndarray, shape) -> np.ndarray:
        """(n,) -> (n_chunks, width), padding with the last scenario."""
        pad = shape[0] * shape[1] - len(col)
        if pad:
            col = np.concatenate([col, np.repeat(col[-1:], pad, axis=0)])
        return col.reshape(shape)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _block(self, p: Dict[str, torch.Tensor], temporal: bool) -> Dict:
        """One chunk: the analytic verdicts plus (``temporal``) the
        ``t_``-prefixed timeline verdicts."""
        out = dict(scenario_outcome(self.consts["a"], p))
        if temporal:
            tsum = timeline_verdicts_batch(self.consts["t"], p, self._ts_dev)
            out.update({f"t_{k}": v for k, v in tsum.items()})
        return out

    # ------------------------------------------------------------------
    def dep_fractions(self, fractions: np.ndarray
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-scenario dependency verdicts as host arrays — the composed
        path the equivalence tests pit against the in-pipeline stage:
        (broken_critical_frac f32, n_broken_critical i32, n_dark i32)."""
        from repro_torch.graph.propagation import (broken_critical_fractions,
                                                   shared_blackhole_draws)
        dark_u, inv = shared_blackhole_draws(self.graph, fractions,
                                             seed=self.seed)
        counts, frac, n_dark = broken_critical_fractions(
            self._upload(dark_u), self.dep)
        return (frac.cpu().numpy()[inv], counts.cpu().numpy()[inv],
                n_dark.cpu().numpy()[inv])

    def storm_fractions(self, refracs: np.ndarray) -> np.ndarray:
        """Per-scenario STORM-stage broken-critical fractions as a host
        array (same derived ``storm_seed`` stream, same kernel)."""
        from repro_torch.graph.propagation import (broken_critical_fractions,
                                                   shared_blackhole_draws)
        dark_u, inv = shared_blackhole_draws(self.graph,
                                             np.asarray(refracs, np.float64),
                                             seed=self.storm_seed)
        _, frac, _ = broken_critical_fractions(self._upload(dark_u),
                                               self.dep)
        return frac.cpu().numpy()[inv]

    # ------------------------------------------------------------------
    def run(self, grid: Optional[Dict[str, np.ndarray]] = None,
            dep_broken_frac: Optional[np.ndarray] = None,
            temporal: bool = True,
            soft_tau: Optional[float] = None) -> Dict[str, np.ndarray]:
        """Evaluate every scenario in ``grid`` through the fused pipeline;
        returns the analytic verdicts, the ``t_``-prefixed temporal
        verdicts (unless ``temporal=False``), the grid axes, and — when
        the engine has a graph and no explicit ``dep_broken_frac`` — the
        ``dep_n_broken_critical`` / ``dep_n_dark`` propagation verdicts.
        The grid is validated up front (``timeline_sim.validate_grid``)."""
        if soft_tau is not None:
            raise NotImplementedError(
                "soft_tau: the soft relaxation is not ported yet "
                "(ROADMAP Queue A item 5)")
        grid = scenario_grid() if grid is None else grid
        n = validate_grid(grid)
        shape = bucket_shape(n, self.chunk)
        meter = obs.enabled()
        if meter:
            t0 = time.perf_counter()
        params = self._params(grid, n, shape)
        use_dep = self.graph is not None and dep_broken_frac is None

        if use_dep:
            from repro_torch.graph.propagation import (
                broken_critical_fractions, combined_dark_uniques)
            fractions = (np.asarray(grid["evict_fraction"])
                         if "evict_fraction" in grid else np.ones(n))
            storm_fr = (np.asarray(grid["storm_refrac"])
                        if "storm_refrac" in grid else None)
            dark_u, inv, storm_inv = combined_dark_uniques(
                self.graph, fractions, storm_fr,
                seed=self.seed, storm_seed=self.storm_seed)
            counts, frac, n_dark = broken_critical_fractions(
                self._upload(dark_u), self.dep)
            inv = self._upload(self._chunked(inv, shape)).long()
            storm_inv = self._upload(self._chunked(storm_inv, shape)).long()
        else:
            dfrac = (np.zeros(n, np.float32) if dep_broken_frac is None
                     else np.asarray(dep_broken_frac, np.float32))
            params["dep_broken_frac"] = self._upload(
                self._chunked(dfrac, shape))
            sfrac = (np.asarray(grid["storm_broken_frac"], np.float32)
                     if "storm_broken_frac" in grid
                     else np.zeros(n, np.float32))
            params["storm_broken_frac"] = self._upload(
                self._chunked(sfrac, shape))

        chunks = []
        for i in range(shape[0]):
            p = {k: v[i] for k, v in params.items()}
            if use_dep:
                p["dep_broken_frac"] = frac[inv[i]]
                p["storm_broken_frac"] = frac[storm_inv[i]]
            out = self._block(p, temporal)
            if use_dep:
                out["dep_n_broken_critical"] = counts[inv[i]]
                out["dep_n_dark"] = n_dark[inv[i]]
            chunks.append(out)

        result = {k: torch.cat([c[k] for c in chunks]).cpu().numpy()[:n]
                  for k in chunks[0]}
        result.update({k: np.asarray(v) for k, v in grid.items()})
        if meter:
            dt = time.perf_counter() - t0
            obs.inc("ufa_sweep_runs_total")
            obs.inc("ufa_sweep_scenarios_total", n)
            if dt > 0:
                obs.set_gauge("ufa_sweep_scenarios_per_s", n / dt)
            obs.observe("ufa_sweep_run_seconds", dt)
            padded = shape[0] * shape[1]
            obs.set_gauge("ufa_sweep_padding_waste_ratio",
                          (padded - n) / padded)
        return result


def fused_sweep(fs, grid: Optional[Dict[str, np.ndarray]] = None, *,
                with_graph: bool = True, seed: int = 0, region=None,
                ts: Optional[np.ndarray] = None, temporal: bool = True,
                chunk: int = CHUNK, device=None) -> Dict[str, np.ndarray]:
    """Convenience one-shot: build the engine for a fleet (``FleetState``
    or dict of ``ServiceSpec``) and run a grid through the full fused
    pipeline (dependency stage included when the fleet has edges and
    ``with_graph``)."""
    from repro_torch.core.timeline_sim import config_for_fleet
    agg = (FleetAggregates.from_fleet_state(fs) if hasattr(fs, "fclass")
           else FleetAggregates.from_fleet(fs))
    graph = None
    if with_graph and hasattr(fs, "fclass"):
        from repro_torch.graph import CallGraph
        graph = CallGraph.from_fleet_state(fs)
    timeline = config_for_fleet(fs, region=region)
    eng = SweepEngine(agg, timeline, graph=graph, seed=seed, ts=ts,
                      chunk=chunk, device=device)
    return eng.run(grid, temporal=temporal)


def tile_grid(grid: Dict[str, np.ndarray], n: int) -> Dict[str, np.ndarray]:
    """Tile a scenario grid out to ``n`` rows (cycling the base grid)."""
    return {k: np.resize(np.asarray(v), n) for k, v in grid.items()}
