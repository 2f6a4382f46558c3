"""Differentiable capacity optimizer over the fused sweep engine.

Port of ``repro/optim/capacity.py``.  The paper's provisioning knobs —
the Always-On buffer fraction, the tier-to-failure-class mix, the 1.5x
overcommit factor, the batch->burst conversion ramp, and the eviction
order — are searched to *minimize provisioned cores subject to the
99.97 % SLA across a scenario ensemble*, with the fused sweep engine
(``repro_torch.core.sweep_engine``) as the constraint oracle.

Two search modes, sharing one design parameterization:

  * ``mode="grad"`` — ``torch.autograd`` straight through the
    soft-relaxed fused pipeline (``soft_tau``: every hard verdict becomes
    a sigmoid of its signed margin, see ``timeline_sim.soft_ge``), AdamW
    (``optim.adamw``) on the knob logits with a temperature schedule
    annealing the relaxation down to the exact model.
  * ``mode="cem"`` — a cross-entropy loop over the *hard* objective:
    every generation evaluates the whole population x ensemble as one
    ``(population x padded scenarios)`` slab, each candidate's constants
    broadcast to its rows, in chunks of the engine's width — the timeline
    carry through ``timeline_reduce`` (the CUDA kernel on the card), one
    launch a chunk.  Padding rows repeat the last scenario and a mask
    keeps them out of the score, as in the reference.

``mode="both"`` (default) anneals gradients first, then lets CEM polish.
The optimum is re-verified through the REAL hard pipeline
(``verify_design`` builds a ``TimelineConfig``/``FleetAggregates`` from
the optimized design and runs an actual ``SweepEngine``), and
``hardening_weights`` turns the availability gradient at a design into
per-service blast-radius weights for
``graph.planner.plan_hardening(service_weights=...)``.

Design knobs (unconstrained logits, sigmoid-squashed into bounds):

  buffer     Always-On buffer fraction b in [0.02, 1.5].
  promote    three flows TM->RL, RL->AM, AM->AO in [0, 1].
  overcommit host overcommit factor in [1, O_max].
  ramp       burst-conversion spawn-rate multiplier in [0.4, 2.2].
  evict      eviction-order shift lambda in [-1, 1].

Entry points take ``device=`` (default: the CUDA card).  Random draws
(the CEM populations) come from a ``torch.Generator`` on the host, so a
seed gives the same populations on every device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import capacity as C
from repro_torch.core.fleet_state import AM, AO, RL, TM, FleetState
from repro_torch.core.omg import Orchestrator
from repro_torch.core.scenarios import FleetAggregates, _div, scenario_grid
from repro_torch.core.sweep_engine import (CHUNK, SweepEngine,
                                           _fused_verdicts_block,
                                           bucket_shape)
from repro_torch.core.tiers import o_max
from repro_torch.core.timeline_sim import (N_CLASSES, N_TIERS, PARAM_KEYS,
                                           TimelineConfig, default_scenario,
                                           default_ts)
from repro_torch.kernels.backend import resolve_device
from repro_torch.optim.adamw import make_optimizer

F32 = torch.float32
_SLACK = C.DEFAULT_SLACK
_TL_DEFAULTS = {f.name: f.default for f in dataclasses.fields(TimelineConfig)
                if f.default is not dataclasses.MISSING}

# knob bounds (sigmoid-squashed)
BUFFER_LO, BUFFER_HI = 0.02, 1.5
RAMP_LO, RAMP_HI = 0.4, 2.2
O_MAX = float(o_max())


# ---------------------------------------------------------------------------
# Design base + knob parameterization
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DesignBase:
    """The fleet's classified tolerance frontier — the fixed point the
    knobs deform: class core/env totals + the per-tier class matrix."""
    ao: float
    am: float
    rl: float
    tm: float
    am_envs: float
    rl_envs: float
    tm_envs: float
    tier_class: np.ndarray          # (N_TIERS, N_CLASSES) spec cores

    @property
    def total(self) -> float:
        return self.ao + self.am + self.rl + self.tm

    @classmethod
    def from_fleet_state(cls, fs: FleetState) -> "DesignBase":
        cores = fs.spec_cores
        tier_class = np.zeros((N_TIERS, N_CLASSES), np.float64)
        for t in range(N_TIERS):
            tmask = fs.tier == t
            for c in range(N_CLASSES):
                tier_class[t, c] = float(cores[tmask & (fs.fclass == c)].sum())
        return cls(
            ao=float(cores[fs.fclass == AO].sum()),
            am=float(cores[fs.fclass == AM].sum()),
            rl=float(cores[fs.fclass == RL].sum()),
            tm=float(cores[fs.fclass == TM].sum()),
            am_envs=float(np.count_nonzero(fs.fclass == AM)),
            rl_envs=float(np.count_nonzero(fs.fclass == RL)),
            tm_envs=float(np.count_nonzero(fs.fclass == TM)),
            tier_class=tier_class)

    def as_arrays(self, device=None) -> Dict[str, torch.Tensor]:
        """float32 tensors on ``device`` (default: the CUDA card)."""
        dev = resolve_device(device)
        f = lambda v: torch.tensor(np.asarray(v, np.float32), device=dev)
        return {"ao": f(self.ao), "am": f(self.am), "rl": f(self.rl),
                "tm": f(self.tm), "am_envs": f(self.am_envs),
                "rl_envs": f(self.rl_envs), "tm_envs": f(self.tm_envs),
                "tier_class": f(self.tier_class), "total": f(self.total)}


def _logit(u: float) -> float:
    u = min(max(float(u), 1e-6), 1.0 - 1e-6)
    return math.log(u / (1.0 - u))


def _box_logit(v: float, lo: float, hi: float) -> float:
    return _logit((float(v) - lo) / (hi - lo))


def make_knobs(buffer: float = 1.0, promote=(0.9, 0.9, 0.9),
               overcommit: float = 1.5, ramp: float = 1.0,
               evict_lambda: float = 0.0,
               device=None) -> Dict[str, torch.Tensor]:
    """Knob logits whose squashed values hit the given design point, as
    float32 tensors on ``device`` (default: the CUDA card)."""
    dev = resolve_device(device)
    f = lambda v: torch.tensor(np.asarray(v, np.float32), device=dev)
    return {
        "buffer": f(_box_logit(buffer, BUFFER_LO, BUFFER_HI)),
        "promote": f([_logit(u) for u in promote]),
        "overcommit": f(_box_logit(overcommit, 1.0, O_MAX)),
        "ramp": f(_box_logit(ramp, RAMP_LO, RAMP_HI)),
        "evict": f(_logit(0.5 * (evict_lambda + 1.0))),
    }


def legacy_knobs(device=None) -> Dict[str, torch.Tensor]:
    """The pre-UFA start point: full 2x buffer, (nearly) everything
    promoted to Always-On — ~2.12x provisioned (Fig. 11's 'before')."""
    return make_knobs(buffer=1.0, promote=(0.9, 0.9, 0.9), overcommit=1.5,
                      ramp=1.0, evict_lambda=0.0, device=device)


def ufa_knobs(device=None) -> Dict[str, torch.Tensor]:
    """The paper's hand-tuned operating point (no promotion, 2x AO
    buffer, 1.5x overcommit, stock ramp, pro-rata eviction)."""
    return make_knobs(buffer=1.0, promote=(1e-4, 1e-4, 1e-4),
                      overcommit=1.5, ramp=1.0, evict_lambda=0.0,
                      device=device)


def knob_design(base: Dict[str, torch.Tensor],
                knobs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Squash knob logits into a concrete *design*: deformed class
    totals/envs/tier matrix plus the scalar sizing knobs.  Differentiable
    end to end (every op is smooth in the logits)."""
    sig = torch.sigmoid
    b = BUFFER_LO + (BUFFER_HI - BUFFER_LO) * sig(knobs["buffer"])
    u = sig(knobs["promote"])                      # (3,) TM->RL, RL->AM,
    oc = 1.0 + (O_MAX - 1.0) * sig(knobs["overcommit"])   # AM->AO flows
    ramp = RAMP_LO + (RAMP_HI - RAMP_LO) * sig(knobs["ramp"])
    lam = 2.0 * sig(knobs["evict"]) - 1.0

    # class flows (cores conserved: each stage moves a fraction one
    # class "up" the tolerance ladder)
    tm = base["tm"] * (1.0 - u[0])
    rl_mid = base["rl"] + base["tm"] * u[0]
    rl = rl_mid * (1.0 - u[1])
    am_mid = base["am"] + rl_mid * u[1]
    am = am_mid * (1.0 - u[2])
    ao = base["ao"] + am_mid * u[2]
    # envs ride the same flows (AO envs are not a kernel input)
    tm_envs = base["tm_envs"] * (1.0 - u[0])
    rl_envs_mid = base["rl_envs"] + base["tm_envs"] * u[0]
    rl_envs = rl_envs_mid * (1.0 - u[1])
    am_envs_mid = base["am_envs"] + rl_envs_mid * u[1]
    am_envs = am_envs_mid * (1.0 - u[2])
    # per-tier class matrix, same flows per row
    tc = base["tier_class"]
    tc_tm = tc[:, TM] * (1.0 - u[0])
    tc_rl_mid = tc[:, RL] + tc[:, TM] * u[0]
    tc_rl = tc_rl_mid * (1.0 - u[1])
    tc_am_mid = tc[:, AM] + tc_rl_mid * u[1]
    tc_am = tc_am_mid * (1.0 - u[2])
    tc_ao = tc[:, AO] + tc_am_mid * u[2]
    cols = [None] * N_CLASSES
    cols[AO], cols[AM], cols[RL], cols[TM] = tc_ao, tc_am, tc_rl, tc_tm
    tier_class = torch.stack(cols, dim=1)

    stateless = ((1.0 + b) * ao + am) * _SLACK
    return {"ao": ao, "am": am, "rl": rl, "tm": tm,
            "am_envs": am_envs, "rl_envs": rl_envs, "tm_envs": tm_envs,
            "tier_class": tier_class, "buffer": 1.0 + b,
            "overcommit": oc, "spawn_mult": ramp, "evict_lambda": lam,
            "stateless": stateless, "total": base["total"]}


def design_consts(design: Dict[str, torch.Tensor]) -> Dict[str, Dict]:
    """The fused pipeline's ``{"a": ..., "t": ...}`` consts from a
    design — the differentiable mirror of ``analytic_consts`` +
    ``RegionCapacity.for_fleet`` + ``extract_timeline_config``, with the
    host/placement ceils dropped (so gradients flow through sizing)."""
    ao, am, rl, tm = (design[k] for k in ("ao", "am", "rl", "tm"))
    stateless = design["stateless"]
    oc_cap = stateless * (design["overcommit"] - 1.0)
    preempt = rl + tm
    oc_preempt = torch.minimum(preempt, oc_cap)
    sl_preempt = preempt - oc_preempt
    batch_cores = _div((am + rl) * C.BATCH_BURST_HEADROOM,
                       C.BATCH_PREEMPTIBLE_FRACTION)
    spawn_rate = (Orchestrator.SPAWN_CORES_PER_HOST_S
                  / C.BATCH_CORES_PER_HOST * batch_cores
                  * design["spawn_mult"])
    f = lambda v: v.to(F32)
    t = {"ao": f(ao), "am": f(am), "rl": f(rl), "tm": f(tm),
         "am_envs": f(design["am_envs"]), "rl_envs": f(design["rl_envs"]),
         "tm_envs": f(design["tm_envs"]),
         "tier_class": f(design["tier_class"]),
         "stateless_cap": f(stateless), "overcommit_cap": f(oc_cap),
         "steady_used0": f(ao + am + sl_preempt),
         "overcommit_used0": f(oc_preempt),
         "oc_preempt_cores": f(oc_preempt), "sl_preempt_cores": f(sl_preempt),
         "am_stateless_cores": f(am),
         "burst_cap_full": f(batch_cores * C.BATCH_PREEMPTIBLE_FRACTION),
         "spawn_rate": f(spawn_rate),
         "cloud_quota": f(C.default_cloud_quota(rl)),
         "cloud_rate": f(torch.clamp(_div(rl, C.CLOUD_RATE_RL_DIVISOR),
                                     min=C.CLOUD_RATE_FLOOR)),
         "phys_cores": f(stateless)}
    t.update({k: torch.full_like(ao, v, dtype=F32)
              for k, v in _TL_DEFAULTS.items()})
    a = {"ao": f(ao), "am": f(am), "rl": f(rl), "tm": f(tm),
         "am_envs": f(design["am_envs"]), "rl_envs": f(design["rl_envs"]),
         "ao_buffer": f(design["buffer"]),
         "spawn_mult": f(design["spawn_mult"])}
    return {"a": a, "t": t}


def eviction_deltas(design: Dict[str, torch.Tensor], evict_fraction):
    """Budget-conserving per-class eviction shifts from the order knob.

    lambda > 0 evicts MORE of RL (and less of TM), lambda < 0 the
    reverse; the bounds keep both per-class evicted fractions in [0, 1]
    and ``rl*d_rl + tm*d_tm == 0``.  lambda = 0 is d = 0: the pro-rata
    base model, exactly."""
    e = evict_fraction
    rl = torch.clamp(design["rl"], min=1.0)
    tm = torch.clamp(design["tm"], min=1.0)
    lam = design["evict_lambda"]
    m_pos = torch.minimum(1.0 - e, e * tm / rl)     # room to evict RL more
    m_neg = torch.minimum(e, (1.0 - e) * tm / rl)   # room to evict RL less
    d_rl = lam * torch.where(lam >= 0.0, m_pos, m_neg)
    d_tm = -(rl / tm) * d_rl
    return d_rl, d_tm


# ---------------------------------------------------------------------------
# Ensembles + the soft objective
# ---------------------------------------------------------------------------


def certification_grid() -> Dict[str, np.ndarray]:
    """The optimizer's constraint ensemble: 48 scenarios around the
    paper's operating point (traffic x preheat x burst availability x
    cloud quota x eviction depth) that the hand-tuned UFA design passes."""
    return scenario_grid(traffic_mult=(1.8, 2.0, 2.2),
                         burst_delay_s=(270.0, 360.0),
                         burst_availability=(1.0, 0.85),
                         cloud_quota_frac=(1.0, 0.5),
                         evict_fraction=(1.0, 0.7))


def _grid_cols(grid: Dict[str, np.ndarray],
               device=None) -> Dict[str, torch.Tensor]:
    """Default-filled (n,) float32 columns for every scenario param on
    ``device`` (the un-chunked analogue of ``SweepEngine._params``)."""
    dev = resolve_device(device)
    n = len(next(iter(grid.values())))
    defaults = default_scenario()
    return {k: torch.from_numpy(
        np.asarray(grid[k], np.float32) if k in grid
        else np.full(n, defaults[k], np.float32)).to(dev)
        for k in PARAM_KEYS}


def _design_params(design: Dict[str, torch.Tensor],
                   cols: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fold the design into the scenario params: the overcommit factor
    is a design choice (not a scenario axis), and the eviction-order
    deltas depend on each scenario's eviction depth."""
    d_rl, d_tm = eviction_deltas(design, cols["evict_fraction"])
    return dict(cols,
                overcommit_factor=cols["overcommit_factor"] * 0.0
                + design["overcommit"],
                rl_evict_delta=d_rl, tm_evict_delta=d_tm)


def soft_loss(knobs, base, cols, ts, tau, penalty):
    """Provisioning multiple + SLA-violation penalty, soft-relaxed at
    temperature ``tau`` (a float32 tensor) — the gradient objective.
    ``sla_ok`` / ``t_sla_ok`` are sigmoid products in [0, 1]."""
    design = knob_design(base, knobs)
    consts = design_consts(design)
    params = _design_params(design, cols)
    out = _fused_verdicts_block(consts, params, ts, True, tau)
    mult = design["stateless"] / base["total"]
    bad = ((1.0 - torch.mean(out["sla_ok"]))
           + (1.0 - torch.mean(out["t_sla_ok"])))
    return mult + penalty * bad


def _soft_loss_grad(knobs, base, cols, ts, tau, penalty):
    """``(soft_loss, its gradient)`` in the knobs through
    ``torch.autograd``, as detached tensors (the gradient a dict like
    ``knobs``)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in knobs.items()}
    loss = soft_loss(leaves, base, cols, ts, tau, penalty)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def provisioning(design) -> float:
    """Provisioned-to-needed multiple of a design (phys / steady demand,
    the ``provisioning_multiple`` convention: legacy ~2.12x, UFA <~1x)."""
    return float(design["stateless"]) / float(design["total"])


# ---------------------------------------------------------------------------
# Gradient mode
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CapacityOptResult:
    knobs: Dict[str, np.ndarray]       # optimized knob logits (host)
    design: Dict[str, object]          # concrete design (host floats)
    provisioning_multiple: float
    start_multiple: float
    history: List[Dict[str, float]]
    verification: Optional[Dict[str, object]] = None

    @property
    def improved(self) -> bool:
        return self.provisioning_multiple < self.start_multiple


def _host_design(design) -> Dict[str, object]:
    return {k: (v.detach().cpu().numpy().astype(np.float64) if v.dim()
                else float(v)) for k, v in design.items()}


def fit_grad(base: Dict[str, torch.Tensor], cols: Dict[str, torch.Tensor],
             knobs: Dict[str, torch.Tensor], ts,
             taus=(1.0, 0.3, 0.1, 0.03), steps_per_tau: int = 60,
             lr: float = 0.08, penalty: float = 200.0):
    """AdamW on the knob logits through the soft fused pipeline, with
    the relaxation temperature annealed toward the exact model."""
    opt = make_optimizer(lr=lr, weight_decay=0.0, max_grad_norm=10.0)
    state = opt.init(knobs)
    pen = torch.tensor(penalty, dtype=F32, device=ts.device)
    history = []
    for tau in taus:
        tau_t = torch.tensor(tau, dtype=F32, device=ts.device)
        for _ in range(steps_per_tau):
            loss, grads = _soft_loss_grad(knobs, base, cols, ts, tau_t, pen)
            knobs, state, _ = opt.update(grads, state, knobs)
        history.append({"tau": float(tau), "loss": float(loss),
                        "multiple": provisioning(knob_design(base, knobs))})
    return knobs, history


# ---------------------------------------------------------------------------
# CEM mode (hard objective, one slab a generation)
# ---------------------------------------------------------------------------

_KNOB_KEYS = ("buffer", "promote", "overcommit", "ramp", "evict")


def _flatten_knobs(knobs) -> torch.Tensor:
    return torch.cat([torch.atleast_1d(knobs[k]) for k in _KNOB_KEYS])


def _unflatten_knobs(flat) -> Dict[str, torch.Tensor]:
    return {"buffer": flat[0], "promote": flat[1:4], "overcommit": flat[4],
            "ramp": flat[5], "evict": flat[6]}


def _rows(tree, idx: torch.Tensor):
    """Gather a (nested) dict of per-candidate tensors to per-row ones."""
    if isinstance(tree, dict):
        return {k: _rows(v, idx) for k, v in tree.items()}
    return tree[idx]


def _cem_scores(flat_pop, base, pchunks, mask, ts, penalty):
    """Hard objective for a whole CEM generation: every (candidate,
    scenario) pair of the bucket-padded ensemble as one slab of
    ``population x n_chunks x width`` rows, each candidate's design
    constants gathered to its rows, run in chunks of the engine's width
    through ``_fused_verdicts_block`` (the timeline carry through
    ``timeline_reduce``, one launch a chunk).  Infeasibility is charged
    per failing, unmasked scenario (``sla_ok & t_sla_ok``, the exact hard
    verdicts)."""
    with torch.no_grad():
        P = flat_pop.shape[0]
        n = torch.clamp(mask.sum(), min=1.0)
        designs = torch.func.vmap(
            lambda f: knob_design(base, _unflatten_knobs(f)))(flat_pop)
        consts = torch.func.vmap(design_consts)(designs)
        per = mask.numel()
        rows = P * per
        cand = torch.arange(P, device=flat_pop.device).repeat_interleave(per)
        scen = {k: v.reshape(-1).repeat(P) for k, v in pchunks.items()}
        weight = mask.reshape(-1).repeat(P)
        fails = torch.empty(rows, dtype=F32, device=flat_pop.device)
        for lo in range(0, rows, CHUNK):
            idx = cand[lo:lo + CHUNK]
            design = _rows(designs, idx)
            p = _design_params(design, {k: v[lo:lo + CHUNK]
                                        for k, v in scen.items()})
            out = _fused_verdicts_block(_rows(consts, idx), p, ts, True)
            ok = out["sla_ok"] & out["t_sla_ok"]
            fails[lo:lo + CHUNK] = (1.0 - ok.to(F32)) * weight[lo:lo + CHUNK]
        fails = fails.reshape(P, per).sum(dim=1)
        return designs["stateless"] / base["total"] + penalty * fails / n


def fit_cem(base: Dict[str, torch.Tensor], grid: Dict[str, np.ndarray],
            knobs: Dict[str, torch.Tensor], ts,
            generations: int = 12, population: int = 48,
            elite: int = 12, sigma0: float = 1.0, seed: int = 0,
            penalty: float = 10.0):
    """Cross-entropy refinement around a start point: sample knob-logit
    populations (a host ``torch.Generator`` seeded with ``seed``), score
    each generation through the hard fused pipeline (one slab), refit the
    sampling Gaussian to the elites.  The incumbent rides along in every
    generation (elitism), so the result never regresses below its
    start."""
    dev = ts.device
    n = len(next(iter(grid.values())))
    shape = bucket_shape(n)
    cols = _grid_cols(grid, dev)
    total = shape[0] * shape[1]

    def chunked(col):
        col = torch.cat([col, col[-1:].repeat(total - n)])
        return col.reshape(shape)
    pchunks = {k: chunked(v) for k, v in cols.items()}
    # padding rows replicate the last scenario but must not be scored
    mask = torch.zeros(total, dtype=F32, device=dev)
    mask[:n] = 1.0
    mask = mask.reshape(shape)

    mean = _flatten_knobs(knobs).detach()
    sigma = torch.full(mean.shape, sigma0, dtype=F32, device=dev)
    best, best_score = mean, float("inf")
    pen = torch.tensor(penalty, dtype=F32, device=dev)
    history = []
    gen = torch.Generator().manual_seed(int(seed))
    for g in range(generations):
        z = torch.randn((population, mean.shape[0]), generator=gen,
                        dtype=F32).to(dev)
        pop = mean[None, :] + sigma[None, :] * z
        pop[0] = best                      # elitism: keep the incumbent
        scores = _cem_scores(pop, base, pchunks, mask, ts, pen)
        order = torch.argsort(scores, stable=True)
        top = pop[order[:elite]]
        mean = top.mean(dim=0)
        sigma = top.std(dim=0, correction=0) + 0.02  # floor keeps exploring
        if float(scores[order[0]]) < best_score:
            best, best_score = pop[order[0]], float(scores[order[0]])
        history.append({"generation": g, "best_score": best_score,
                        "multiple": provisioning(
                            knob_design(base, _unflatten_knobs(best)))})
    return _unflatten_knobs(best), history


# ---------------------------------------------------------------------------
# Hard verification + the driver
# ---------------------------------------------------------------------------


def design_timeline(design) -> tuple:
    """(TimelineConfig, FleetAggregates, analytic_extra) materialized
    from a design's host floats — inputs for a REAL ``SweepEngine``, so
    the optimum is certified by the same exact hard path the sweeps run,
    not by the relaxation that found it."""
    d = _host_design(design)
    with torch.no_grad():
        consts = design_consts({k: v.detach() for k, v in design.items()})
    t = {k: float(v) for k, v in consts["t"].items() if v.dim() == 0}
    timeline = TimelineConfig(
        ao_cores=d["ao"], am_cores=d["am"], rl_cores=d["rl"],
        tm_cores=d["tm"], am_envs=d["am_envs"], rl_envs=d["rl_envs"],
        tm_envs=d["tm_envs"],
        tier_class_cores=consts["t"]["tier_class"].cpu().numpy().astype(
            np.float64),
        stateless_cap=t["stateless_cap"], overcommit_cap=t["overcommit_cap"],
        steady_used0=t["steady_used0"],
        overcommit_used0=t["overcommit_used0"],
        oc_preempt_cores=t["oc_preempt_cores"],
        sl_preempt_cores=t["sl_preempt_cores"],
        am_stateless_cores=t["am_stateless_cores"],
        burst_cap_full=t["burst_cap_full"], spawn_rate=t["spawn_rate"],
        cloud_quota=t["cloud_quota"], cloud_rate=t["cloud_rate"],
        phys_cores=t["phys_cores"])
    agg = FleetAggregates(ao_cores=d["ao"], am_cores=d["am"],
                          rl_cores=d["rl"], tm_cores=d["tm"],
                          am_envs=d["am_envs"], rl_envs=d["rl_envs"])
    extra = {"ao_buffer": d["buffer"], "spawn_mult": d["spawn_mult"]}
    return timeline, agg, extra


def verify_design(design, grid: Optional[Dict[str, np.ndarray]] = None,
                  graph=None, seed: int = 0,
                  device=None) -> Dict[str, object]:
    """Run the optimized design through the REAL hard pipeline (a
    ``SweepEngine`` on ``device``, optionally with the dependency stage)
    over the certification ensemble; returns the pass counts +
    availability floor."""
    grid = certification_grid() if grid is None else grid
    timeline, agg, extra = design_timeline(design)
    eng = SweepEngine(agg, timeline, graph=graph, seed=seed,
                      analytic_extra=extra, device=device)
    n = len(next(iter(grid.values())))
    e = np.asarray(grid.get("evict_fraction", np.ones(n)), np.float64)
    hd = _host_design(design)
    # the deltas on the host, in float32: the same grid on every device
    d_rl, d_tm = eviction_deltas(
        {k: torch.tensor(hd[k], dtype=F32) for k in
         ("rl", "tm", "evict_lambda")}, torch.from_numpy(e.astype(np.float32)))
    run_grid = dict(grid,
                    overcommit_factor=np.full(n, hd["overcommit"]),
                    rl_evict_delta=d_rl.numpy().astype(np.float64),
                    tm_evict_delta=d_tm.numpy().astype(np.float64))
    res = eng.run(run_grid)
    ok = res["sla_ok"] & res["t_sla_ok"]
    return {"n_scenarios": int(n),
            "n_sla_ok": int(res["sla_ok"].sum()),
            "n_t_sla_ok": int(res["t_sla_ok"].sum()),
            "n_t_avail_ok": int(res["t_avail_ok"].sum()),
            "all_ok": bool(ok.all() & res["t_avail_ok"].all()),
            "availability_min": float(res["availability"].min()),
            "t_availability_mean_min": float(
                res["t_availability_mean"].min()),
            "result": res}


def optimize_capacity(fs_or_base, grid: Optional[Dict[str, np.ndarray]]
                      = None, mode: str = "both",
                      knobs0: Optional[Dict] = None,
                      grad_steps: int = 60, taus=(1.0, 0.3, 0.1, 0.03),
                      lr: float = 0.08, penalty: float = 200.0,
                      cem_generations: int = 12, cem_population: int = 48,
                      seed: int = 0, graph=None,
                      verify: bool = True, device=None) -> CapacityOptResult:
    """End-to-end capacity optimization on ``device`` (default: the CUDA
    card): start from the legacy 2x-buffer design, minimize provisioned
    cores subject to the ensemble SLA, and certify the optimum through
    the real hard pipeline."""
    assert mode in ("grad", "cem", "both"), mode
    dev = resolve_device(device)
    base_obj = (fs_or_base if isinstance(fs_or_base, DesignBase)
                else DesignBase.from_fleet_state(fs_or_base))
    base = base_obj.as_arrays(dev)
    grid = certification_grid() if grid is None else grid
    cols = _grid_cols(grid, dev)
    ts = torch.from_numpy(default_ts().astype(np.float32)).to(dev)
    knobs = (legacy_knobs(dev) if knobs0 is None else
             {k: torch.as_tensor(v, dtype=F32).to(dev)
              for k, v in knobs0.items()})
    start_mult = provisioning(knob_design(base, knobs))
    history: List[Dict[str, float]] = []
    if mode in ("grad", "both"):
        knobs, hist = fit_grad(base, cols, knobs, ts, taus=taus,
                               steps_per_tau=grad_steps, lr=lr,
                               penalty=penalty)
        history += [dict(h, phase="grad") for h in hist]
    if mode in ("cem", "both"):
        knobs, hist = fit_cem(base, grid, knobs, ts,
                              generations=cem_generations,
                              population=cem_population, seed=seed)
        history += [dict(h, phase="cem") for h in hist]
    with torch.no_grad():
        design = knob_design(base, knobs)
    verification = (verify_design(design, grid, graph=graph, seed=seed,
                                  device=dev) if verify else None)
    return CapacityOptResult(
        knobs={k: v.detach().cpu().numpy() for k, v in knobs.items()},
        design=_host_design(design),
        provisioning_multiple=provisioning(design),
        start_multiple=start_mult,
        history=history, verification=verification)


# ---------------------------------------------------------------------------
# Feedback into the hardening planner
# ---------------------------------------------------------------------------


def hardening_weights(fs: FleetState, graph, knobs=None,
                      grid: Optional[Dict[str, np.ndarray]] = None,
                      tau: float = 1.0, device=None) -> np.ndarray:
    """Blast-radius weights from the availability gradient at a design
    point (on ``device``, default: the CUDA card): how much the soft
    ensemble SLA (availability + the sigmoid verdict products, at
    temperature ``tau``) each class's cores buy, spread over services as
    ``sens[class] * spec_cores`` and normalized so the mean over critical
    services is 1.  Feed to ``plan_hardening(service_weights=...)``."""
    dev = resolve_device(device)
    base = DesignBase.from_fleet_state(fs).as_arrays(dev)
    knobs = ufa_knobs(dev) if knobs is None else knobs
    cols = _grid_cols(certification_grid() if grid is None else grid, dev)
    ts = torch.from_numpy(default_ts().astype(np.float32)).to(dev)
    tau_t = torch.tensor(tau, dtype=F32, device=dev)

    cl4 = torch.stack([base["ao"], base["am"], base["rl"],
                       base["tm"]]).requires_grad_(True)
    b2 = dict(base, ao=cl4[0], am=cl4[1], rl=cl4[2], tm=cl4[3])
    design = knob_design(b2, knobs)
    consts = design_consts(design)
    params = _design_params(design, cols)
    out = _fused_verdicts_block(consts, params, ts, True, tau_t)
    avail = (torch.mean(out["availability"])
             + torch.mean(out["t_availability_mean"])
             + torch.mean(out["sla_ok"]) + torch.mean(out["t_sla_ok"]))
    (grad,) = torch.autograd.grad(avail, cl4)
    sens = torch.clamp(grad, min=0.0)                     # avail per core
    w = sens.cpu().numpy().astype(np.float64)[
        np.asarray(fs.fclass, np.int64)] * np.asarray(fs.spec_cores,
                                                      np.float64)
    crit = np.asarray(graph.critical, bool)
    mean_crit = float(w[crit].mean()) if crit.any() else 0.0
    if mean_crit <= 0.0:
        # gradient underflowed (margins >> tau * scale everywhere):
        # fall back to core-weighted ranking rather than all-zero
        w = np.asarray(fs.spec_cores, np.float64)
        mean_crit = float(w[crit].mean()) if crit.any() else float(w.mean())
    return (w / max(mean_crit, 1e-12)).astype(np.float32)
