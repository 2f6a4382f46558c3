"""Multi-window multi-burn-rate SLO monitoring for failover traces.

Implements the SRE-workbook alerting recipe against the paper's 99.97%
availability target: *burn rate* is the error-budget consumption speed
(``(1 - avail) / (1 - target)``), and a rule fires when the trailing
**long** window *and* a trailing **short** window both burn faster than
its threshold — fast enough to page inside a failover window, while the
short window makes the alert reset promptly once availability recovers.

Two execution paths share one definition:

  * :func:`alerts_np` — plain numpy, float64; the scalar reference and
    the host-side monitor for `Orchestrator` runs (via
    :func:`monitor_orchestrator`, which samples the event-loop timeline
    through ``core.metrics.availability_during_failover`` — a uniform
    time grid by construction).
  * :func:`sweep_alerts` — the same math in PyTorch on the device over
    the ``timeline_sim`` availability traces ``(S, T)`` that
    ``sweep_timeline(..., return_traces=True)`` produces, yielding
    per-scenario ``alert`` / ``t_first_alert`` / ``rule_first_alert`` /
    ``burn_peak`` at ensemble rates.

Window sizes are converted to whole steps host-side; rolling means use
an exact cumulative-sum formulation with partial prefixes (the first
``k-1`` samples average over what exists so far), so the monitor is
alertable from t=0.

Port of ``repro/obs/slo.py``: everything but ``sweep_alerts`` is a host
copy.  ``sweep_alerts`` computes the burn and the rolling means in
float64, as ``alerts_np`` does, and accumulates the cumulative sum one
step at a time in ``alerts_np``'s order (``np.cumsum`` adds
sequentially; ``torch.cumsum`` on the card adds in a tree): the rolling
burns are then bit for bit ``alerts_np``'s, on the CPU and the card
alike, and so are the alert verdicts, times and rules.  The
reference's jitted path works in float32, so it agrees with this one
where no rolling burn sits within float32 rounding of a threshold.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# The paper's availability target (Fig 8); error budget is 1 - target.
DEFAULT_TARGET = 0.9997


@dataclasses.dataclass(frozen=True)
class BurnRateRule:
    """One (long window, short window, burn threshold) alerting rule."""
    long_s: float     # trailing long window, seconds
    short_s: float    # trailing short window, seconds
    burn: float       # fire when both windows burn >= this rate

    @property
    def name(self) -> str:
        return f"burn{self.burn:g}x_{int(self.long_s)}s"


# SRE-workbook-shaped defaults scaled to a ~2 h failover window
# (default_ts horizon 7200 s): a fast-burn page and a faster-burn page.
DEFAULT_RULES: Tuple[BurnRateRule, ...] = (
    BurnRateRule(long_s=3600.0, short_s=300.0, burn=6.0),
    BurnRateRule(long_s=600.0, short_s=60.0, burn=14.4),
)


def _steps(window_s: float, dt: float) -> int:
    return max(1, int(round(window_s / dt)))


def rule_steps(rules: Sequence[BurnRateRule], dt: float
               ) -> Tuple[Tuple[int, int, float], ...]:
    """(long_k, short_k, burn) per rule — the static jit arguments."""
    return tuple((_steps(r.long_s, dt), _steps(r.short_s, dt), r.burn)
                 for r in rules)


# ---------------------------------------------------------------------------
# numpy reference / host-side monitor
# ---------------------------------------------------------------------------

def _rolling_mean_np(x: np.ndarray, k: int) -> np.ndarray:
    """Trailing-k mean with partial prefixes: out[i] = mean(x[max(0,i-k+1)..i])."""
    c = np.cumsum(x, dtype=np.float64)
    out = c.copy()
    out[k:] = c[k:] - c[:-k]
    denom = np.minimum(np.arange(1, len(x) + 1), k)
    return out / denom


def alerts_np(avail: np.ndarray, ts: np.ndarray,
              target: float = DEFAULT_TARGET,
              rules: Sequence[BurnRateRule] = DEFAULT_RULES
              ) -> Dict[str, np.ndarray]:
    """Scalar-reference burn-rate monitor over one availability trace.

    ``avail``: (T,) availability samples on the uniform grid ``ts``.
    Returns per-trace verdicts plus the per-step alert matrix.
    """
    avail = np.asarray(avail, dtype=np.float64)
    ts = np.asarray(ts, dtype=np.float64)
    assert avail.ndim == 1 and avail.shape == ts.shape
    dt = float(ts[1] - ts[0]) if len(ts) > 1 else 1.0
    budget = 1.0 - target
    burn = (1.0 - avail) / budget
    firing = np.zeros((len(rules), len(ts)), dtype=bool)
    burn_long_peak = np.zeros(len(rules))
    for ri, (lk, sk, thr) in enumerate(rule_steps(rules, dt)):
        b_long = _rolling_mean_np(burn, lk)
        b_short = _rolling_mean_np(burn, sk)
        firing[ri] = (b_long >= thr) & (b_short >= thr)
        burn_long_peak[ri] = b_long.max()
    any_fire = firing.any(axis=0)
    alert = bool(any_fire.any())
    if alert:
        i_first = int(np.argmax(any_fire))
        t_first = float(ts[i_first])
        rule_first = int(np.argmax(firing[:, i_first]))
    else:
        t_first, rule_first = float("inf"), -1
    return {
        "alert": np.bool_(alert),
        "t_first_alert": np.float64(t_first),
        "rule_first_alert": np.int32(rule_first),
        "burn_peak": np.float64(burn_long_peak.max()),
        "firing": firing,
    }


# ---------------------------------------------------------------------------
# ensemble monitor on the device
# ---------------------------------------------------------------------------

def _sweep_alerts_impl(avail, ts, target: float,
                       steps: Tuple[Tuple[int, int, float], ...]):
    """``avail`` (S, T) float64 and ``ts`` (T,) float32 tensors on one
    device -> the per-scenario verdicts as tensors there."""
    import torch

    S, T = avail.shape
    dev = avail.device
    # a tensor divisor: CUDA divides by a host scalar through its
    # reciprocal, which is not the quotient alerts_np computes
    budget = torch.full((), 1.0 - target, dtype=torch.float64, device=dev)
    burn = ((1.0 - avail) / budget).T.contiguous()      # (T, S)
    c = torch.empty_like(burn)
    if T:
        c[0] = burn[0]
    for i in range(1, T):                               # np.cumsum's order
        torch.add(c[i - 1], burn[i], out=c[i])
    idx = torch.arange(T, device=dev)

    def roll(k: int):
        out = c.clone()
        if k < T:
            out[k:] -= c[:T - k]
        denom = torch.clamp(idx + 1, max=k).to(torch.float64)
        return out / denom[:, None]

    firing = []
    peaks = []
    for lk, sk, thr in steps:
        b_long, b_short = roll(lk), roll(sk)
        firing.append((b_long >= thr) & (b_short >= thr))
        peaks.append(b_long.amax(dim=0))
    firing = torch.stack(firing)                        # (R, T, S)
    any_fire = firing.any(dim=0)                        # (T, S)
    alert = any_fire.any(dim=0)                         # (S,)
    i_first = torch.argmax(any_fire.to(torch.uint8), dim=0)
    t_first = torch.where(alert, ts[i_first],
                          torch.full((), float("inf"), device=dev))
    first_col = firing[:, i_first, torch.arange(S, device=dev)]  # (R, S)
    rule_first = torch.where(
        alert, torch.argmax(first_col.to(torch.uint8), dim=0),
        -1).to(torch.int32)
    return {
        "alert": alert,
        "t_first_alert": t_first,
        "rule_first_alert": rule_first,
        "burn_peak": torch.stack(peaks).amax(dim=0).to(torch.float32),
    }


def sweep_alerts(avail, ts, target: float = DEFAULT_TARGET,
                 rules: Sequence[BurnRateRule] = DEFAULT_RULES,
                 dt: Optional[float] = None,
                 device=None) -> Dict[str, np.ndarray]:
    """Ensemble burn-rate monitor on ``device`` (default: the CUDA card).

    ``avail``: (S, T) availability traces, numpy or a tensor (e.g.
    ``trace_availability`` from ``sweep_timeline(...,
    return_traces=True)``), taken in float64 as given; ``ts``: (T,)
    uniform grid.  Returns per-scenario numpy arrays: ``alert`` (bool),
    ``t_first_alert`` (float32, inf when never), ``rule_first_alert``
    (int32 index into ``rules``, -1 when never) and ``burn_peak``
    (float32, peak long-window burn).
    """
    import torch

    from repro_torch.kernels.backend import resolve_device

    dev = resolve_device(device)
    ts_np = np.asarray(ts.cpu() if isinstance(ts, torch.Tensor) else ts)
    if dt is None:
        dt = float(ts_np[1] - ts_np[0]) if len(ts_np) > 1 else 1.0
    steps = rule_steps(rules, dt)
    a = torch.as_tensor(avail)
    a = (a[None, :] if a.dim() == 1 else a).to(dev, torch.float64)
    out = _sweep_alerts_impl(
        a, torch.from_numpy(ts_np.astype(np.float32)).to(dev),
        float(target), steps)
    out = {k: v.cpu().numpy() for k, v in out.items()}

    from repro_torch import obs
    if obs.enabled():
        n_alert = int(out["alert"].sum())
        obs.set_gauge("ufa_slo_scenarios_alerting", n_alert)
        for ri, r in enumerate(rules):
            n = int((out["rule_first_alert"] == ri).sum())
            if n:
                obs.inc("ufa_slo_alerts_total", n, rule=r.name)
    return out


# ---------------------------------------------------------------------------
# verdict quality + host-side orchestration monitor
# ---------------------------------------------------------------------------

def alert_quality(alert: np.ndarray, violated: np.ndarray,
                  t_first_alert: Optional[np.ndarray] = None
                  ) -> Dict[str, float]:
    """Alert precision/recall against ground-truth SLA violation, plus
    median time-to-first-alert over true positives."""
    alert = np.asarray(alert, dtype=bool)
    violated = np.asarray(violated, dtype=bool)
    tp = int((alert & violated).sum())
    fp = int((alert & ~violated).sum())
    fn = int((~alert & violated).sum())
    out = {
        "n_scenarios": int(alert.size),
        "n_alerts": int(alert.sum()),
        "n_violations": int(violated.sum()),
        "precision": tp / (tp + fp) if (tp + fp) else 1.0,
        "recall": tp / (tp + fn) if (tp + fn) else 1.0,
    }
    if t_first_alert is not None:
        tta = np.asarray(t_first_alert, dtype=np.float64)[alert & violated]
        out["median_t_first_alert"] = (
            float(np.median(tta)) if tta.size else float("inf"))
    return out


def monitor_orchestrator(fleet, orch, target: float = DEFAULT_TARGET,
                         rules: Sequence[BurnRateRule] = DEFAULT_RULES,
                         n_samples: int = 48, seed: int = 3
                         ) -> Dict[str, object]:
    """Host-side SLO monitor for an event-loop failover run.

    Samples availability through the failover window (uniform grid) and
    runs the numpy burn-rate monitor over it.
    """
    from repro_torch.core.metrics import availability_during_failover

    samples = availability_during_failover(
        fleet, orch, n_samples=n_samples, seed=seed)
    ts = np.array([t for t, _ in samples])
    avail = np.array([a for _, a in samples])
    verdict = alerts_np(avail, ts, target=target, rules=rules)

    from repro_torch import obs
    if obs.enabled():
        if bool(verdict["alert"]):
            ri = int(verdict["rule_first_alert"])
            obs.inc("ufa_slo_alerts_total", rule=rules[ri].name)
        obs.set_gauge("ufa_slo_scenarios_alerting",
                      1.0 if bool(verdict["alert"]) else 0.0)
    tracer = obs.get_tracer()
    if tracer is not None and bool(verdict["alert"]):
        t0 = float(verdict["t_first_alert"])
        ri = int(verdict["rule_first_alert"])
        tracer.sim_instant(f"slo-alert:{rules[ri].name}", t0,
                           args={"burn_peak": float(verdict["burn_peak"])})
    return {
        "ts": ts, "availability": avail,
        "alert": bool(verdict["alert"]),
        "t_first_alert": float(verdict["t_first_alert"]),
        "rule_first_alert": int(verdict["rule_first_alert"]),
        "burn_peak": float(verdict["burn_peak"]),
        "rules": [r.name for r in rules],
        "target": target,
    }
