"""Multi-hop failure propagation over a ``CallGraph`` (the sweep
engine's dependency stage).

Port of the parts of ``repro/graph/propagation.py`` the fused sweep
runs.  Breakage is the least fixed point of

    broken = S  ∪  { caller | ∃ fail-close edge caller->callee,
                              callee ∈ broken }

over a batch of dark sets at once.  The adjacency always goes to the
device in ELL form, and ``fixed_point`` runs ``fixed_point_ell``: the
CUDA round kernel on the card, its plain PyTorch version on the CPU —
``broken`` matrices and round counts exact either way.  The random dark
sets are drawn on the host with numpy, the reference's streams bit for
bit.  Not ported yet: ``certify``, ``blast_radius``, ``radius_counts``,
``blackhole_ensemble``, ``propagate(_many)`` and ``harden_consts``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.graph.callgraph import CallGraph
from repro_torch.kernels.backend import resolve_device
from repro_torch.kernels.ufa.propagation import ell_from_csr, fixed_point_ell


def fixed_point(dark: torch.Tensor, consts: Dict[str, torch.Tensor]):
    """Batched least fixed point: ``dark (U, n) bool -> (broken, rounds)``
    over the ELL adjacency in ``consts`` (see ``edge_consts``)."""
    return fixed_point_ell(dark, consts["ell_dst"], consts["ell_closed"])


def edge_consts(graph: CallGraph, device=None) -> Dict[str, torch.Tensor]:
    """Propagation constants on ``device`` (default: the CUDA card): the
    ELL adjacency ``ell_dst`` (n, K) int32 and its fail-close mask
    ``ell_closed`` (n, K) bool."""
    dev = resolve_device(device)
    ell_dst, ell_closed, _ = ell_from_csr(graph.n, graph.indptr, graph.dst,
                                          ~graph.fail_open)
    return {"ell_dst": torch.from_numpy(ell_dst).to(dev),
            "ell_closed": torch.from_numpy(ell_closed).to(dev)}


def dep_consts(graph: CallGraph, device=None) -> Dict[str, torch.Tensor]:
    """``edge_consts`` plus the critical mask and the (f32) critical
    count: what the fused sweep engine's dependency stage needs, uploaded
    once per graph."""
    dev = resolve_device(device)
    out = edge_consts(graph, dev)
    out["crit"] = torch.from_numpy(np.asarray(graph.critical, bool)).to(dev)
    out["n_crit"] = torch.tensor(np.float32(max(1, int(graph.critical.sum()))),
                                 device=dev)
    return out


def shared_blackhole_draws(graph: CallGraph, fractions: np.ndarray,
                           seed: int = 0
                           ) -> tuple[np.ndarray, np.ndarray]:
    """Host-side stage precompute for the fused engine: one uniform per
    service (scenario s darkens preemptibles with ``u < fractions[s]``),
    compressed to *unique* fractions.  Returns ``(dark_unique (U, n)
    bool, inverse (S,) int32)`` with ``dark_unique[inverse]`` the full
    per-scenario dark matrix (never materialized)."""
    rng = np.random.default_rng(seed)
    fractions = np.asarray(fractions, np.float64)
    u = rng.random(graph.n)                  # same stream as the ensemble
    uniq, inverse = np.unique(fractions, return_inverse=True)
    dark = (u[None, :] < uniq[:, None]) & graph.preemptible[None, :]
    return dark, inverse.astype(np.int32)


def combined_dark_uniques(graph: CallGraph, evict_fractions: np.ndarray,
                          storm_fractions: Optional[np.ndarray],
                          seed: int, storm_seed: int
                          ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Unique dark sets for BOTH dependency stages in one propagation
    batch: the blackhole uniques (stream ``seed``) plus — when a cascade
    storm is active anywhere in the grid — the storm's uniques under the
    independent stream ``storm_seed``, appended row-wise.  Returns
    ``(dark_u (U, n) bool, inv (S,) int32, storm_inv (S,) int32)``; with
    no storm a single all-false row is appended and every ``storm_inv``
    points at it."""
    dark_u, inv = shared_blackhole_draws(graph, evict_fractions, seed=seed)
    storm_fractions = (None if storm_fractions is None
                       else np.asarray(storm_fractions, np.float64))
    if storm_fractions is None or not (storm_fractions > 0.0).any():
        dark_u = np.concatenate(
            [dark_u, np.zeros((1, graph.n), bool)])
        storm_inv = np.full(len(inv), len(dark_u) - 1, np.int32)
        return dark_u, inv, storm_inv
    sdark, sinv = shared_blackhole_draws(graph, storm_fractions,
                                         seed=storm_seed)
    storm_inv = (sinv + len(dark_u)).astype(np.int32)
    return np.concatenate([dark_u, sdark]), inv, storm_inv


def broken_critical_fractions(dark_u: torch.Tensor, dep: Dict
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Blackhole verdicts for a (U, n) dark batch against ``dep_consts``,
    on the device: per-row broken-critical counts (int32), the f32
    broken-critical fraction, and the dark-set sizes (int32)."""
    broken, _ = fixed_point(dark_u, dep)
    counts = (broken & dep["crit"][None, :]).sum(dim=1, dtype=torch.int32)
    frac = counts.to(torch.float32) / dep["n_crit"]
    n_dark = dark_u.sum(dim=1, dtype=torch.int32)
    return counts, frac, n_dark
