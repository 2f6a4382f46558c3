"""CSR call-graph: the struct-of-arrays dependency layer (paper §5-6).

A ``CallGraph`` is the dependency-safety counterpart of
``core.fleet_state.FleetState``: one row per service-environment, edges as
parallel arrays in CSR order (sorted by caller, ``indptr`` delimiting each
caller's out-edges).  Every safety question the paper asks — which critical
services break when a preemption set goes dark, how far a failure
propagates, which unsafe edges to harden first — becomes an array program
over these columns (see ``repro_torch.graph.propagation`` / ``planner``).

Builders cover the three places graphs come from in practice:

  * ``from_fleet_state`` — the synthesized ground truth (array path),
  * ``from_specs``       — the synthesized ground truth (object path),
  * ``from_detections``  — what the runtime/static analysis layers *found*
    (an edge is fail-close iff a detector flagged it); certification then
    runs against the detectors' view of the world, exactly like production.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.fleet_state import AM, FleetState, RL, _edge_weights


@dataclasses.dataclass
class CallGraph:
    """Dependency edges in CSR order + the node masks propagation needs."""
    n: int                      # number of service-environments (nodes)
    src: np.ndarray             # int32 caller row, sorted ascending (CSR)
    dst: np.ndarray             # int32 callee row
    fail_open: np.ndarray       # bool — False = fail-close (UNSAFE)
    weight: np.ndarray          # float32 per-edge RPC volume
    indptr: np.ndarray          # int64 (n+1,) — node u's out-edges are
                                # src/dst[indptr[u]:indptr[u+1]]
    critical: np.ndarray        # bool — survives failover (AO/AM)
    preemptible: np.ndarray     # bool — goes dark in a failover (RL/TM)
    names: List[str]
    # CSR position -> index in the edge arrays the builder consumed
    # (e.g. ``FleetState.edges`` order); lets plan/detection results be
    # mapped back without re-deriving the sort
    input_order: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    @property
    def n_edges(self) -> int:
        return len(self.src)

    @property
    def unsafe(self) -> np.ndarray:
        """Edge mask: fail-close edges (the jnp kernels consume ~fail_open
        directly; this is the numpy view)."""
        return ~self.fail_open

    @property
    def n_unsafe(self) -> int:
        return int(np.count_nonzero(~self.fail_open))

    def out_edges(self, u: int) -> slice:
        return slice(int(self.indptr[u]), int(self.indptr[u + 1]))

    def edge_names(self, edge_idx: Iterable[int]) -> List[Tuple[str, str]]:
        return [(self.names[self.src[i]], self.names[self.dst[i]])
                for i in edge_idx]

    def input_edge_indices(self, edge_idx: Iterable[int]) -> np.ndarray:
        """Map CSR edge indices (e.g. ``HardeningPlan.hardened_edges``)
        back to the builder's input edge order — for ``from_fleet_state``
        graphs, positions into ``FleetState.edges`` suitable for
        ``fs.edges.fail_open[...] = True``."""
        assert self.input_order is not None, \
            "graph was built without an input-order mapping"
        return self.input_order[np.asarray(list(edge_idx), np.int64)]

    def unsafe_edge_keys(self) -> Set[Tuple[str, str]]:
        """(caller, callee) name pairs of every fail-close edge."""
        idx = np.flatnonzero(~self.fail_open)
        return {(self.names[self.src[i]], self.names[self.dst[i]])
                for i in idx}

    # ------------------------------------------------------------------
    def harden(self, edge_idx: Iterable[int]) -> "CallGraph":
        """New graph with the given edges converted fail-open (the paper's
        code-level remediation); everything else is shared/copied cheaply."""
        fo = self.fail_open.copy()
        fo[np.asarray(list(edge_idx), np.int64)] = True
        return dataclasses.replace(self, fail_open=fo)

    def with_edge(self, caller: str, callee: str,
                  fail_open: bool = False,
                  weight: float = 1.0) -> "CallGraph":
        """New graph with one extra edge (regression-gate test vector)."""
        i, j = self.index[caller], self.index[callee]
        return _build_csr(self.n,
                          np.append(self.src, np.int32(i)),
                          np.append(self.dst, np.int32(j)),
                          np.append(self.fail_open, fail_open),
                          np.append(self.weight, np.float32(weight)),
                          self.critical, self.preemptible, self.names)

    @property
    def index(self) -> Dict[str, int]:
        idx = getattr(self, "_index", None)
        if idx is None:
            idx = {n: i for i, n in enumerate(self.names)}
            object.__setattr__(self, "_index", idx)
        return idx

    # ------------------------------------------------------------------
    # builders
    # ------------------------------------------------------------------
    @classmethod
    def from_fleet_state(cls, fs: FleetState) -> "CallGraph":
        assert fs.edges is not None, "FleetState synthesized without edges"
        e = fs.edges
        weight = e.weight if e.weight is not None else \
            _edge_weights(fs.tier, e.src, e.dst)
        return _build_csr(fs.n, e.src, e.dst, e.fail_open,
                          np.asarray(weight, np.float32),
                          fs.fclass <= AM, fs.fclass >= RL, list(fs.names))

    @classmethod
    def from_specs(cls, fleet: Dict[str, "object"]) -> "CallGraph":
        fs = FleetState.from_specs(fleet, with_edges=True)
        return cls.from_fleet_state(fs)

    @classmethod
    def from_detections(cls, fleet, fail_close_edges: Set[Tuple[str, str]]
                        ) -> "CallGraph":
        """Graph as the detection layers see it: every known RPC edge, with
        fail-close exactly where runtime/static analysis flagged it.
        Accepts either fleet representation (``Dict[str, ServiceSpec]`` or
        ``FleetState``)."""
        g = (cls.from_fleet_state(fleet) if isinstance(fleet, FleetState)
             else cls.from_specs(fleet))
        idx = g.index
        flagged = np.asarray(
            [idx[c] * np.int64(g.n) + idx[d]
             for c, d in fail_close_edges if c in idx and d in idx],
            np.int64)
        packed = g.src.astype(np.int64) * g.n + g.dst
        return dataclasses.replace(g, fail_open=~np.isin(packed, flagged))

    @classmethod
    def from_detection_mask(cls, fs: FleetState,
                            fail_close: np.ndarray) -> "CallGraph":
        """Array path of ``from_detections``: the runtime layer's edge mask
        (aligned with ``fs.edges`` order, True = detector flagged the edge
        fail-close) becomes the graph directly — no name sets, no packed-id
        joins, just the CSR build."""
        assert fs.edges is not None, "FleetState synthesized without edges"
        e = fs.edges
        fail_close = np.asarray(fail_close, bool)
        assert fail_close.shape == e.src.shape, (fail_close.shape, e.n)
        weight = e.weight if e.weight is not None else \
            _edge_weights(fs.tier, e.src, e.dst)
        return _build_csr(fs.n, e.src, e.dst, ~fail_close,
                          np.asarray(weight, np.float32),
                          fs.fclass <= AM, fs.fclass >= RL, list(fs.names))


def _build_csr(n: int, src: np.ndarray, dst: np.ndarray,
               fail_open: np.ndarray, weight: np.ndarray,
               critical: np.ndarray, preemptible: np.ndarray,
               names: List[str]) -> CallGraph:
    order = np.argsort(src, kind="stable")
    src = np.ascontiguousarray(src[order], np.int32)
    indptr = np.searchsorted(src, np.arange(n + 1)).astype(np.int64)
    return CallGraph(n=n, src=src,
                     dst=np.ascontiguousarray(dst[order], np.int32),
                     fail_open=np.ascontiguousarray(fail_open[order], bool),
                     weight=np.ascontiguousarray(weight[order], np.float32),
                     indptr=indptr,
                     critical=np.asarray(critical, bool),
                     preemptible=np.asarray(preemptible, bool),
                     names=list(names), input_order=order)
