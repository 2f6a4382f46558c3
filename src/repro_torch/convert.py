"""Carry the reference package's state into the port.

The system has no weights: its state is the fleet, the call graph and
the constants derived from them.  ``from_reference_arrays`` builds the
port's objects from plain numpy-valued mappings of the reference's
objects (their dataclass fields), so both packages can be fed the same
state without the port importing the reference.  ``to_tensor`` carries
one reference array (model inputs, weights) into a tensor exactly,
bfloat16 included, and ``params_from_reference`` a whole parameter tree.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.dependency import TraceEdges
from repro_torch.core.fleet_state import EdgeArrays, FleetState
from repro_torch.core.timeline_sim import TimelineConfig
from repro_torch.graph.callgraph import CallGraph
from repro_torch.kernels.backend import resolve_device


def from_reference_arrays(*, fleet: Optional[Mapping] = None,
                          graph: Optional[Mapping] = None,
                          timeline: Optional[Mapping] = None,
                          analytic: Optional[Mapping] = None,
                          trace_edges: Optional[Mapping] = None,
                          device=None) -> Dict[str, object]:
    """Build the port's state from the reference's arrays.

      fleet     a ``FleetState``'s fields (``names``, ``tier``, ``fclass``,
                ``cores_per_replica``, ``replicas``, ``replicas_live``,
                ``placement``, ``pool``, ``locked``, ``traffic_enabled``)
                and ``edges``: None or the ``EdgeArrays`` fields
      graph     a ``CallGraph``'s fields: ``n`` and the CSR arrays
                (``src``, ``dst``, ``indptr``, ``weight``), the masks
                (``fail_open``, ``critical``, ``preemptible``), ``names``
                and optionally ``input_order``
      timeline  a ``TimelineConfig``'s fields
      analytic  the reference's ``analytic_consts`` as numpy scalars
      trace_edges  a ``TraceEdges``' fields (``edge_names``, ``weight``,
                ``unsafe``, ``cold``, ``caller_tier``, ``callee_tier``);
                its sampling tables are rebuilt by the port

    Returns a dict with the port's ``FleetState`` ("fleet"),
    ``CallGraph`` ("graph"), ``TimelineConfig`` ("timeline"), analytic
    constants as float32 tensors on ``device`` ("analytic") and
    ``TraceEdges`` ("trace_edges"), for whichever inputs were given.
    Arrays are copied, so the port's objects never alias the
    reference's."""
    out: Dict[str, object] = {}
    if fleet is not None:
        cols = {k: (np.array(v) if isinstance(v, np.ndarray) else v)
                for k, v in fleet.items() if k not in ("edges", "index")}
        cols["names"] = list(cols["names"])
        edges = fleet.get("edges")
        out["fleet"] = FleetState(
            **cols, edges=None if edges is None else EdgeArrays(
                **{k: None if v is None else np.array(v)
                   for k, v in edges.items()}))
    if graph is not None:
        g = {k: (np.array(v) if isinstance(v, np.ndarray) else v)
             for k, v in graph.items()}
        g["n"] = int(g["n"])
        g["names"] = list(g["names"])
        out["graph"] = CallGraph(**g)
    if timeline is not None:
        t = dict(timeline)
        t["tier_class_cores"] = np.array(t["tier_class_cores"], np.float64)
        out["timeline"] = TimelineConfig(**t)
    if trace_edges is not None:
        out["trace_edges"] = TraceEdges(
            edge_names=[tuple(e) for e in trace_edges["edge_names"]],
            **{k: np.array(trace_edges[k]) for k in
               ("weight", "unsafe", "cold", "caller_tier", "callee_tier")})
    if analytic is not None:
        dev = resolve_device(device)
        out["analytic"] = {k: torch.tensor(np.asarray(v, np.float32),
                                           device=dev)
                           for k, v in analytic.items()}
    return out


def to_tensor(a, device=None) -> torch.Tensor:
    """A copy of the reference array ``a`` (a JAX or numpy array) as a
    torch tensor on ``device`` (default: the CUDA card), value for value.
    bfloat16 included: ``np.asarray`` of a JAX bfloat16 array has dtype
    ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses, so it
    goes through float32 (which holds every bfloat16 exactly) and back."""
    dev = resolve_device(device)
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=dev, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(dev)


def params_from_reference(tree: Mapping[str, Any], device=None) -> Dict[str, Any]:
    """The port's parameter dict from the reference's ``init_params``
    tree (nested mappings of JAX or numpy arrays, bfloat16 included):
    the same keys, every leaf through ``to_tensor`` on ``device``
    (default: the CUDA card), the stacked layer axis kept."""
    return {k: params_from_reference(v, device) if isinstance(v, Mapping)
            else to_tensor(v, device) for k, v in tree.items()}
