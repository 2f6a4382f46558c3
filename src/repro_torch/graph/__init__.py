"""Array-native dependency-graph engine: the CSR call graph and the
batched failure-propagation stage of the fused sweep."""

from repro_torch.graph.callgraph import CallGraph
from repro_torch.graph.propagation import (broken_critical_fractions,
                                           combined_dark_uniques, dep_consts,
                                           edge_consts, fixed_point,
                                           shared_blackhole_draws)

__all__ = [
    "CallGraph", "broken_critical_fractions", "combined_dark_uniques",
    "dep_consts", "edge_consts", "fixed_point", "shared_blackhole_draws",
]
