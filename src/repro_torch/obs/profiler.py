"""Phase timing + device-aware pipeline profiling.

A ``Profiler`` times named phases of a pipeline run (detect, plan,
sweep, export, ...) into the ``ufa_phase_seconds`` histogram and — when
a tracer is attached — onto the host track of the Chrome trace.  The
device-aware pieces:

  * ``phase(..., sync=tree)`` synchronises every CUDA device that holds
    a tensor of ``tree`` (a tensor, or a dict / list / tuple of them)
    before stopping the clock, so asynchronously queued device work is
    charged to the phase that launched it instead of whoever touches
    the result first; CPU tensors and other leaves need no wait.

The reference's ``jit_cache_watch`` and its ``throughput`` /
``padding_waste`` shims are not ported: the port compiles no program
per shape, and its engines set their gauges themselves.  ``torch`` is
imported lazily (only when ``sync`` is actually used).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Dict

from repro_torch import obs


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _synchronize(tree) -> None:
    """Wait for the queued work of every CUDA device holding a tensor of
    ``tree``: what ``jax.block_until_ready`` gives the reference."""
    import torch
    devices = {t.device for t in _leaves(tree)
               if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


class Profiler:
    """Times phases into the registry (+ optional tracer host spans)."""

    def __init__(self, tracer=None):
        self.tracer = tracer if tracer is not None else obs.get_tracer()
        self.phases: Dict[str, float] = {}     # last wall time per phase

    @contextmanager
    def phase(self, name: str, sync: Any = None, **args):
        """Time a named phase.  ``sync`` is an optional tree of tensors
        whose CUDA devices are synchronised before the clock stops."""
        t0 = time.perf_counter()
        span = (self.tracer.span(name, **args)
                if self.tracer is not None else None)
        if span is not None:
            span.__enter__()
        try:
            yield self
        finally:
            if sync is not None:
                _synchronize(sync)
            if span is not None:
                span.__exit__(None, None, None)
            dt = time.perf_counter() - t0
            self.phases[name] = dt
            obs.observe("ufa_phase_seconds", dt, phase=name)
