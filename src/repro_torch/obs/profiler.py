"""Phase timing + device-aware pipeline profiling.

A ``Profiler`` times named phases of a pipeline run (detect, plan,
sweep, export, ...) into the ``ufa_phase_seconds`` histogram and — when
a tracer is attached — onto the host track of the Chrome trace.  The
device-aware pieces:

  * ``phase(..., sync=tree)`` synchronises every CUDA device that holds
    a tensor of ``tree`` (a tensor, or a dict / list / tuple of them)
    before stopping the clock, so asynchronously queued device work is
    charged to the phase that launched it instead of whoever touches
    the result first; CPU tensors and other leaves need no wait;
  * ``jit_cache_watch`` diffs a jit-cache size callable (e.g.
    ``sweep_engine.compiled_variants``) around a block, turning
    recompiles into a counter delta + gauge;
  * ``throughput`` / ``padding_waste`` are the shared recording shims
    the engine call sites use, so gauge/counter naming stays in one
    place.

``torch`` is imported lazily (only when ``sync`` is actually used).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, Optional

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

    @contextmanager
    def jit_cache_watch(self, cache_size: Callable[[], int],
                        gauge: str = "ufa_sweep_compiled_variants",
                        misses: str = "ufa_sweep_compile_misses_total"):
        """Diff a jit-cache size around a block: new entries are compile
        misses (counter), the post size a gauge."""
        before = cache_size()
        try:
            yield
        finally:
            after = cache_size()
            obs.set_gauge(gauge, after)
            if after > before:
                obs.inc(misses, after - before)


# ---------------------------------------------------------------------------
# recording shims shared by the engine call sites
# ---------------------------------------------------------------------------

def throughput(kind: str, n: int, seconds: float, **labels):
    """Record one {ingest,sweep,timeline} call's throughput: the
    ``*_total`` counter and the ``*_per_s`` gauge for ``kind``."""
    obs.inc(f"ufa_{kind}_total", n, **labels)
    if seconds > 0:
        obs.set_gauge(f"ufa_{kind}_per_s", n / seconds)


def padding_waste(n: int, padded: int,
                  gauge: str = "ufa_sweep_padding_waste_ratio"):
    """Record the padding-waste fraction of a bucket-padded mega-batch."""
    if padded > 0:
        obs.set_gauge(gauge, (padded - n) / padded)
