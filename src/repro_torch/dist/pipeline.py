"""GPipe-style pipeline parallelism over a mesh axis (port of
``repro/dist/pipeline.py``).

Layers are stacked on a leading axis and split contiguously across the
pipeline stages: stage ``i`` holds layers ``[i·L/n, (i+1)·L/n)``.
Microbatches stream through a ``ppermute`` ring (``batch_isend_irecv``).
Bubbles execute as wasted (masked) compute, as in the reference: the
program is the same on every rank.  The last stage's output is broadcast
by a ``psum``.
"""

from __future__ import annotations

import torch

from repro_torch.dist import smap


def _local_layers(params, sid: int, n_stages: int):
    """Stage ``sid``'s contiguous block of every stacked leaf."""
    if isinstance(params, dict):
        return {k: _local_layers(v, sid, n_stages) for k, v in params.items()}
    n = params.shape[0]
    if n % n_stages:
        raise ValueError(f"pipeline: {n} layers do not split over "
                         f"{n_stages} stages")
    per = n // n_stages
    return params[sid * per:(sid + 1) * per]


def pipeline_apply(stage_fn, params, x, *, mesh, n_microbatches: int = 1,
                   axis: str = None, local: bool = False):
    """Run ``stage_fn(layers_local, h)`` as an N-stage pipeline.

    params: a tree with a leading stacked-layer dim divisible by the
    number of stages, whole (each rank takes its block) or, with
    ``local=True``, already the rank's block; x: (B, ...) with B
    divisible by n_microbatches, the same on every rank.  Returns, on
    every rank, the value of folding all layers sequentially over x."""
    axis = axis or mesh.axis_names[0]
    n_stages = mesh.shape[axis]
    m = n_microbatches
    b = x.shape[0]
    if b % m:
        raise ValueError(f"pipeline: batch {b} does not split into {m} "
                         f"microbatches")
    mb = b // m
    sid = smap.axis_index(axis, mesh)
    layers = params if local else _local_layers(params, sid, n_stages)

    xs = x.reshape(m, mb, *x.shape[1:])
    buf = torch.zeros_like(xs[0])
    outs = [torch.zeros_like(xs[0]) for _ in range(m)]
    ring = [(i, i + 1) for i in range(n_stages - 1)]
    for t in range(m + n_stages - 1):
        feed = xs[min(max(t, 0), m - 1)]
        inp = feed if sid == 0 else buf
        y = stage_fn(layers, inp)
        # hand off to the next stage; stage 0 keeps reading fresh input
        buf = smap.ppermute(y, axis, ring, mesh)
        idx = t - (n_stages - 1)
        if sid == n_stages - 1 and idx >= 0:
            outs[idx] = y
    out = torch.stack(outs)
    # only the last stage holds real outputs; psum broadcasts them
    if sid != n_stages - 1:
        out = torch.zeros_like(out)
    out = smap.psum(out, axis, mesh)
    return out.reshape(x.shape)
