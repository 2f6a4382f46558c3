"""Sharding tables for params, batches and decode state (port of
``repro/dist/sharding.py``).

A spec is a tuple with one entry a dimension: a mesh axis name, a tuple
of names (the dimension split over their product, the first major), or
``None`` (whole); ``()`` is replicated.  Each table gives, leaf for leaf,
the reference's ``PartitionSpec``s on a mesh of the same shape.  The
entry points are *heuristic but safe*: a dimension is only pinned to a
mesh axis when it divides the axis-size product.  ``dist.smap.put``
places a global tree by a table (each rank keeps its block);
``models.model`` gathers each layer's weights over their spec's axes at
use (``leaf_specs``, the one place a leaf's layout is read from).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

from repro_torch.configs.base import cache_seq_len  # noqa: F401


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes a global batch dimension spreads over."""
    return tuple(a for a in mesh.axis_names if a != "model")


def replicated(mesh) -> tuple:
    return ()


def _batch_spec(mesh, dim: int):
    axes = batch_axes(mesh)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    if n > 1 and dim % n == 0:
        return axes if len(axes) > 1 else axes[0]
    return None


def _model_spec(mesh, dim: int):
    if "model" in mesh.axis_names and mesh.shape["model"] > 1 \
            and dim % mesh.shape["model"] == 0:
        return "model"
    return None


def _leaf_spec(path, shape, mesh, fsdp: bool) -> tuple:
    """Tensor-parallel spec for one parameter leaf (``path``: its tree
    keys, ``shape``: its global shape).

    2D+ weights shard their widest "width" dim over "model"; with fsdp the
    opposite end additionally shards over the data axes.  Stacked-layer
    leading dims, norm scales and biases stay replicated."""
    keys = list(path)
    stacked = "layers" in keys
    first = 1 if stacked else 0           # skip the (n_layers, ...) dim
    ndim = len(shape)
    if ndim - first < 2:                  # scales, biases, mix weights
        return ()
    spec = [None] * ndim
    name = keys[-1] if keys else ""
    if name in ("w_gate", "w_up", "w_down") and ndim - first == 3:
        # routed experts (E, d, f): expert-parallel over "model",
        # FSDP over the widest remaining dim
        spec[first] = _model_spec(mesh, shape[first])
        if fsdp:
            tail = first + 2 if name != "w_down" else first + 1
            spec[tail] = _batch_spec(mesh, shape[tail])
        return tuple(spec)
    # generic 2D matmul weight: "model" on the last dim when divisible,
    # else the first non-stacked dim; fsdp on the other end
    if _model_spec(mesh, shape[-1]) is not None:
        spec[-1] = "model"
        if fsdp:
            spec[first] = _batch_spec(mesh, shape[first])
    elif _model_spec(mesh, shape[first]) is not None:
        spec[first] = "model"
        if fsdp:
            spec[-1] = _batch_spec(mesh, shape[-1])
    return tuple(spec)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_shardings(cfg, mesh, fsdp: bool = True) -> Any:
    """Spec tree matching ``init_params(cfg, ...)``."""
    from repro_torch.models import init_abstract
    return _map_with_path(
        lambda path, leaf: _leaf_spec(path, tuple(leaf.shape), mesh, fsdp),
        init_abstract(cfg))


@functools.lru_cache(maxsize=64)
def leaf_specs(cfg, mesh, layout: str = "fsdp"
               ) -> Dict[Tuple[str, ...], Tuple[tuple, tuple]]:
    """Each param leaf path's (spec, global shape) under a
    ``dist.ctx.PARAM_LAYOUTS`` layout: ``param_shardings`` flat, or
    replicated for "whole"."""
    from repro_torch.models import init_abstract

    def spec(path, shape):
        if layout == "whole":
            return ()
        return _leaf_spec(path, shape, mesh, layout == "fsdp")
    out = {}
    _map_with_path(lambda path, leaf: out.__setitem__(
        path, (spec(path, tuple(leaf.shape)), tuple(leaf.shape))),
        init_abstract(cfg))
    return out


def train_batch_shardings(cfg, mesh) -> dict:
    """Specs of {"inputs", "labels"} train batches (batch-dim DP)."""
    axes = batch_axes(mesh)
    # a one-axis tuple is that axis, as PartitionSpec normalises it
    entry = (None if not axes else axes[0] if len(axes) == 1 else axes)

    def shard(ndim_tail):
        return (entry,) + (None,) * ndim_tail
    inputs = shard(2 if not cfg.embed_inputs else 1)
    return {"inputs": inputs, "labels": shard(1)}


def prefill_shardings(cfg, mesh) -> dict:
    return {"inputs": train_batch_shardings(cfg, mesh)["inputs"]}


def decode_token_shardings(cfg, mesh, batch: int) -> tuple:
    spec = _batch_spec(mesh, batch)
    if cfg.embed_inputs:
        return (spec,)
    return (spec, None)


def decode_state_shardings(cfg, mesh, batch: int):
    """DecodeState specs: KV caches shard their sequence dim over
    "model" (split-KV decode), batch dims over the data axes."""
    import torch

    from repro_torch.models.model import DecodeState, init_decode_state
    abstract = init_decode_state(cfg, batch, 8, torch.bfloat16,
                                 device="meta")
    b = _batch_spec(mesh, batch)

    def shard(name, leaf):
        spec = [None] * leaf.dim()
        if len(spec) >= 2:
            spec[1] = b
        if name in ("k_cache", "v_cache", "k_scale", "v_scale") \
                and leaf.dim() > 2:
            # the runtime sequence length is the caller's max_seq: pin
            # only the axis name; dist.smap.put raises where it does not
            # divide
            if "model" in mesh.axis_names and mesh.shape["model"] > 1 \
                    and leaf.shape[2] > 0:
                spec[2] = "model"
        return tuple(spec)

    return DecodeState(
        k_cache=shard("k_cache", abstract.k_cache),
        v_cache=shard("v_cache", abstract.v_cache),
        k_scale=shard("k_scale", abstract.k_scale),
        v_scale=shard("v_scale", abstract.v_scale),
        conv_state=(None, b),
        ssm_state=(None, b),
        length=(),
    )
