"""``shard_map`` over a ``torch.distributed`` mesh, and its collectives
(port of ``repro/dist/smap.py``).

The port runs one program per rank, with tensors as the rank's local
blocks: JAX's ``shard_map`` made explicit.  ``shard_map(f, mesh=...,
in_specs=..., out_specs=...)`` binds the mesh for the collectives that
``f`` calls and hands ``f`` the blocks it is given, placed by the caller
(``put``); the specs are declarative only.

The collectives name mesh axes, as ``lax`` does, and are autograd-aware:
each backward is the transpose of its forward (``psum`` <-> ``psum``,
``all_gather`` <-> a summing reduce-scatter, ``ppermute`` <-> the inverse
permutation), so the backward of a per-rank program is the gradient of
the sum of every rank's loss; the train step divides by the rank count.
``pmax`` is not differentiated (split-KV decode uses it for the
log-sum-exp's shift, which cancels).

  * On a live mesh a group of one rank skips its collective: a 1 x 1
    mesh is bit-equal to no mesh.
  * On an abstract mesh nothing is communicated: each collective
    returns a ``meta`` tensor of its result's shape, and, while an
    ``obs.cost.CostRecorder`` is active, logs ``(kind, result bytes,
    group size, nvlink)`` with the reference's HLO kind names, for
    ``launch.hlo_analysis``.  A live collective under a recorder logs
    the same.
"""

from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.dist import ctx as dctx
from repro_torch.launch.mesh import Mesh, in_one_node
from repro_torch.obs import cost as _cost

_TLS = threading.local()

# the names of newer torch releases, the older ones before them
_all_gather_1 = (getattr(dist, "all_gather_single", None)
                 or dist.all_gather_into_tensor)
_reduce_scatter_1 = (getattr(dist, "reduce_scatter_single", None)
                     or dist.reduce_scatter_tensor)


def _mesh(mesh: Optional[Mesh]) -> Mesh:
    """The mesh a collective runs over: the one given, the one bound by
    ``shard_map``, or the sharding context's."""
    if mesh is not None:
        return mesh
    m = getattr(_TLS, "mesh", None) or dctx.current_mesh()
    if m is None:
        raise RuntimeError("collective outside shard_map / sharding_rules "
                           "and no mesh given")
    return m


@contextmanager
def bind(mesh: Mesh):
    """Bind ``mesh`` for the collectives of the body."""
    prev = getattr(_TLS, "mesh", None)
    _TLS.mesh = mesh
    try:
        yield mesh
    finally:
        _TLS.mesh = prev


def spec_axes(entry) -> Tuple[str, ...]:
    """A spec entry (an axis, a tuple of axes or None) as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(shape: Sequence[int], spec, mesh: Mesh) -> Tuple[int, ...]:
    """The rank's block shape of a global ``shape`` laid out by ``spec``;
    raises where a sharded dimension does not divide."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, spec):
        n = math.prod(mesh.shape[a] for a in spec_axes(entry))
        if dim % n:
            raise ValueError(f"dimension {dim} of {tuple(shape)} does not "
                             f"divide over {entry} ({n} ranks)")
        out.append(dim // n)
    return tuple(out)


def shard_map(f, *, mesh: Mesh, in_specs=None, out_specs=None):
    """``f`` over the rank's blocks with ``mesh`` bound for its
    collectives: the wrapped function takes and returns local blocks.
    ``in_specs`` / ``out_specs`` keep the reference's signature and are
    not read: the caller has placed the blocks (``put``), so there is
    nothing left to split or join."""
    def wrapped(*args):
        with bind(mesh):
            return f(*args)
    return wrapped


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _log(mesh: Mesh, kind: str, result: torch.Tensor, axes) -> None:
    rec = _cost.active()
    if rec is None:
        return
    rec.add_collective(kind, result.numel() * result.element_size(),
                       mesh.group_size(axes),
                       in_one_node(mesh.group_ranks(axes)))


def _skip(mesh: Mesh, axes) -> bool:
    return mesh.group_size(axes) == 1


def axis_index(axes, mesh: Optional[Mesh] = None) -> int:
    """This rank's index over ``axes`` (row-major); 0 on an abstract
    mesh, which stands for rank 0."""
    return _mesh(mesh).index(axes)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, op):
        ctx.mesh, ctx.axes = mesh, axes
        y = x.clone()
        _log(mesh, "all-reduce", y, axes)
        if mesh.live:
            dist.all_reduce(y, op=op, group=mesh.group(axes))
        return y

    @staticmethod
    def backward(ctx, g):
        # the transpose of a sum over ranks is a sum over ranks
        return _AllReduce.apply(g.contiguous(), ctx.mesh, ctx.axes,
                                dist.ReduceOp.SUM), None, None, None


def psum(x: torch.Tensor, axes, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axes``, on every one of them."""
    mesh = _mesh(mesh)
    if _skip(mesh, axes):
        return x
    return _AllReduce.apply(x.contiguous(), mesh, mesh._axes(axes),
                            dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, axes, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Largest ``x`` over the ranks of ``axes`` (not differentiated)."""
    mesh = _mesh(mesh)
    if _skip(mesh, axes):
        return x.detach()
    axes = mesh._axes(axes)
    y = x.detach().contiguous().clone()
    _log(mesh, "all-reduce", y, axes)
    if mesh.live:
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=mesh.group(axes))
    return y


def pmean(x: torch.Tensor, axes, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Mean of ``x`` over the ranks of ``axes``."""
    mesh = _mesh(mesh)
    if _skip(mesh, axes):
        return x
    return psum(x, axes, mesh) / mesh.group_size(axes)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, axis):
        ctx.mesh, ctx.axes, ctx.axis = mesh, axes, axis
        n = mesh.group_size(axes)
        xm = x.movedim(axis, 0).contiguous()
        out = torch.empty((n * xm.shape[0],) + tuple(xm.shape[1:]),
                          dtype=x.dtype, device=x.device)
        _log(mesh, "all-gather", out, axes)
        if mesh.live:
            _all_gather_1(out, xm, group=mesh.group(axes))
        return out.movedim(0, axis).contiguous()

    @staticmethod
    def backward(ctx, g):
        return (_reduce_scatter(g, ctx.mesh, ctx.axes, ctx.axis), None,
                None, None)


def _reduce_scatter(g: torch.Tensor, mesh: Mesh, axes, axis: int):
    """Sum over the ranks of ``axes``, each keeping its block of
    dimension ``axis``: the transpose of a tiled all-gather."""
    n = mesh.group_size(axes)
    gm = g.movedim(axis, 0).contiguous()
    out = torch.empty((gm.shape[0] // n,) + tuple(gm.shape[1:]),
                      dtype=g.dtype, device=g.device)
    _log(mesh, "reduce-scatter", out, axes)
    if mesh.live:
        _reduce_scatter_1(out, gm, op=dist.ReduceOp.SUM,
                          group=mesh.group(axes))
    return out.movedim(0, axis).contiguous()


def all_gather(x: torch.Tensor, axes, axis: int = 0, tiled: bool = True,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The blocks of ``x`` over the ranks of ``axes`` joined along
    ``axis`` (``tiled``), or stacked on a new leading axis."""
    mesh = _mesh(mesh)
    axis = axis % x.dim() if tiled else 0
    if not tiled:
        x = x[None]
    if _skip(mesh, axes):
        return x
    return _AllGather.apply(x, mesh, mesh._axes(axes), axis)


def _permute(x: torch.Tensor, mesh: Mesh, axis: str, perm) -> torch.Tensor:
    out = torch.zeros_like(x)
    _log(mesh, "collective-permute", out, axis)
    if not mesh.live:
        return out
    me = mesh.index(axis)
    ranks = mesh.group_ranks(axis)
    ops = []
    x = x.contiguous()
    for src, dst in perm:
        if src == me:
            ops.append(dist.P2POp(dist.isend, x, ranks[dst]))
        if dst == me:
            ops.append(dist.P2POp(dist.irecv, out, ranks[src]))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis, ctx.perm = mesh, axis, perm
        return _permute(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, g):
        inv = tuple((d, s) for s, d in ctx.perm)
        return _permute(g, ctx.mesh, ctx.axis, inv), None, None, None


def ppermute(x: torch.Tensor, axis: str, perm,
             mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``lax.ppermute``: rank ``src`` of the axis sends ``x`` to ``dst``
    for each ``(src, dst)`` of ``perm``; a rank nothing is sent to gets
    zeros."""
    mesh = _mesh(mesh)
    perm = tuple((int(s), int(d)) for s, d in perm)
    if _skip(mesh, axis):
        return x if (0, 0) in perm else torch.zeros_like(x)
    return _Permute.apply(x, mesh, axis, perm)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def block_slices(shape: Sequence[int], spec, mesh: Mesh) -> tuple:
    """The rank's block of a global ``shape`` laid out by ``spec``, as a
    slice a dimension."""
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    loc = local_shape(shape, spec, mesh)
    out = []
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        i = mesh.index(axes) if axes else 0
        out.append(slice(i * loc[dim], (i + 1) * loc[dim]))
    return tuple(out)


def _block(t: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    if not mesh.live:
        return torch.empty(local_shape(t.shape, tuple(spec), mesh),
                           dtype=t.dtype, device="meta")
    if not any(spec_axes(e) for e in tuple(spec)):
        return t
    return t[block_slices(t.shape, spec, mesh)].clone()


def put(tree: Any, specs: Any, mesh: Mesh) -> Any:
    """The rank's block of every tensor of a global tree, by a matching
    tree of specs (``jax.device_put(x, NamedSharding(mesh, spec))``);
    ``meta`` blocks on an abstract mesh."""
    return _map2(lambda t, s: _block(t, s, mesh), tree, specs)


def unshard(t: torch.Tensor, spec, mesh: Optional[Mesh] = None
            ) -> torch.Tensor:
    """The global tensor of the rank's block ``t`` laid out by ``spec``:
    an all-gather over each dimension's axes (its backward a summing
    reduce-scatter)."""
    for dim, entry in enumerate(tuple(spec)):
        axes = spec_axes(entry)
        if axes:
            t = all_gather(t, axes, axis=dim, mesh=mesh)
    return t


def gather(tree: Any, specs: Any, mesh: Mesh) -> Any:
    """The global tensors of a tree of blocks laid out by ``specs``, on
    every rank (all-gathers; no gradient)."""
    def full(t, spec):
        with torch.no_grad():
            return unshard(t, spec, mesh)
    return _map2(full, tree, specs)


def _map2(fn, tree, specs):
    """``fn(tensor, spec)`` over a tree and a matching tree of specs
    (dicts, NamedTuples, lists); ``None`` specs are replicated."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, () if specs is None else specs)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map2(fn, v, None if specs is None else specs[k])
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map2(fn, getattr(tree, f),
                                  None if specs is None
                                  else getattr(specs, f))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map2(fn, v, None if specs is None else s)
                          for v, s in zip(tree, specs if specs is not None
                                          else [None] * len(tree)))
    return tree
