"""Meshes of the port, and the H100 constants the roofline prices with
(port of ``repro/launch/mesh.py``).

A mesh is a ``torch.distributed`` world laid out as named axes, ranks in
row-major order over the axes (the last axis varies fastest), as
``jax.make_mesh`` lays devices out.  Two kinds:

  * an **abstract** mesh (``make_production_mesh``): axis names and sizes
    only, no process group.  The dry run builds its per-rank program on
    the ``meta`` device over one; its collectives move nothing and are
    logged (``dist.smap``).
  * a **live** mesh (``make_local_mesh``) over the current world: one
    process group for every group of ranks that shares the coordinates
    outside a subset of the axes, made at construction by every rank in
    the same order.  ``gloo`` on the CPU, ``nccl`` on CUDA
    (``init_world``); a group of one rank skips its collective.

A *pod* is the UFA analogue of a region: the production deployment is
dual-pod active-active (2 × 16 × 16 ranks).  ``make_production_mesh``
is a function, never a module-level constant, so importing this module
touches no device and no process group.
"""

from __future__ import annotations

import datetime
import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# Per card, "NVIDIA H100 80GB HBM3, 700.00 W" as nvidia-smi reports it
# (the SXM part's data sheet, dense rates); used by launch/roofline.py.
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, dense bf16 tensor cores (data sheet)
HBM_BANDWIDTH = 3.35e12       # B/s, HBM3 (data sheet)
# torch.cuda.get_device_properties(0).total_memory on the card
# (chip_smoke.py phase 13c checks it)
HBM_BYTES = 85_017_493_504
SMEM_BYTES_PER_SM = 228 * 1024
NVLINK_BANDWIDTH = 450e9      # B/s one direction, within an 8-GPU node
NODE_LINK_BANDWIDTH = 50e9    # B/s, one 400 Gb/s NDR port a GPU, across nodes
GPUS_PER_NODE = 8


def in_one_node(ranks: Sequence[int]) -> bool:
    """Whether these global ranks sit in one node of ``GPUS_PER_NODE``
    consecutive ranks (ranks are laid out node-major)."""
    return min(ranks) // GPUS_PER_NODE == max(ranks) // GPUS_PER_NODE


def link_bandwidth(ranks: Sequence[int]) -> float:
    """The bandwidth a collective over these global ranks is priced at:
    NVLink inside one node, the node link otherwise."""
    return NVLINK_BANDWIDTH if in_one_node(ranks) else NODE_LINK_BANDWIDTH


class Mesh:
    """Named axes over ``prod(shape)`` ranks; this process is ``rank``.

    ``shape`` maps each axis name to its size (``mesh.shape["model"]``),
    ``axis_names`` keeps their order, ``size`` is the rank count.
    ``live`` meshes hold a process group for every (subset of axes, the
    rank's coordinates elsewhere); abstract ones hold none and stand for
    rank 0."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 live: bool = False, rank: int = 0,
                 device: Optional[torch.device] = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axes "
                             f"{tuple(axis_names)} differ in length")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              map(int, shape)))
        self.size = math.prod(self.shape.values())
        self.live = live
        self.rank = int(rank)
        self.device = device
        self.coords = self._coords(self.rank)
        self._groups: Dict[Tuple[str, ...], object] = {}
        if live:
            self._make_groups()

    def __repr__(self):
        kind = "live" if self.live else "abstract"
        return (f"Mesh({kind}, {dict(self.shape)}, rank={self.rank}, "
                f"device={self.device})")

    def _coords(self, rank: int) -> Dict[str, int]:
        out = {}
        for a in reversed(self.axis_names):
            out[a] = rank % self.shape[a]
            rank //= self.shape[a]
        return {a: out[a] for a in self.axis_names}

    def _rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords[a]
        return r

    def _axes(self, axes) -> Tuple[str, ...]:
        """``axes`` (a name, a sequence of names or None) as a tuple in
        the mesh's own order."""
        if axes is None:
            return ()
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in names:
            if a not in self.shape:
                raise ValueError(f"mesh {self.axis_names} has no axis {a!r}")
        return tuple(a for a in self.axis_names if a in names)

    def group_ranks(self, axes, rank: Optional[int] = None) -> Tuple[int, ...]:
        """The global ranks of ``rank``'s group over ``axes``, in the
        group's order (row-major over those axes)."""
        axes = self._axes(axes)
        base = self._coords(self.rank if rank is None else rank)
        out = []
        for vals in itertools.product(*(range(self.shape[a]) for a in axes)):
            c = dict(base)
            c.update(zip(axes, vals))
            out.append(self._rank_of(c))
        return tuple(out)

    def group_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._axes(axes))

    def index(self, axes) -> int:
        """This rank's position in its group over ``axes`` (row-major)."""
        i = 0
        for a in self._axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes):
        """The process group of this rank over ``axes`` (live meshes)."""
        if not self.live:
            raise RuntimeError("an abstract mesh has no process groups")
        return self._groups[self._axes(axes)]

    def _make_groups(self):
        """Every rank runs this in the same order: for each non-empty
        subset of axes, one ``new_group`` a group of ranks.  Groups of
        one rank get none (their collectives are skipped)."""
        names = self.axis_names
        for k in range(1, len(names) + 1):
            for axes in itertools.combinations(names, k):
                if self.group_size(axes) == 1:
                    self._groups[axes] = None
                    continue
                seen = set()
                for r in range(self.size):
                    ranks = self.group_ranks(axes, r)
                    if ranks in seen:
                        continue
                    seen.add(ranks)
                    pg = (dist.group.WORLD
                          if len(ranks) == dist.get_world_size()
                          else dist.new_group(list(ranks)))
                    if self.rank in ranks:
                        self._groups[axes] = pg


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The abstract production mesh: (16, 16) ``("data", "model")``, or
    (2, 16, 16) ``("pod", "data", "model")`` for the dual-pod fleet."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_abstract_mesh(shape: Sequence[int],
                       axis_names: Sequence[str] = ("data", "model")) -> Mesh:
    """An abstract mesh of any shape (the dry run's small meshes)."""
    return Mesh(shape, axis_names)


def init_world(init_file: str, rank: int, world_size: int,
               device="cuda", timeout_s: float = 300.0,
               backend: Optional[str] = None) -> torch.device:
    """Join a ``torch.distributed`` world through a ``FileStore`` at
    ``init_file``: ``gloo`` for ``device="cpu"``, ``nccl`` for CUDA (rank
    ``r`` on card ``r % device_count``), or the ``backend`` the caller
    names (``"gloo"`` with CUDA tensors: its collectives stage through the
    host).  Returns the rank's device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_world: CUDA was asked for but "
                               "torch.cuda.is_available() is False")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend = backend or "nccl"
    elif dev.type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"init_world: {backend} on the CPU")
        backend = "gloo"
    else:
        raise ValueError(f"init_world: 'cuda' or 'cpu', got {dev}")
    store = dist.FileStore(init_file, world_size)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)
    return dev


def make_local_mesh(data: int = 1, model: int = 1, device="cuda",
                    axis_names: Sequence[str] = ("data", "model")) -> Mesh:
    """A live ``(data, model)`` mesh over the current world, whose size
    must be ``data * model`` (``init_world`` first)."""
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh: no torch.distributed world; "
                           "call launch.mesh.init_world first")
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"make_local_mesh: data {data} x model {model} != "
                         f"world size {world}")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh((data, model), axis_names, live=True, rank=dist.get_rank(),
                device=dev)


def make_world_mesh(shape: Sequence[int], axis_names: Sequence[str],
                    device="cuda") -> Mesh:
    """A live mesh of any shape over the current world."""
    if not dist.is_initialized():
        raise RuntimeError("make_world_mesh: no torch.distributed world")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh {tuple(shape)} does not cover the world of "
                         f"{dist.get_world_size()}")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(shape, axis_names, live=True, rank=dist.get_rank(),
                device=dev)
