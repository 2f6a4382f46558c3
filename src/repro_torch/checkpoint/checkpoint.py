"""Checkpoint and restore (port of ``repro/checkpoint/checkpoint.py``).

Format, the reference's: one directory per step holding ``manifest.json``
(step, ``extra``, and for each leaf its path, file, shape and dtype) and
one raw buffer ``leaf_XXXXX.bin`` per leaf, written unsharded.  Leaf
paths are the reference's pytree paths: dict keys bare and in sorted
order, NamedTuple fields with a leading ``.``, sequence items by index,
joined by ``/`` (a ``TrainState`` gives ``.params/embed``,
``.opt/.m/layers/attn/wk``, ``.opt/.step``, ``.step``).  With the same
files and paths, each package loads the other's checkpoints.  numpy has
no bfloat16, so a bf16 leaf is written and read as its raw 16-bit words
under the reference's dtype string ``bfloat16``.

Reshard-on-load: ``load_checkpoint(..., shardings=specs, mesh=mesh)``
gives each rank only its block of each leaf, read with ``np.memmap``
slicing (never the whole file), onto any mesh.  Saving from a mesh
(``save_checkpoint(..., shardings=specs, mesh=mesh)``) gathers each leaf
to whole and rank 0 writes the same unsharded format, so the two
packages still load each other's files.

``AsyncCheckpointer`` double-buffers: the device-to-host copy happens on
the caller's thread, serialization on a daemon thread, so the training
loop is not blocked by storage (the paper's MBB philosophy: overlap the
slow path with useful work).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device

_MANIFEST = "manifest.json"

# dtype strings as numpy (and the reference's manifest) names them
_NAMES = {torch.float32: "float32", torch.float64: "float64",
          torch.bfloat16: "bfloat16", torch.float16: "float16",
          torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
          torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool"}
_TORCH = {v: k for k, v in _NAMES.items()}


def _flatten_with_paths(tree, prefix: Tuple[str, ...] = ()
                        ) -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` in the reference's pytree order and names."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flatten_with_paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree._fields
                for x in _flatten_with_paths(getattr(tree, f),
                                             prefix + ("." + f,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in _flatten_with_paths(t, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _unflatten(like, leaves):
    """A tree shaped like ``like`` with ``leaves`` in
    ``_flatten_with_paths`` order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            vals = {k: build(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(getattr(t, f)) for f in t._fields))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(like)


def _host(leaf, copy: bool) -> np.ndarray:
    """A leaf as a host array in its own dtype; a bf16 tensor as its raw
    16-bit words (numpy has no bfloat16).  ``copy``: never a view of the
    leaf, also for one already on the host."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=copy)
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy()
    return np.array(leaf) if copy else np.asarray(leaf)


def _dtype_name(leaf, arr: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor):
        return _NAMES[leaf.dtype]
    return str(arr.dtype)


def _write(directory: Path, step: int, leaves, extra) -> Path:
    """Atomic (write-to-temp + rename) full checkpoint of ``[(path, dtype
    name, host array)]``."""
    final = directory / f"step_{step:010d}"
    tmp = directory / f".tmp_step_{step:010d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    for i, (path, name, arr) in enumerate(leaves):
        fname = f"leaf_{i:05d}.bin"
        manifest["leaves"].append({"path": path, "file": fname,
                                   "shape": list(arr.shape), "dtype": name})
        with open(tmp / fname, "wb") as f:
            f.write(np.ascontiguousarray(arr).tobytes())
    with open(tmp / _MANIFEST, "w") as f:
        json.dump(manifest, f)
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _host_leaves(tree, copy: bool = False) -> list:
    out = []
    for path, leaf in _flatten_with_paths(tree):
        arr = _host(leaf, copy)
        out.append((path, _dtype_name(leaf, arr), arr))
    return out


def whole(tree: Any, shardings: Any = None, mesh=None) -> Any:
    """The whole leaves of a tree of the rank's blocks laid out by
    ``shardings`` on ``mesh`` (every rank takes part); ``tree`` itself
    without a mesh."""
    if mesh is None or shardings is None:
        return tree
    from repro_torch.dist.smap import gather
    return gather(tree, shardings, mesh)


def save_checkpoint(directory: str | Path, step: int, tree: Any,
                    extra: Optional[Dict[str, Any]] = None,
                    shardings: Any = None, mesh=None) -> Optional[Path]:
    """Atomic (write-to-temp + rename) full checkpoint of a tree of
    tensors (dicts, NamedTuples, lists; numbers and numpy arrays too).
    From a mesh (``shardings`` the tree's specs), every rank gathers the
    whole leaves and rank 0 writes them; other ranks return None."""
    tree = whole(tree, shardings, mesh)
    if mesh is not None and mesh.rank != 0:
        return None
    return _write(Path(directory), step, _host_leaves(tree), extra)


def latest_step(directory: str | Path) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in directory.iterdir()
             if p.name.startswith("step_")]
    return max(steps) if steps else None


def _read(path: Path, m: dict, block=None) -> torch.Tensor:
    """One leaf's file as a CPU tensor of its manifest dtype; ``block``
    (a slice a dimension) reads only that block, through ``np.memmap``."""
    bf16 = m["dtype"] == "bfloat16"
    dtype = np.int16 if bf16 else np.dtype(m["dtype"])
    if block is None or not m["shape"]:
        arr = np.fromfile(path, dtype=dtype).reshape(m["shape"])
    elif 0 in m["shape"]:          # nothing to read: the block's shape
        arr = np.empty([len(range(*b.indices(n)))
                        for b, n in zip(block, m["shape"])], dtype=dtype)
    else:
        arr = np.array(np.memmap(path, dtype=dtype, mode="r",
                                 shape=tuple(m["shape"]))[block])
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if bf16 else t


def load_checkpoint(directory: str | Path, like: Any,
                    step: Optional[int] = None, device=None,
                    shardings: Any = None, mesh=None
                    ) -> Tuple[Any, Dict[str, Any]]:
    """Restore into the structure of ``like`` (a tree of tensors, ``meta``
    ones too): each leaf in the dtype of ``like``'s leaf, on ``device``
    (default: the CUDA card).  With ``shardings`` (a tree of specs like
    ``like``) and a live ``mesh``, each leaf is the rank's block, read
    from the file alone: reshard-on-load onto any mesh.  Returns
    ``(tree, extra)``."""
    dev = resolve_device(device)
    specs = None
    if shardings is not None:
        from repro_torch.dist.smap import block_slices
        if mesh is None:
            raise ValueError("load_checkpoint: shardings need a mesh")
        specs = [s for _, s in _flatten_specs(like, shardings)]
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    d = directory / f"step_{step:010d}"
    manifest = json.loads((d / _MANIFEST).read_text())
    by_path = {m["path"]: m for m in manifest["leaves"]}
    out = []
    for i, (path, leaf) in enumerate(_flatten_with_paths(like)):
        m = by_path.get(path)
        if m is None:
            raise KeyError(f"checkpoint {d} has no leaf {path}")
        block = (None if specs is None
                 else block_slices(m["shape"], specs[i], mesh))
        t = _read(d / m["file"], m, block)
        target = leaf.dtype if isinstance(leaf, torch.Tensor) else t.dtype
        out.append(t.to(device=dev, dtype=target))
    return _unflatten(like, out), manifest["extra"]


def _flatten_specs(like, specs) -> List[Tuple[str, Any]]:
    """``[(path, spec)]`` of a spec tree matching ``like``, in
    ``_flatten_with_paths`` order (a spec is a tuple; a None subtree
    is replicated)."""
    out = []

    def walk(t, s):
        if t is None:
            return
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], None if s is None else s[k])
        elif isinstance(t, tuple) and hasattr(t, "_fields"):
            for f in t._fields:
                walk(getattr(t, f), None if s is None else getattr(s, f))
        elif isinstance(t, (list, tuple)):
            for j, v in enumerate(t):
                walk(v, None if s is None else s[j])
        else:
            out.append((None, () if s is None else s))
    walk(like, specs)
    return out


class AsyncCheckpointer:
    """Double-buffered async writer: ``save()`` returns once the host copy
    exists; serialization happens on a daemon thread.  ``wait()`` joins
    and raises what the writer raised."""

    def __init__(self, directory: str | Path, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None):
        self.wait()
        leaves = _host_leaves(tree, copy=True)

        def work():
            try:
                _write(self.directory, step, leaves, extra)
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(p for p in self.directory.iterdir()
                       if p.name.startswith("step_"))
        for p in steps[:-self.keep]:
            shutil.rmtree(p, ignore_errors=True)
