"""Logical-axis sharding context (port of ``repro/dist/ctx.py``).

Model code names *logical* axes (``"batch"``, ``"kv_seq"``, ...); a
``sharding_rules`` context binds those names to mesh axes.  Outside a
context every lookup says "one rank", so the same model code runs
unchanged without a mesh.  The mesh is a ``launch.mesh.Mesh``, live or
abstract.  ``hint`` returns ``x`` itself: a torch tensor carries no
layout constraint (each rank holds its block), and the reference's
``hint`` never changes a value either.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Optional, Tuple, Union

Rule = Union[None, str, Tuple[str, ...]]

_TLS = threading.local()


def default_rules(mesh) -> Dict[str, Rule]:
    """Logical-axis -> mesh-axis table.  Batch-like axes map onto every
    non-model mesh axis (so multi-pod meshes data-parallelize over
    pod x data); everything width-like maps onto "model"."""
    data_axes = tuple(a for a in mesh.axis_names if a != "model")
    model = "model" if "model" in mesh.axis_names else None
    return {
        "batch": data_axes or None,
        "seq": model,
        "kv_seq": model,
        "heads": model,
        "ff": model,
        "vocab": model,
        "expert": model,
        "embed": None,
    }


class _Ctx:
    __slots__ = ("mesh", "rules", "param_layout")

    def __init__(self, mesh, rules, param_layout):
        self.mesh = mesh
        self.rules = rules
        self.param_layout = param_layout


# how the params of a context are held: the rank's blocks of
# ``dist.sharding.param_shardings(cfg, mesh, fsdp)`` with fsdp True
# ("fsdp") or False ("model"), or whole on every rank ("whole")
PARAM_LAYOUTS = ("fsdp", "model", "whole")


@contextmanager
def sharding_rules(mesh, rules: Optional[Dict[str, Rule]] = None, *,
                   param_layout: str = "fsdp"):
    """Activate a logical-axis sharding context (thread-local) whose
    params are held as ``param_layout`` says (``PARAM_LAYOUTS``)."""
    if param_layout not in PARAM_LAYOUTS:
        raise ValueError(f"param_layout {param_layout!r}, not one of "
                         f"{PARAM_LAYOUTS}")
    merged = default_rules(mesh)
    if rules:
        merged.update(rules)
    prev = getattr(_TLS, "ctx", None)
    _TLS.ctx = _Ctx(mesh, merged, param_layout)
    try:
        yield _TLS.ctx
    finally:
        _TLS.ctx = prev


def _current() -> Optional[_Ctx]:
    return getattr(_TLS, "ctx", None)


def current_mesh():
    ctx = _current()
    return ctx.mesh if ctx is not None else None


def param_layout() -> str:
    """How the context's params are held (``PARAM_LAYOUTS``)."""
    ctx = _current()
    return "fsdp" if ctx is None else ctx.param_layout


def get_rule(name: str) -> Rule:
    ctx = _current()
    if ctx is None:
        return None
    return ctx.rules.get(name)


def _axes_of(rule: Rule) -> Tuple[str, ...]:
    if rule is None:
        return ()
    return (rule,) if isinstance(rule, str) else tuple(rule)


def axis_size(name: str) -> int:
    """Product of mesh-axis sizes the logical axis maps to (1 outside a
    context)."""
    ctx = _current()
    if ctx is None:
        return 1
    n = 1
    for a in _axes_of(ctx.rules.get(name)):
        n *= ctx.mesh.shape[a]
    return n


def hint(x, *logical_axes):
    """The reference's sharding annotation: ``x`` itself.  Under a mesh
    each rank already holds its block, and a non-divisible dimension
    stays whole, as the reference leaves it unpinned."""
    return x
