"""The model's weights, drawn on the device from the run's seed.

The tree is the one ``repro_torch.models.init_abstract(cfg)`` describes
(shapes and dtypes on the ``meta`` device); the benchmark fills it
itself, in each leaf's published initialisation range as the
configuration file's ``init`` rules state it, each rule's distribution
a file of its own (``init/<dist>.py``).  Every leaf is a view into
one flat buffer per dtype, laid out rule by rule, so that each rule is
one draw over all the leaves it covers (stacked over the layers) in the
type the weights are served in: a few large calls on the card, nothing
on the host.  The same tensors go to the program and to the reference.
"""

from __future__ import annotations

import fnmatch
from typing import Dict, List, Tuple

import torch

from pbharness import files

ALIGN = 256  # bytes; every leaf starts on a 256-byte boundary


def leaves(tree, prefix="") -> List[Tuple[str, torch.Tensor]]:
    out = []
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out += leaves(v, path + "/")
        else:
            out.append((path, v))
    return out


def rule_for(path: str, rules: List[dict]) -> int:
    for i, r in enumerate(rules):
        if any(fnmatch.fnmatchcase(path, pat) for pat in r["leaves"]):
            return i
    raise KeyError(f"no init rule covers leaf {path!r}")


def _set(tree, path: str, value) -> None:
    *head, last = path.split("/")
    for k in head:
        tree = tree[k]
    tree[last] = value


def allocate(abstract: dict, rules: List[dict], device) -> Tuple[dict, list]:
    """A tree shaped as ``abstract`` whose leaves are views into one flat
    buffer per dtype, each rule's leaves side by side; returns it and the
    draw plan: ``(rule, flat view, the rule's leaves)`` per (dtype,
    rule)."""
    tree = _copy(abstract)
    by_dtype: Dict[torch.dtype, List[Tuple[int, str, torch.Tensor]]] = {}
    for path, t in leaves(abstract):
        by_dtype.setdefault(t.dtype, []).append((rule_for(path, rules), path, t))
    plan = []
    for dtype, items in by_dtype.items():
        items.sort(key=lambda it: it[0])
        step = ALIGN // torch.empty((), dtype=dtype).element_size()
        offsets, off = [], 0
        for _, _, t in items:
            offsets.append(off)
            off += -(-t.numel() // step) * step
        flat = torch.empty((off,), dtype=dtype, device=device)
        spans: Dict[int, List[int]] = {}
        views: Dict[int, List[torch.Tensor]] = {}
        for (ri, path, t), o in zip(items, offsets):
            view = flat[o:o + t.numel()].view(t.shape)
            _set(tree, path, view)
            views.setdefault(ri, []).append(view)
            lo_hi = spans.setdefault(ri, [o, o + t.numel()])
            lo_hi[1] = o + t.numel()
        for ri, (lo, hi) in sorted(spans.items()):
            plan.append((rules[ri], flat[lo:hi], views[ri]))
    return tree, plan


def _copy(tree):
    return {k: _copy(v) if isinstance(v, dict) else v for k, v in tree.items()}


def draw(plan: list, seed: int, device) -> None:
    """Fill every buffer of ``plan`` from ``seed``: one draw a rule.  A
    rule's ``column_scale`` (a list as long as its leaves' last axis, such
    as a router's experts) then multiplies each column of its leaves."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    for rule, buf, views in plan:
        fill(rule, buf, gen)
        if "column_scale" in rule:
            for v in views:
                v.mul_(torch.tensor(rule["column_scale"], dtype=v.dtype,
                                    device=v.device))


def fill(rule: dict, buf: torch.Tensor, gen: torch.Generator) -> None:
    """One rule's draw: ``init/<rule["dist"]>.py``'s ``fill``."""
    files.load_module("init", rule["dist"]).fill(rule, buf, gen)


def make(abstract: dict, rules: List[dict], seed: int, device):
    """The weights for ``seed``, and the plan to redraw them in place."""
    tree, plan = allocate(abstract, rules, device)
    draw(plan, seed, device)
    return tree, plan
