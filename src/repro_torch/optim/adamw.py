"""AdamW over trees of tensors, with optional low-precision moments.

Port of ``repro/optim/adamw.py``: plain functions over a (nested) dict,
list or tuple of tensors, with the reference's update rule — a clip by
the global norm, bias-corrected moments, and decoupled weight decay only
on tensors of two or more dimensions.  ``torch.optim.AdamW`` is not
this rule (it decays every tensor and does not clip), so the port keeps
its own.  ``state_dtype="bfloat16"`` halves the optimizer state; the
update math runs in float32 either way.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor          # () int32
    m: Any                      # tree like params
    v: Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree in the reference's pytree order (dict keys
    sorted), so the global norm sums its leaves in the same order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _unflatten(like, leaves):
    """A tree shaped like ``like`` (dict keys in its order) with
    ``leaves`` in ``_leaves`` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            vals = {k: build(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(like)


def _tree_map(fn, tree):
    return _unflatten(tree, [fn(x) for x in _leaves(tree)])


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Callable:
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        f = lambda v: torch.full((), v, dtype=torch.float32,
                                 device=step.device)
        # divisions by a tensor: a true float32 quotient on every device
        warm = base_lr * step / f(max(1.0, warmup))
        prog = torch.clamp((step - warmup) / f(max(1.0, total - warmup)),
                           0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return lr


def clip_by_global_norm(grads, max_norm: float, leaf_sq=None):
    """``(grads scaled to a global norm of at most max_norm, the norm)``;
    the norm is summed in float32 over the leaves in tree order.
    ``leaf_sq(i, s)``, when given, turns leaf ``i``'s sum of squares into
    the whole leaf's (under a mesh: a sum over the ranks that hold its
    other blocks)."""
    leaves = _leaves(grads)
    sq = [torch.sum(torch.square(g.to(torch.float32))) for g in leaves]
    if leaf_sq is not None:
        sq = [leaf_sq(i, s) for i, s in enumerate(sq)]
    gnorm = torch.sqrt(sum(sq))
    scale = torch.clamp(torch.full_like(gnorm, max_norm) / (gnorm + 1e-9),
                        max=1.0)
    return _tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                     grads), gnorm


def adamw_init(params, state_dtype: Optional[str] = None) -> AdamWState:
    def zeros(p):
        dt = getattr(torch, state_dtype) if state_dtype else p.dtype
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    dev = _leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=_tree_map(zeros, params),
                      v=_tree_map(zeros, params))


def adamw_update(grads, state: AdamWState, params, *, lr, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1, max_grad_norm: float = 1.0,
                 leaf_sq=None) -> Tuple[Any, AdamWState, dict]:
    """One AdamW step on a tree: returns ``(new params, new state,
    {"grad_norm", "lr"})``.  No gradient is recorded through it.
    ``leaf_sq``: see ``clip_by_global_norm`` (the train step's, under a
    mesh)."""
    with torch.no_grad():
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm, leaf_sq)
        step = state.step + 1
        stepf = step.to(torch.float32)
        lr_t = (lr(step) if callable(lr)
                else torch.tensor(lr, dtype=torch.float32,
                                  device=stepf.device))
        b1c = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=stepf.device), stepf)
        b2c = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=stepf.device), stepf)

        def upd(g, m, v, p):
            g32 = g.to(torch.float32)
            m32 = b1 * m.to(torch.float32) + (1 - b1) * g32
            v32 = b2 * v.to(torch.float32) + (1 - b2) * torch.square(g32)
            mhat = m32 / b1c
            vhat = v32 / b2c
            delta = mhat / (torch.sqrt(vhat) + eps)
            # decoupled weight decay only on >=2D tensors (skip norms and
            # scalars)
            if p.dim() >= 2:
                delta = delta + weight_decay * p.to(torch.float32)
            new_p = (p.to(torch.float32) - lr_t * delta).to(p.dtype)
            return new_p, m32.to(m.dtype), v32.to(v.dtype)

        out = [upd(g, m, v, p) for g, m, v, p in zip(
            _leaves(grads), _leaves(state.m), _leaves(state.v),
            _leaves(params))]
    new_p = _unflatten(params, [o[0] for o in out])
    new_m = _unflatten(params, [o[1] for o in out])
    new_v = _unflatten(params, [o[2] for o in out])
    return new_p, AdamWState(step, new_m, new_v), {"grad_norm": gnorm,
                                                   "lr": lr_t}


def make_optimizer(lr=3e-4, state_dtype: Optional[str] = None,
                   **kw) -> Optimizer:
    return Optimizer(
        init=lambda params: adamw_init(params, state_dtype),
        update=lambda grads, state, params, **k: adamw_update(
            grads, state, params, lr=lr, **kw, **k),
    )
