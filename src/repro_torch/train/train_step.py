"""Training / prefill / decode step factories (port of
``repro/train/train_step.py``).

The loss is a cross-entropy computed in sequence chunks, each chunk's
float32 logits and log-sum-exp under ``torch.utils.checkpoint``, so that
full (B, S, V) logits are never live: for large vocabularies the logits
would otherwise dominate device memory.  The reference also hints the
logits' sharding (``dist.ctx.hint``), which the port drops (each rank
holds its block).  The step runs eagerly (the reference jits it); its
gradients flow through the model's kernels by their plain versions'
gradients (``kernels.backend.with_plain_grad``), and its metrics stay
on the device: the step reads nothing back to the host.

Under a ``dist.ctx.sharding_rules`` mesh the step is one program per
rank: the state holds the rank's blocks (``dist.sharding.param_shardings``
for params and moments), the step takes the global batch and keeps its
block over the data axes, and the model gathers each leaf at use.  The
backward of every collective is its transpose, so each rank's
gradients sum every rank's loss; a leaf gets its reduce-scatter from its
gather's backward, an ``all_reduce`` sum over the axes it is replicated
on, and a division by the rank count (the data axes for the mean, the
model axis because compute is replicated there).  ``grad_norm`` sums
each leaf's squares over the axes that shard it; the metrics are means
over the data axes.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.dist import ctx as dctx
from repro_torch.dist import smap
from repro_torch.models import (LMConfig, MoEParallel, decode_step, forward,
                                init_abstract, init_params, logits_fn)
from repro_torch.models.model import block_spec, head_weight
from repro_torch.optim import AdamWState, make_optimizer
from repro_torch.optim.adamw import _leaves, _unflatten


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    step: torch.Tensor   # () int32  (duplicate of opt.step; survives opt swaps)


def _chunk_loss(h_c: torch.Tensor, y_c: torch.Tensor,
                head: torch.Tensor) -> torch.Tensor:
    logits = (h_c @ head.to(h_c.dtype)).to(torch.float32)  # (B, c, V)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y_c[..., None].long())[..., 0]
    return torch.sum(lse - gold)


def chunked_ce_loss(params, cfg: LMConfig, hidden: torch.Tensor,
                    labels: torch.Tensor, n_chunks: int = 8) -> torch.Tensor:
    """Mean token cross-entropy, computed over sequence chunks.

    hidden: (B, S, D); labels: (B, S) int.  When autograd records, each
    chunk's logits are recomputed in the backward pass
    (``torch.utils.checkpoint``), bounding live logits to
    (B, S/n_chunks, V).
    """
    B, S, D = hidden.shape
    while S % n_chunks != 0:
        n_chunks -= 1
    c = S // n_chunks
    head = head_weight(params, cfg)
    remat = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n_chunks):
        args = (hidden[:, i * c:(i + 1) * c, :], labels[:, i * c:(i + 1) * c],
                head)
        total = total + (ckpt.checkpoint(_chunk_loss, *args,
                                         use_reentrant=False)
                         if remat else _chunk_loss(*args))
    return total / (B * S)


def make_train_step(cfg: LMConfig, optimizer=None,
                    moe_parallel: Optional[MoEParallel] = None,
                    aux_weight: float = 0.01, n_loss_chunks: int = 8):
    """Returns ``(train_step, optimizer)``; ``train_step(state, batch) ->
    (state, metrics)`` with the reference's metric keys (``loss``,
    ``ce``, ``aux``, ``grad_norm``, ``lr``) as 0-d device tensors.  A
    parameter the loss does not reach gets a zero gradient, as
    ``jax.value_and_grad`` gives it."""
    optimizer = optimizer or make_optimizer()

    def loss_fn(params, batch):
        h, aux = forward(params, cfg, batch["inputs"], moe_parallel)
        ce = chunked_ce_loss(params, cfg, h, batch["labels"], n_loss_chunks)
        loss = ce + (aux_weight * aux if cfg.is_moe else 0.0)
        return loss, {"ce": ce, "aux": aux}

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        mesh = dctx.current_mesh()
        if mesh is not None:
            from repro_torch.dist.sharding import train_batch_shardings
            batch = smap.put(batch, train_batch_shardings(cfg, mesh), mesh)
        leaves = [p.detach().requires_grad_()
                  for p in _leaves(state.params)]
        with torch.enable_grad():
            loss, parts = loss_fn(_unflatten(state.params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        kw = {}
        if mesh is not None:
            grads, kw["leaf_sq"] = _sync_grads(grads, state.params, cfg,
                                               mesh)
        new_params, new_opt, om = optimizer.update(
            _unflatten(state.params, grads), state.opt, state.params, **kw)
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in parts.items()}}
        if mesh is not None:
            from repro_torch.dist.sharding import batch_axes
            with torch.no_grad():
                metrics = {k: smap.pmean(v, batch_axes(mesh), mesh)
                           for k, v in metrics.items()}
        metrics.update(om)
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step, optimizer


def _paths(tree, path=()):
    """Leaf paths in ``_leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], path + (k,))]
    return [path]


def _sync_grads(grads, params, cfg: LMConfig, mesh):
    """Each leaf's gradient block of the mean loss, and the ``leaf_sq``
    that sums a leaf's squares over the axes that shard it."""
    out, shard_axes = [], []
    with torch.no_grad():
        for g, p, path in zip(grads, _leaves(params), _paths(params)):
            split = {a for e in block_spec(p, path, cfg, mesh)
                     for a in smap.spec_axes(e)}
            rest = tuple(a for a in mesh.axis_names if a not in split)
            if rest:
                g = smap.psum(g, rest, mesh)
            if mesh.size > 1:
                g = g / mesh.size
            out.append(g)
            shard_axes.append(tuple(a for a in mesh.axis_names if a in split))

    def leaf_sq(i, sq):
        return smap.psum(sq, shard_axes[i], mesh) if shard_axes[i] else sq
    return out, leaf_sq


def make_train_state_abstract(cfg: LMConfig, optimizer=None) -> TrainState:
    """The TrainState's shapes and dtypes on the ``meta`` device (no
    allocation, no draws)."""
    optimizer = optimizer or make_optimizer()
    p = init_abstract(cfg)
    return TrainState(p, optimizer.init(p),
                      torch.zeros((), dtype=torch.int32, device="meta"))


def make_train_state(cfg: LMConfig, generator=None, optimizer=None,
                     device=None) -> TrainState:
    """Parameters from ``init_params(cfg, generator, device)`` (a
    ``torch.Generator`` or an int seed; default device the CUDA card),
    zeroed optimizer state, step 0."""
    optimizer = optimizer or make_optimizer()
    p = init_params(cfg, generator, device=device)
    dev = _leaves(p)[0].device
    return TrainState(p, optimizer.init(p),
                      torch.zeros((), dtype=torch.int32, device=dev))


def make_prefill_step(cfg: LMConfig,
                      moe_parallel: Optional[MoEParallel] = None):
    """prefill_step(params, inputs) -> last-position logits (B, V).

    Runs the full forward and projects only the final position
    (production serving would also emit the KV cache; the compute and
    memory profile is the same)."""

    @torch.no_grad()
    def prefill_step(params, inputs):
        h, _ = forward(params, cfg, inputs, moe_parallel)
        return logits_fn(params, cfg, h[:, -1:, :])[:, 0, :]

    return prefill_step


def make_decode_fn(cfg: LMConfig):
    @torch.no_grad()
    def serve_step(params, state, tokens):
        return decode_step(params, cfg, state, tokens)
    return serve_step
