"""Unified decoder-LM model of the port covering every assigned family.

The port of ``repro/models/model.py``: one ``LMConfig`` describes dense /
MoE / SSM (Mamba-2) / hybrid (Hymba) decoder stacks; modality frontends
(audio frames, vision patches) are stubs, ``embed_inputs=False`` configs
taking precomputed ``(B, S, d_model)`` embeddings.  The layer stack is a
Python loop over the stacked leading axis of the params (the reference's
``lax.scan``).  When autograd records (training), ``cfg.remat`` applies
to each layer as the reference's ``jax.checkpoint`` policies do:
``"full"`` saves nothing inside a layer (``torch.utils.checkpoint``,
non-reentrant: ``nothing_saveable``), ``"dots"`` saves the outputs of the
plain matrix products (selective checkpointing:
``checkpoint_dots_with_no_batch_dims``); under ``torch.no_grad()``
(serving, decode) the layers run plainly.  Entry points
that make tensors (``init_params``, ``init_decode_state``) take
``device=`` and run on the CUDA card unless the caller names the CPU;
``init_abstract`` builds the tree on the ``meta`` device.  While tracing
is on (``obs.trace.tracing``) ``forward`` opens the span ``model.forward``
(a call id its children carry) over ``model.embed``, one ``model.layer``
a layer and ``model.final_norm``; ``logits_fn`` opens ``model.head``.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.dist import ctx as dctx
from repro_torch.dist import smap
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import layers as L
from repro_torch.obs.trace import span

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class MoEParallel:
    """How to run the MoE layer.

    mode="auto": ``moe_apply_local`` over every expert; under a live
    mesh the expert slabs are gathered whole and the tokens gathered over
    the data axes, so routing and capacity are the global batch's (the
    reference's global-math dispatch, exact), and each rank keeps its
    block of the output.  mode="shard_map": the reference's manual
    expert-parallel dispatch over ``mesh`` — experts sharded over
    ``model_axis``, expert weights FSDP-sharded over ``fsdp_axes`` and
    all-gathered per layer, tokens the rank's own (capacity from the
    local token count), partial outputs psum'd over the model axis; on
    one rank (``mesh=None`` or a 1 x 1 mesh) it is ``moe_apply_local``
    with ``expert_start=0``.
    """
    mode: str = "auto"
    model_axis: str = "model"
    fsdp_axes: Tuple[str, ...] = ()
    mesh: Any = None


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    block: str = "attn"               # "attn" | "ssm" | "hybrid"
    qk_norm: bool = False
    # sliding-window pattern, repeated over layers; 0 = global causal.
    # gemma3: (W,W,W,W,W,0) — 5 local : 1 global.
    window_pattern: Tuple[int, ...] = ()
    rope_theta: float = 1e4
    rope_theta_local: Optional[float] = None   # theta for windowed layers
    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # SSM
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    ssm_groups: int = 1
    # misc
    embed_inputs: bool = True         # False => frontend stub feeds embeddings
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    embed_scale: bool = False         # gemma sqrt(d_model) embedding multiplier
    max_seq_len: int = 131072
    param_dtype: str = "float32"
    activ_dtype: str = "float32"
    remat: str = "none"               # "none" | "full" | "dots"
    sub_quadratic: bool = False       # supports long_500k decode
    unroll_layers: bool = False       # fully unroll the layer scan (cost probes)
    block_local_attn: bool = False    # blocked O(S*W) sliding-window attention
    seq_parallel_attn: bool = False   # SP attention (TP-unfriendly head counts)
    kv_quant: bool = False            # int8 KV cache w/ per-token-head scales

    @property
    def local_block(self) -> int:
        if not self.block_local_attn or not self.window_pattern:
            return 0
        locals_ = [w for w in self.window_pattern if w > 0]
        return max(locals_) if locals_ else 0

    # ------------------------------------------------------------------
    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def adtype(self) -> torch.dtype:
        return _DTYPES[self.activ_dtype]

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def has_attn(self) -> bool:
        return self.block in ("attn", "hybrid")

    @property
    def has_ssm(self) -> bool:
        return self.block in ("ssm", "hybrid")

    @property
    def has_ffn(self) -> bool:
        return self.d_ff > 0 or self.is_moe

    @property
    def ssm_dims(self) -> L.SSMDims:
        # as in the reference, ssm_groups is not passed: n_groups is 1
        return L.ssm_dims(self.d_model, self.ssm_state, self.ssm_head_dim,
                          self.ssm_expand, self.ssm_chunk)

    def layer_windows(self) -> torch.Tensor:
        if not self.window_pattern:
            return torch.zeros((self.n_layers,), dtype=torch.int32)
        pat = list(self.window_pattern)
        reps = (self.n_layers + len(pat) - 1) // len(pat)
        return torch.tensor((pat * reps)[: self.n_layers], dtype=torch.int32)

    def layer_thetas(self) -> torch.Tensor:
        w = self.layer_windows()
        local_theta = self.rope_theta_local or self.rope_theta
        return torch.where(w > 0, torch.tensor(local_theta, dtype=torch.float32),
                           torch.tensor(self.rope_theta, dtype=torch.float32))

    def param_count(self) -> int:
        """Analytic parameter count (for roofline MODEL_FLOPS)."""
        d, V = self.d_model, self.vocab_size
        n = 0
        if self.embed_inputs:
            n += V * d
        if not self.tie_embeddings:
            n += d * V
        per_layer = d  # ln1
        if self.has_attn:
            per_layer += d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head
            per_layer += self.n_heads * self.d_head * d
            if self.qk_norm:
                per_layer += 2 * self.d_head
        if self.has_ssm:
            sd = self.ssm_dims
            d_in = 2 * sd.d_inner + 2 * sd.n_groups * sd.d_state + sd.n_heads
            conv_dim = sd.d_inner + 2 * sd.n_groups * sd.d_state
            per_layer += d * d_in + sd.d_conv * conv_dim + conv_dim
            per_layer += 3 * sd.n_heads + sd.d_inner + sd.d_inner * d
        if self.has_ffn:
            per_layer += d  # ln2
            if self.is_moe:
                per_layer += d * self.n_experts
                per_layer += self.n_experts * 3 * d * self.d_ff
                per_layer += self.n_shared_experts * 3 * d * self.d_ff
            else:
                per_layer += 3 * d * self.d_ff
        n += self.n_layers * per_layer + d  # + final norm
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        inactive = self.n_layers * (self.n_experts - self.moe_top_k) * 3 * d * self.d_ff
        return self.param_count() - inactive


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def _generator(generator: Union[torch.Generator, int, None],
               device) -> torch.Generator:
    """A generator on ``device``: the one given (which must live there;
    ``device`` defaults to its own), or a new one seeded with the int
    given (0 for None)."""
    if isinstance(generator, torch.Generator):
        dev = resolve_device(generator.device if device is None else device)
        if generator.device.type != dev.type:
            raise ValueError(f"generator on {generator.device}, parameters "
                             f"on {dev}")
        return generator
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0 if generator is None else int(generator))
    return gen


def _init_layer(gen, cfg: LMConfig) -> Params:
    dt, dev = cfg.pdtype, gen.device
    p: Params = {"ln1": L.init_rmsnorm(cfg.d_model, dt, dev)}
    if cfg.has_attn:
        p["attn"] = L.init_attention(gen, cfg.d_model, cfg.n_heads,
                                     cfg.n_kv_heads, cfg.d_head, cfg.qk_norm,
                                     dt)
    if cfg.has_ssm:
        p["ssm"] = L.init_ssm(gen, cfg.ssm_dims, dt)
        if cfg.block == "hybrid":
            p["mix"] = torch.full((2,), 0.5, dtype=torch.float32, device=dev)
    if cfg.has_ffn:
        p["ln2"] = L.init_rmsnorm(cfg.d_model, dt, dev)
        if cfg.is_moe:
            p["moe"] = L.init_moe(gen, cfg.d_model, cfg.n_experts, cfg.d_ff,
                                  cfg.n_shared_experts, dt)
        else:
            p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, dt)
    return p


def init_layer(generator, cfg: LMConfig, device=None) -> Params:
    return _init_layer(_generator(generator, device), cfg)


def _stacked_like(tree, n: int):
    """A stack of ``n`` trees shaped as ``tree``: ``tree`` itself as a
    view for one, else empty leaves with a leading axis of ``n``."""
    if isinstance(tree, dict):
        return {k: _stacked_like(v, n) for k, v in tree.items()}
    return tree.unsqueeze(0) if n == 1 else tree.new_empty((n, *tree.shape))


def _put(stack, tree, i: int) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _put(stack[k], v, i)
    else:
        stack[i].copy_(tree)


def _init_layers(gen, cfg: LMConfig) -> Params:
    """The layers' parameters stacked on a leading axis: the layers drawn
    one after another, each copied into the stack as soon as it is drawn,
    so that one layer's tree is alive beside the stack (``torch.stack``
    of all the trees would hold every layer twice)."""
    n = cfg.n_layers
    layer = _init_layer(gen, cfg)
    stack = _stacked_like(layer, n)
    if n == 1:
        return stack
    for i in range(n):
        if i > 0:
            layer = _init_layer(gen, cfg)
        _put(stack, layer, i)
        del layer
    return stack


def _init_params(cfg: LMConfig, gen) -> Params:
    p: Params = {}
    if cfg.embed_inputs:
        p["embed"] = L._embed_init(gen, (cfg.vocab_size, cfg.d_model),
                                   cfg.pdtype)
    p["layers"] = _init_layers(gen, cfg)
    p["final_norm"] = L.init_rmsnorm(cfg.d_model, cfg.pdtype, gen.device)
    if not cfg.tie_embeddings:
        p["lm_head"] = L._dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                     cfg.pdtype)
    return p


def init_params(cfg: LMConfig, generator=None, device=None) -> Params:
    """Parameters with the reference's tree, shapes and dtypes, the layers
    stacked on a leading axis.  ``generator``: a ``torch.Generator`` on
    ``device`` or an int seed (default 0); ``device`` defaults to CUDA."""
    return _init_params(cfg, _generator(generator, device))


def init_abstract(cfg: LMConfig) -> Params:
    """Shape/dtype skeleton of the params on the ``meta`` device (no
    allocation, no draws): the reference's ``init_abstract``."""
    return _init_params(cfg, L.Abstract())


def _layer(params: Params, i: int) -> Params:
    """Layer ``i``'s parameters: views into the stacked tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in params.items()}


def _unstack(params: Params, n: int) -> list:
    """Every layer's parameters, views into the stacked tree from one
    ``torch.unbind`` a leaf.  Its backward stacks the layers' gradients
    once; indexing each layer (``_layer``) would scatter each layer's
    gradient into a zeroed copy of the whole stack and sum n of them."""
    if isinstance(params, dict):
        parts = {k: _unstack(v, n) for k, v in params.items()}
        return [{k: parts[k][i] for k in params} for i in range(n)]
    return list(torch.unbind(params))


# ---------------------------------------------------------------------------
# Mesh: each rank holds blocks of the leaves, gathered at use
# ---------------------------------------------------------------------------
#
# Under a ``dist.ctx.sharding_rules`` context the params are the rank's
# blocks, laid out by ``dist.sharding.param_shardings`` (``dist.smap.put``),
# or whole, as the context's ``param_layout`` says, and the activations
# the rank's batch block.  A leaf is gathered whole right before use, over the axes its
# spec gives each dimension (the gather's backward is a summing
# reduce-scatter); compute over the "model" axis stays replicated.  A group of one rank skips its
# collective, so a 1 x 1 mesh is bit-equal to no mesh.


def block_spec(t: torch.Tensor, path: Tuple[str, ...], cfg: LMConfig,
               mesh, stacked: bool = False) -> tuple:
    """The spec of the rank's block ``t`` of leaf ``path`` (a layer's
    slice when ``stacked``) under the context's layout
    (``dist.sharding.leaf_specs``); raises where ``t`` is not that
    block."""
    from repro_torch.dist.sharding import leaf_specs
    spec, gshape = leaf_specs(cfg, mesh, dctx.param_layout())[path]
    spec = tuple(spec) + (None,) * (len(gshape) - len(spec))
    if stacked:
        gshape, spec = gshape[1:], spec[1:]
    if tuple(t.shape) != smap.local_shape(gshape, spec, mesh):
        raise ValueError(f"{'/'.join(path)}: {tuple(t.shape)} is not the "
                         f"rank's block of {gshape} laid out {spec} on "
                         f"{mesh}")
    return spec


def _gather_leaf(t: torch.Tensor, path: Tuple[str, ...], cfg: LMConfig,
                 mesh, stacked: bool = False) -> torch.Tensor:
    return smap.unshard(t, block_spec(t, path, cfg, mesh, stacked), mesh)


def _gather_tree(tree: Params, cfg: LMConfig, mesh, path: Tuple[str, ...],
                 stacked: bool, skip=()) -> Params:
    out = {}
    for k, v in tree.items():
        if k in skip:
            out[k] = v
        elif isinstance(v, dict):
            out[k] = _gather_tree(v, cfg, mesh, path + (k,), stacked)
        else:
            out[k] = _gather_leaf(v, path + (k,), cfg, mesh, stacked)
    return out


def _gather_layer(lp: Params, cfg: LMConfig, mesh,
                  moe_parallel: Optional[MoEParallel]) -> Params:
    """A layer's leaves, whole, under ``mesh`` (the expert-parallel MoE
    gathers its own slabs)."""
    if mesh is None:
        return lp
    skip = ("moe",) if cfg.is_moe and _expert_parallel(moe_parallel) else ()
    return _gather_tree(lp, cfg, mesh, ("layers",), True, skip)


def top_leaf(params: Params, cfg: LMConfig, key: str) -> torch.Tensor:
    """A top-level entry (``embed``, ``lm_head``, the ``final_norm``
    tree), whole under the context's mesh."""
    mesh = dctx.current_mesh()
    t = params[key]
    if mesh is None:
        return t
    if isinstance(t, dict):
        return _gather_tree(t, cfg, mesh, (key,), False)
    return _gather_leaf(t, (key,), cfg, mesh)


def head_weight(params: Params, cfg: LMConfig) -> torch.Tensor:
    """The (d_model, vocab) output projection, whole."""
    return (top_leaf(params, cfg, "embed").T if cfg.tie_embeddings
            else top_leaf(params, cfg, "lm_head"))


def _expert_parallel(par: Optional[MoEParallel]) -> bool:
    if par is None:
        return False
    if par.mode not in ("auto", "shard_map"):
        raise ValueError(f"MoEParallel.mode {par.mode!r}")
    return par.mode == "shard_map" and par.mesh is not None


def _block_of(t: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size)


def _moe_shard_map(mp: Params, x2: torch.Tensor, cfg: LMConfig,
                   par: MoEParallel):
    """Expert-parallel MoE on the rank's tokens ``x2`` (T_local, D):
    experts sharded over the model axis (``e_local = E / n_model`` from
    ``expert_start = axis_index x e_local``), expert slabs gathered over
    ``fsdp_axes`` (axis 2 of w_gate / w_up, axis 1 of w_down), capacity
    from the local token count, the partial outputs psum'd over the model
    axis and the aux loss pmean'd over every axis.  ``mp`` holds the
    rank's blocks (``param_shardings``); a layout other than ``par``'s
    raises."""
    mesh = par.mesh
    model_ax = par.model_axis
    fsdp = tuple(par.fsdp_axes)
    n_model = mesh.shape[model_ax]
    if cfg.n_experts % n_model:
        raise ValueError(f"{cfg.n_experts} experts over {n_model} ranks")
    e_local = cfg.n_experts // n_model
    m_idx = smap.axis_index(model_ax, mesh)
    capacity = moe_capacity(cfg, x2.shape[0])

    def slab(name):
        """The rank's experts of a slab, whole over d_ff."""
        w = mp[name]
        spec = tuple(smap.spec_axes(e) for e in block_spec(
            w, ("layers", "moe", name), cfg, mesh, True))
        if (spec[0] != ((model_ax,) if n_model > 1 else ())
                or any(e not in ((), fsdp) for e in spec[1:])):
            raise ValueError(f"moe/{name}: laid out {spec}, not experts "
                             f"over {model_ax!r} and d_ff over {fsdp}")
        return smap.unshard(w, (None,) + spec[1:], mesh)

    def f(x_l, router, wg, wu, wd, shared):
        start = m_idx * e_local
        params = {"router": router, "w_gate": wg, "w_up": wu, "w_down": wd}
        if shared is not None:
            # the reference's P(None, model) / P(model, None) blocks of
            # the whole shared MLP: this rank's d_ff columns
            params["shared"] = {
                "w_gate": _block_of(shared["w_gate"], 1, n_model, m_idx),
                "w_up": _block_of(shared["w_up"], 1, n_model, m_idx),
                "w_down": _block_of(shared["w_down"], 0, n_model, m_idx)}
        y, aux = L.moe_apply_local(params, x_l, top_k=cfg.moe_top_k,
                                   capacity=capacity, n_experts=cfg.n_experts,
                                   expert_start=start, n_local_experts=e_local)
        y = smap.psum(y, model_ax)
        aux = smap.pmean(aux, mesh.axis_names)
        return y, aux

    shared = mp.get("shared")
    if shared is not None:
        shared = _gather_tree(shared, cfg, mesh, ("layers", "moe", "shared"),
                              True)
    router = _gather_leaf(mp["router"], ("layers", "moe", "router"), cfg,
                          mesh, True)
    return smap.shard_map(f, mesh=mesh)(
        x2, router, slab("w_gate"), slab("w_up"), slab("w_down"), shared)


def _moe_global(mp: Params, hn: torch.Tensor, cfg: LMConfig, mesh):
    """The auto-mode MoE under a mesh: the tokens gathered over the data
    axes, routed with the global batch's capacity, the rank's block of
    the output kept."""
    from repro_torch.dist.sharding import batch_axes
    B, S, D = hn.shape
    x = hn.reshape(B * S, D)
    data = batch_axes(mesh)
    n = mesh.group_size(data)
    if n > 1:
        x = smap.all_gather(x, data, axis=0, mesh=mesh)
    y, aux = L.moe_apply_local(mp, x, top_k=cfg.moe_top_k,
                               capacity=moe_capacity(cfg, x.shape[0]),
                               n_experts=cfg.n_experts)
    if n > 1:
        y = _block_of(y, 0, n, smap.axis_index(data, mesh))
    return y, aux


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------


def _attend(lp: Params, hn: torch.Tensor, cfg: LMConfig, window: int,
            theta: float, **cache):
    return L.attention(lp["attn"], hn, n_heads=cfg.n_heads,
                       n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
                       theta=theta, window=window, qk_norm=cfg.qk_norm,
                       eps=cfg.norm_eps, **cache)[0]


def _ffn(lp: Params, h: torch.Tensor, cfg: LMConfig,
         moe_parallel: Optional[MoEParallel],
         capacity: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """h plus the layer's feed-forward block, and the MoE aux loss (None
    without experts)."""
    hn = L.rmsnorm(lp["ln2"], h, cfg.norm_eps)
    if not cfg.is_moe:
        return h + L.mlp(lp["mlp"], hn), None
    B, S, D = hn.shape
    mesh = dctx.current_mesh()
    if _expert_parallel(moe_parallel):
        y2, aux = _moe_shard_map(lp["moe"], hn.reshape(B * S, D), cfg,
                                 moe_parallel)
    elif mesh is not None:
        y2, aux = _moe_global(lp["moe"], hn, cfg, mesh)
    else:
        y2, aux = L.moe_apply_local(lp["moe"], hn.reshape(B * S, D),
                                    top_k=cfg.moe_top_k, capacity=capacity,
                                    n_experts=cfg.n_experts)
    return h + y2.reshape(B, S, D), aux


def _layer_forward(lp: Params, h: torch.Tensor, cfg: LMConfig, window: int,
                   theta: float, moe_parallel: Optional[MoEParallel],
                   capacity: int):
    lp = _gather_layer(lp, cfg, dctx.current_mesh(), moe_parallel)
    hn = L.rmsnorm(lp["ln1"], h, cfg.norm_eps)
    if cfg.has_attn and cfg.has_ssm:       # hybrid: parallel attn + ssm heads
        ao = _attend(lp, hn, cfg, window, theta)
        so = L.ssm_apply(lp["ssm"], cfg.ssm_dims, hn)
        mix = lp["mix"].to(h.dtype)
        h = h + mix[0] * ao + mix[1] * so
    elif cfg.has_attn:
        h = h + _attend(lp, hn, cfg, window, theta)
    else:                                  # pure SSM
        h = h + L.ssm_apply(lp["ssm"], cfg.ssm_dims, hn)
    aux = None
    if cfg.has_ffn:
        h, aux = _ffn(lp, h, cfg, moe_parallel, capacity)
    return h, aux


def _save_plain_products(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the outputs of matrix products without
    a batch dimension (``aten.mm``; ``torch.matmul`` of a (B, S, D)
    activation by a weight reaches it), recompute everything else."""
    if op is torch.ops.aten.mm.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(policy: str, fn, *args):
    """``fn(*args)`` under the remat ``policy`` of the config."""
    if policy == "full":
        return ckpt.checkpoint(fn, *args, use_reentrant=False)
    if policy == "dots":
        return ckpt.checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts,
                _save_plain_products))
    raise ValueError(f"remat {policy!r}: 'none', 'full' or 'dots'")


def moe_capacity(cfg: LMConfig, n_tokens: int) -> int:
    """Per-expert token capacity for a global token count (static)."""
    if not cfg.is_moe:
        return 0
    cap = int(math.ceil(n_tokens * cfg.moe_top_k * cfg.capacity_factor
                        / cfg.n_experts))
    return max(8, ((cap + 7) // 8) * 8)


def _embed(params: Params, cfg: LMConfig, inputs: torch.Tensor) -> torch.Tensor:
    adt = cfg.adtype
    if cfg.embed_inputs:
        h = top_leaf(params, cfg, "embed").to(adt)[inputs]
    else:
        h = inputs.to(adt)
    if cfg.embed_scale:
        # sqrt(d_model) rounded to the activation dtype, as a host scalar
        # (a tensor made on the card would copy from the host and wait)
        h = h * float(torch.tensor(math.sqrt(cfg.d_model), dtype=adt))
    return h


_forward_calls = itertools.count()   # the call id of ``model.forward``


def forward(params: Params, cfg: LMConfig, inputs: torch.Tensor,
            moe_parallel: Optional[MoEParallel] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> final hidden states (B, S, D), aux loss
    (the MoE load-balancing loss summed over layers over ``n_layers``).

    ``inputs``: (B, S) integer token ids when cfg.embed_inputs else
    (B, S, d_model) precomputed embeddings (frontend stub).  The tensors
    run where the params lie.
    """
    with span("model.forward", call=next(_forward_calls)):
        with span("model.embed"):
            h = _embed(params, cfg, inputs)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        capacity = moe_capacity(cfg, h.shape[0] * h.shape[1])
        windows = cfg.layer_windows().tolist()
        thetas = cfg.layer_thetas().tolist()
        remat = cfg.remat != "none" and torch.is_grad_enabled()
        layers = _unstack(params["layers"], cfg.n_layers)
        for i in range(cfg.n_layers):
            args = (layers[i], h, cfg, windows[i], thetas[i], moe_parallel,
                    capacity)
            with span("model.layer", layer=i):
                h, aux_l = (_remat(cfg.remat, _layer_forward, *args) if remat
                            else _layer_forward(*args))
                if aux_l is not None:
                    aux = aux + aux_l
        with span("model.final_norm"):
            h = L.rmsnorm(top_leaf(params, cfg, "final_norm"), h,
                          cfg.norm_eps)
        return h, aux / cfg.n_layers


def logits_fn(params: Params, cfg: LMConfig,
              hidden: torch.Tensor) -> torch.Tensor:
    with span("model.head"):
        return hidden @ head_weight(params, cfg).to(hidden.dtype)


# ---------------------------------------------------------------------------
# KV / state caches for decode
# ---------------------------------------------------------------------------


class DecodeState(NamedTuple):
    """Stacked per-layer decode caches. Unused members are size-0 tensors."""
    k_cache: torch.Tensor      # (L, B, max_seq, n_kv, d_head)
    v_cache: torch.Tensor
    k_scale: torch.Tensor      # (L, B, max_seq, n_kv) — int8 KV quant scales
    v_scale: torch.Tensor      #   (size-0 when kv_quant is off)
    conv_state: torch.Tensor   # (L, B, d_conv-1, conv_dim)
    ssm_state: torch.Tensor    # (L, B, H, P, N)
    length: torch.Tensor       # () int32 — tokens already in cache


def init_decode_state(cfg: LMConfig, batch: int, max_seq: int,
                      dtype=torch.bfloat16, length: int = 0,
                      device=None) -> DecodeState:
    """Zeroed caches for ``batch`` sequences of up to ``max_seq`` tokens,
    ``length`` of them taken.  The KV caches hold ``max_seq`` slots, or
    the largest window when no layer is global; ``dtype`` is theirs (int8
    with float32 scales under ``kv_quant``) and the conv state's.
    ``device``: CUDA by default, the CPU, or ``meta`` for shapes only."""
    dev = L._param_device(device)
    Lx = cfg.n_layers
    if cfg.kv_quant:
        dtype = torch.int8
    kv_len = 0
    if cfg.has_attn:
        kv_len = max_seq
        if cfg.window_pattern and not any(w == 0 for w in cfg.window_pattern):
            kv_len = min(max_seq, max(cfg.window_pattern))
    k = torch.zeros((Lx, batch, kv_len, cfg.n_kv_heads, cfg.d_head),
                    dtype=dtype, device=dev)
    v = torch.zeros_like(k)
    if cfg.kv_quant and cfg.has_attn:
        ks = torch.ones((Lx, batch, kv_len, cfg.n_kv_heads),
                        dtype=torch.float32, device=dev)
    else:
        ks = torch.zeros((Lx, batch, 0, 0), dtype=torch.float32, device=dev)
    vs = torch.ones_like(ks)
    if cfg.has_ssm:
        sd = cfg.ssm_dims
        conv_dim = sd.d_inner + 2 * sd.n_groups * sd.d_state
        cdt = torch.bfloat16 if cfg.kv_quant else dtype
        conv = torch.zeros((Lx, batch, sd.d_conv - 1, conv_dim), dtype=cdt,
                           device=dev)
        ssm = torch.zeros((Lx, batch, sd.n_heads, sd.head_dim, sd.d_state),
                          dtype=torch.float32, device=dev)
    else:
        conv = torch.zeros((Lx, batch, 0, 0), dtype=dtype, device=dev)
        ssm = torch.zeros((Lx, batch, 0, 0, 0), dtype=torch.float32,
                          device=dev)
    return DecodeState(k, v, ks, vs, conv, ssm,
                       torch.tensor(length, dtype=torch.int32, device=dev))


def decode_step(params: Params, cfg: LMConfig, state: DecodeState,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, DecodeState]:
    """One decode step.  tokens: (B,) integer ids (or (B, d_model)
    embeddings for stub-frontend configs).  Returns (logits (B, V), new
    state).  The state's KV caches (and int8 scales) are written IN
    PLACE, layer by layer through views of their stacked tensors, as the
    reference's donated buffers are: the new state holds the same K/V
    tensors.  Its conv and SSM states and its length are new tensors;
    the given ones are not modified."""
    h = _embed(params, cfg, tokens)[:, None, :]            # (B,1,D)
    windows = cfg.layer_windows().tolist()
    thetas = cfg.layer_thetas().tolist()
    capacity = moe_capacity(cfg, h.shape[0])
    pos = state.length
    convs, ssms = [], []
    mesh = dctx.current_mesh()
    for i in range(cfg.n_layers):
        lp = _gather_layer(_layer(params["layers"], i), cfg, mesh, None)
        hn = L.rmsnorm(lp["ln1"], h, cfg.norm_eps)
        if cfg.has_attn:
            kv = (state.k_cache[i], state.v_cache[i])
            if cfg.kv_quant:
                kv += (state.k_scale[i], state.v_scale[i])
            ao = _attend(lp, hn, cfg, windows[i], thetas[i], kv_cache=kv,
                         cache_len=pos)
        if cfg.has_ssm:
            so, conv, ssm = L.ssm_step(lp["ssm"], cfg.ssm_dims, hn[:, 0, :],
                                       state.conv_state[i],
                                       state.ssm_state[i])
            convs.append(conv)
            ssms.append(ssm)
        if cfg.has_attn and cfg.has_ssm:
            mix = lp["mix"].to(h.dtype)
            h = h + mix[0] * ao + mix[1] * so[:, None, :]
        elif cfg.has_attn:
            h = h + ao
        else:
            h = h + so[:, None, :]
        if cfg.has_ffn:
            h, _ = _ffn(lp, h, cfg, None, capacity)
    h = L.rmsnorm(top_leaf(params, cfg, "final_norm"), h, cfg.norm_eps)
    logits = logits_fn(params, cfg, h)[:, 0, :]
    conv_state, ssm_state = ((torch.stack(convs), torch.stack(ssms))
                             if cfg.has_ssm else
                             (state.conv_state, state.ssm_state))
    new_state = DecodeState(state.k_cache, state.v_cache, state.k_scale,
                            state.v_scale, conv_state, ssm_state,
                            state.length + 1)
    return logits, new_state
