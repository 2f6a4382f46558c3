"""Decoder-LM model of the port: the pure-SSM (Mamba-2) family.

The port of ``repro/models/model.py``.  ``LMConfig`` is the reference's
whole; the functions take its pure-SSM branch, and a config with
attention or a feed-forward block raises ``NotImplementedError`` (those
layers come with ROADMAP Queue A item 1).  The layer stack is a Python
loop over the stacked leading axis of the params (the reference's
``lax.scan``), with no remat: it matters only for training.  Entry points
that make tensors (``init_params``, ``init_decode_state``) take
``device=`` and run on the CUDA card unless the caller names the CPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.kernels.backend import resolve_device
from repro_torch.models import layers as L

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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


def _require_pure_ssm(cfg: LMConfig) -> None:
    if cfg.has_attn or cfg.has_ffn or not cfg.has_ssm:
        raise NotImplementedError(
            f"repro_torch.models runs the pure-SSM family only; {cfg.name} "
            f"(block={cfg.block!r}, d_ff={cfg.d_ff}, n_experts="
            f"{cfg.n_experts}) needs the attention, MLP or MoE layers of "
            f"ROADMAP Queue A item 1")


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


def init_layer(generator, cfg: LMConfig, device=None) -> Params:
    _require_pure_ssm(cfg)
    gen = _generator(generator, device)
    dt = cfg.pdtype
    return {"ln1": L.init_rmsnorm(cfg.d_model, dt, gen.device),
            "ssm": L.init_ssm(gen, cfg.ssm_dims, dt)}


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(cfg: LMConfig, generator=None, device=None) -> Params:
    """Parameters with the reference's tree, shapes and dtypes, the layers
    stacked on a leading axis.  ``generator``: a ``torch.Generator`` on
    ``device`` or an int seed (default 0); ``device`` defaults to CUDA."""
    _require_pure_ssm(cfg)
    gen = _generator(generator, device)
    p: Params = {}
    if cfg.embed_inputs:
        p["embed"] = L._embed_init(gen, (cfg.vocab_size, cfg.d_model),
                                   cfg.pdtype)
    p["layers"] = _stack([init_layer(gen, cfg) for _ in range(cfg.n_layers)])
    p["final_norm"] = L.init_rmsnorm(cfg.d_model, cfg.pdtype, gen.device)
    if not cfg.tie_embeddings:
        p["lm_head"] = L._dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                     cfg.pdtype)
    return p


def _layer(params: Params, i: int) -> Params:
    """Layer ``i``'s parameters: views into the stacked tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in params.items()}


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------


def _embed(params: Params, cfg: LMConfig, inputs: torch.Tensor) -> torch.Tensor:
    adt = cfg.adtype
    if cfg.embed_inputs:
        h = params["embed"].to(adt)[inputs]
    else:
        h = inputs.to(adt)
    if cfg.embed_scale:
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=adt,
                             device=h.device)
    return h


def forward(params: Params, cfg: LMConfig,
            inputs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> final hidden states (B, S, D), aux loss
    (0 for the pure-SSM family).

    ``inputs``: (B, S) integer token ids when cfg.embed_inputs else
    (B, S, d_model) precomputed embeddings (frontend stub).  The tensors
    run where the params lie.
    """
    _require_pure_ssm(cfg)
    h = _embed(params, cfg, inputs)
    dims = cfg.ssm_dims
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        hn = L.rmsnorm(lp["ln1"], h, cfg.norm_eps)
        h = h + L.ssm_apply(lp["ssm"], dims, hn)
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h, aux / cfg.n_layers


def logits_fn(params: Params, cfg: LMConfig,
              hidden: torch.Tensor) -> torch.Tensor:
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    return hidden @ head.to(hidden.dtype)


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
    _require_pure_ssm(cfg)
    dev = resolve_device(device)
    Lx = cfg.n_layers
    if cfg.kv_quant:
        dtype = torch.int8
    k = torch.zeros((Lx, batch, 0, cfg.n_kv_heads, cfg.d_head), dtype=dtype,
                    device=dev)
    v = torch.zeros_like(k)
    ks = torch.zeros((Lx, batch, 0, 0), dtype=torch.float32, device=dev)
    vs = torch.zeros_like(ks)
    sd = cfg.ssm_dims
    conv_dim = sd.d_inner + 2 * sd.n_groups * sd.d_state
    cdt = torch.bfloat16 if cfg.kv_quant else dtype
    conv = torch.zeros((Lx, batch, sd.d_conv - 1, conv_dim), dtype=cdt,
                       device=dev)
    ssm = torch.zeros((Lx, batch, sd.n_heads, sd.head_dim, sd.d_state),
                      dtype=torch.float32, device=dev)
    return DecodeState(k, v, ks, vs, conv, ssm,
                       torch.tensor(length, dtype=torch.int32, device=dev))


def decode_step(params: Params, cfg: LMConfig, state: DecodeState,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, DecodeState]:
    """One decode step.  tokens: (B,) integer ids (or (B, d_model)
    embeddings for stub-frontend configs).  Returns (logits (B, V), new
    state); the state given is not modified."""
    _require_pure_ssm(cfg)
    h = _embed(params, cfg, tokens)[:, None, :]            # (B,1,D)
    dims = cfg.ssm_dims
    convs, ssms = [], []
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        hn = L.rmsnorm(lp["ln1"], h, cfg.norm_eps)
        so, conv, ssm = L.ssm_step(lp["ssm"], dims, hn[:, 0, :],
                                   state.conv_state[i], state.ssm_state[i])
        h = h + so[:, None, :]
        convs.append(conv)
        ssms.append(ssm)
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    logits = logits_fn(params, cfg, h)[:, 0, :]
    new_state = DecodeState(state.k_cache, state.v_cache, state.k_scale,
                            state.v_scale, torch.stack(convs),
                            torch.stack(ssms), state.length + 1)
    return logits, new_state
