"""Architecture registry: the architectures the port runs × input shapes.

Each arch module defines ``CONFIG`` (exact assigned numbers), ``REDUCED``
(same family, tiny, for CPU smoke tests) and registers itself here.  The
port of ``repro/configs/base.py``: ``input_specs`` builds ``meta``-device
stand-ins (shapes and dtypes, no allocation) for every (arch x shape)
cell, where the reference builds ``jax.ShapeDtypeStruct``s.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.core.tiers import Tier
from repro_torch.models import LMConfig, init_decode_state

# ---------------------------------------------------------------------------
# Shapes (assigned): all LM-family archs share these four shape cells.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                    # audio|dense|ssm|moe|vlm|hybrid
    config: LMConfig
    reduced: LMConfig
    tier: Tier                     # business-criticality tier for UFA examples
    source: str
    # shape-name -> skip reason (None = runs)
    skips: Dict[str, Optional[str]] = dataclasses.field(default_factory=dict)

    def shape_runnable(self, shape: str) -> bool:
        return self.skips.get(shape) is None


_REGISTRY: Dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.arch_id] = spec
    return spec


def get_arch(arch_id: str) -> ArchSpec:
    _load_all()
    return _REGISTRY[arch_id]


def all_archs() -> Dict[str, ArchSpec]:
    _load_all()
    return dict(_REGISTRY)


_LOADED = False


def _load_all():
    global _LOADED
    if _LOADED:
        return
    from repro_torch.configs import (  # noqa: F401
        musicgen_large, command_r_plus_104b, llama3_2_3b, gemma3_4b,
        qwen3_1_7b, mamba2_780m, kimi_k2_1t_a32b, phi3_5_moe_42b_a6_6b,
        internvl2_76b, hymba_1_5b)
    _LOADED = True


# ---------------------------------------------------------------------------
# Input specs (meta-device stand-ins, no allocation)
# ---------------------------------------------------------------------------


def cache_seq_len(seq_len: int, pad: int = 256) -> int:
    """Decode-cache length for a prompt of ``seq_len``: room for generated
    tokens, padded to a multiple of 256 (the reference's
    ``dist/sharding.cache_seq_len``)."""
    return ((seq_len + pad + 255) // 256) * 256


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(arch: ArchSpec, shape_name: str,
                activ_dtype: str = "bfloat16") -> Dict[str, object]:
    """``meta`` tensors for every model input of the given dry-run cell."""
    cfg = arch.config
    ss = SHAPES[shape_name]
    B, S = ss.global_batch, ss.seq_len
    adt = dataclasses.replace(cfg, activ_dtype=activ_dtype).adtype
    if ss.kind == "train":
        if cfg.embed_inputs:
            inputs = _meta((B, S), torch.int32)
        else:
            inputs = _meta((B, S, cfg.d_model), adt)
        return {"inputs": inputs, "labels": _meta((B, S), torch.int32)}
    if ss.kind == "prefill":
        if cfg.embed_inputs:
            return {"inputs": _meta((B, S), torch.int32)}
        return {"inputs": _meta((B, S, cfg.d_model), adt)}
    # decode: one new token against a KV cache of seq_len
    state = init_decode_state(cfg, B, cache_seq_len(S), torch.bfloat16,
                              length=S, device="meta")
    if cfg.embed_inputs:
        tokens = _meta((B,), torch.int32)
    else:
        tokens = _meta((B, cfg.d_model), adt)
    return {"state": state, "tokens": tokens}


FULL_ATTENTION_500K_SKIP = (
    "long_500k skipped: pure full-attention architecture — published config "
    "does not support 524k context (quadratic prefill, positional scheme); "
    "see DESIGN.md §Arch-applicability.")
