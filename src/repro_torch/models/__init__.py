"""Decoder-LM models of the port: dense, MoE, SSM and hybrid families."""

from repro_torch.models.model import (  # noqa: F401
    DecodeState,
    LMConfig,
    MoEParallel,
    decode_step,
    forward,
    init_abstract,
    init_decode_state,
    init_params,
    logits_fn,
    moe_capacity,
)
