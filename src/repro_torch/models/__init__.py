"""Decoder-LM models of the port: the pure-SSM (Mamba-2) family so far."""

from repro_torch.models.model import (  # noqa: F401
    DecodeState,
    LMConfig,
    decode_step,
    forward,
    init_decode_state,
    init_params,
    logits_fn,
)
