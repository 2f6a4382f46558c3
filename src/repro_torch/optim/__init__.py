"""Optimizers: AdamW over trees of tensors and the differentiable
capacity optimizer over the fused sweep engine, and int8 gradient
compression (port of ``repro.optim``)."""

from repro_torch.optim.adamw import (  # noqa: F401
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
    make_optimizer,
)
from repro_torch.optim.compression import (  # noqa: F401
    compressed_psum_grads,
    dequantize_int8,
    quantize_int8,
)
from repro_torch.optim.capacity import (  # noqa: F401
    CapacityOptResult,
    DesignBase,
    certification_grid,
    design_consts,
    eviction_deltas,
    hardening_weights,
    knob_design,
    legacy_knobs,
    make_knobs,
    optimize_capacity,
    soft_loss,
    ufa_knobs,
    verify_design,
)
