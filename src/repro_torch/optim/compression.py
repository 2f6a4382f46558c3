"""Gradient compression: int8 quantization with stochastic rounding
(port of ``repro/optim/compression.py``).

For cross-pod data parallelism the gradient all-reduce over the slow
inter-pod link dominates; quantizing to int8 with a per-tensor scale
cuts that wire traffic 4x vs bf16 (8x vs fp32).  Pattern: quantize ->
sum(int32) -> dequantize, which is exactly associative, so the mean is
unbiased when paired with stochastic rounding.  The rounding noise comes
from a ``torch.Generator`` on the tensor's device: the reference's
``jax.random`` bits cannot be reproduced, so the port is held to its
statistical contracts (error within one quantization step, an unbiased
mean).  The collectives are ``torch.distributed``'s, over a process
group or a mesh axis (``launch.mesh.Mesh``), across real processes.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.optim.adamw import _leaves, _unflatten


def _noise(shape, generator: torch.Generator) -> torch.Tensor:
    """Uniform float32 noise in [-0.5, 0.5) on the generator's device."""
    return torch.rand(shape, generator=generator, dtype=torch.float32,
                      device=generator.device) - 0.5


def quantize_int8(x: torch.Tensor, generator: torch.Generator
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (q int8, scale).  Stochastic rounding keeps E[deq(q)] = x."""
    x32 = x.to(torch.float32)
    amax = torch.max(torch.abs(x32))
    scale = torch.clamp(amax / 127.0, min=1e-12)
    y = x32 / scale
    q = torch.clamp(torch.round(y + _noise(x.shape, generator)), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def compressed_psum_grads(grads: Any, group, generator: torch.Generator,
                          mesh=None) -> Any:
    """int8-compressed gradient mean over the process ``group`` of
    ``torch.distributed`` (None: the default group), or over the mesh
    axis (or axes) ``group`` names: ``mesh`` given, or the one that
    ``dist.smap.shard_map`` / ``sharding_rules`` binds.  Each participant
    quantizes, int32-sums, dequantizes with the shared scale.

    Bias note: participants use their own scale; summing int8 payloads with
    per-participant scales requires a shared scale — we all-reduce the max
    of the amax first (one tiny scalar collective) so the quantization grid
    is common.
    """
    if isinstance(group, (str, tuple)):
        from repro_torch.dist.smap import _mesh
        mesh = _mesh(mesh)
        n = mesh.group_size(group)
        group = mesh.group(group) if n > 1 else None
    else:
        n = dist.get_world_size(group)
    out = []
    for leaf in _leaves(grads):
        x32 = leaf.to(torch.float32)
        amax = torch.max(torch.abs(x32))
        if n > 1:
            dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = torch.clamp(amax / 127.0, min=1e-12)
        y = x32 / scale
        q = torch.clamp(torch.round(y + _noise(leaf.shape, generator)),
                        -127, 127).to(torch.int32)
        if n > 1:
            dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
        out.append((q.to(torch.float32) * scale / n).to(leaf.dtype))
    return _unflatten(grads, out)
