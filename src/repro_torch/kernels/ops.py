"""Public entry points of the model kernels, in the model's layouts.

The port of ``repro/kernels/ops.py``:

  flash_attention(q, k, v, *, causal=True, window=0)
      q/k/v (B, S, H, d) with KV already repeated to H heads   -> B6
  decode_attention(q, k_cache, v_cache, length, window=0)
      q (B, H, d), caches (B, K, KV, d)                        -> B5
  grouped_matmul(x, w)
      x (E, C, D) @ w (E, D, F)                                -> B7
  rmsnorm(x, scale, eps=1e-6)
      x (..., D), scale (D,)                                   -> B4
  ssd_scan(x, dt, a, b, c, chunk=128)
      x (B, S, H, P), dt (B, S, H), a (H,), b/c (B, S, G, N)   -> B8

The reference transposes between the model's layout and its Pallas
kernels' blocked layouts here; the CUDA kernels read the model's layouts
through their strides, so these are the kernel wrappers themselves (each
keeps its ``.launches`` count, and while tracing is on opens the span
``kernel.b4`` ... ``kernel.b8`` around its launch).  The reference's ``interpret`` and
``block_*`` arguments were TPU tiling and interpreter knobs and are gone:
each kernel sizes its own tiles.  Tensors on the card launch the kernels;
tensors on the CPU take their plain PyTorch versions (``kernels.ref``).
``ssd_scan`` keeps the reference's contracts: b and c in G groups with
``H % G == 0`` (the kernel indexes group ``h // (H // G)`` rather than
repeating b and c), and ``S % chunk == 0`` (``ValueError`` otherwise).
"""

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.grouped_matmul import grouped_matmul
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.ssd_scan import ssd_scan

__all__ = ["decode_attention", "flash_attention", "grouped_matmul",
           "rmsnorm", "ssd_scan"]
