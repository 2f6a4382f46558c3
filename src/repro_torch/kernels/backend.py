"""Device helpers shared by the port's entry points and kernel wrappers.

Every entry point takes ``device=`` and runs on the CUDA card unless the
caller names another device.  There is no environment switch and no
quiet fallback: asking for CUDA on a host without it raises, and the
CPU runs only when the caller asks for it (the CPU tests do).  On the
CPU each kernel wrapper takes its plain PyTorch version; on the card it
launches its kernel.  ``with_plain_grad`` gives every model kernel its
gradient.
"""

from __future__ import annotations

import torch

from repro_torch.obs import cost as _cost


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device`` (default: the CUDA card).

    Also pins float32 to IEEE float32 for the process: TF32 off for
    matrix products and for cuDNN, so no float32 reduction on the UFA
    path can silently lose mantissa bits."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA was asked for but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def describe_device(device) -> dict:
    """``{"platform", "kind", "count"}`` of the device a result ran on."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(dev),
                "count": torch.cuda.device_count()}
    return {"platform": "cpu", "kind": "cpu", "count": 1}


# one CTA's opt-in shared memory on sm_90 (SMEM_OPTIN_BYTES in
# csrc/hopper.cuh): what the routes that keep state in shared memory are
# sized against
SMEM_OPTIN = 232_448

# dtype codes of the model kernels' C entry points (csrc/common.cuh)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def padded_head_dim(d: int, widths, who: str) -> int:
    """The width a call with head dim ``d`` runs at, the one width rule of
    the attention kernels (B5, B6), passed into C: the smallest of the
    route's instantiated ``widths`` that is >= d, the columns past d zero;
    past the widest, the widest, and the call splits d into column
    blocks of that width (the float32-FMA routes).  Any d >= 1, as the
    reference's kernels take any d; d < 1 raises."""
    if d < 1:
        raise ValueError(f"{who}: the kernel takes a head dim d >= 1, "
                         f"got d={d}")
    return next((w for w in widths if w >= d), widths[-1])


def head_dim_route(dtype: torch.dtype, d: int, aligned: bool) -> str:
    """The attention kernels' route (B5, B6) for head dim ``d``:
    ``"mma"`` (the tensor cores) for bfloat16 and float16 whose d is a
    multiple of 8 up to 256 and whose rows are all ``aligned``
    (``rows_aligned``); ``"fma"`` (scalar float32 FMAs, element loads
    where the rows are not aligned, d past 256 split into column blocks)
    for float32 and every other 16-bit input."""
    if (dtype in (torch.bfloat16, torch.float16) and d % 8 == 0
            and d <= 256 and aligned):
        return "mma"
    return "fma"


def kernel_route(who: str, *tensors: torch.Tensor) -> str:
    """``"cpu"`` when every tensor lies on the CPU (the wrapper takes its
    plain version), ``"cuda"`` when all lie on one CUDA device (it
    launches its kernel), ``"meta"`` for ``meta`` tensors while a
    ``obs.cost.CostRecorder`` is active (the wrapper runs its checks,
    returns an empty output and adds its count); raises for mixed
    devices or any other device, ``meta`` outside a recorder included."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{who}: tensors on different devices "
                         f"{sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "meta" and _cost.active() is not None:
        return "meta"
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: no kernel for {dev}")
    return dev.type


def record_kernel(who: str, count) -> None:
    """Add a kernel call's operations and bytes, ``count()``, to the
    active cost recorder (the CUDA and ``meta`` routes); without one,
    ``count`` is not called."""
    rec = _cost.active()
    if rec is not None:
        rec.add_kernel(who, *count())


def plain_route(who: str, count, fn, *args, **kwargs):
    """The CPU route: ``fn`` (the plain version); under a cost recorder
    it runs unseen and the kernel's count, ``count()``, is added instead,
    so the CPU route counts what the kernel would."""
    rec = _cost.active()
    if rec is None:
        return fn(*args, **kwargs)
    rec.add_kernel(who, *count())
    with _cost.plain():
        return fn(*args, **kwargs)


def kernel_dtype(who: str, *tensors: torch.Tensor) -> int:
    """The dtype code of tensors that share float32, bfloat16 or
    float16."""
    dtypes = {t.dtype for t in tensors}
    dtype = dtypes.pop() if len(dtypes) == 1 else None
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"{who}: the kernel takes float32, bfloat16 or "
                        f"float16, one dtype for all, got "
                        f"{[str(t.dtype) for t in tensors]}")
    return KERNEL_DTYPES[dtype]


def rows_aligned(t: torch.Tensor) -> bool:
    """Unit stride on the last axis, and every row start 16-byte aligned:
    what the kernels' vector loads need."""
    size = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s * size % 16 == 0 for s in t.stride()[:-1]))


def launch(who: str, fn, *args, device: torch.device) -> None:
    """Call a C entry point with the device's current stream appended;
    raise on the ``cudaError_t`` it returns.  The device is made current
    for the call only when it is not already (the usual case skips the
    switch's host time)."""
    if device.index is None or device.index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{who} kernel launch failed: cudaError {rc}")


class _PlainBackward(torch.autograd.Function):
    """A kernel wrapper's forward with its plain version's gradient.

    ``forward`` runs the wrapper's body (the kernel for CUDA tensors, the
    plain version for CPU ones) and saves the inputs; ``backward``
    recomputes the plain version from them under ``enable_grad`` and
    returns ``torch.autograd.grad`` of it.  The reference has no backward
    kernel either (no ``custom_vjp``, no backward ``pallas_call``): its
    training differentiates its ``jnp`` layers.  Outputs at the indices
    ``nondiff`` are marked non-differentiable."""

    @staticmethod
    def forward(ctx, body, plain, kwargs, nondiff, *inputs):
        ctx.plain, ctx.kwargs, ctx.nondiff = plain, kwargs, nondiff
        ctx.save_for_backward(*inputs)
        out = body(*inputs, **kwargs)
        outs = out if isinstance(out, tuple) else (out,)
        for i in nondiff:
            ctx.mark_non_differentiable(outs[i])
        return out

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[4:]
        with torch.enable_grad():
            xs = [x.detach().requires_grad_(n)
                  for x, n in zip(ctx.saved_tensors, need)]
            out = ctx.plain(*xs, **ctx.kwargs)
        outs = out if isinstance(out, tuple) else (out,)
        keep = [i for i, o in enumerate(outs)
                if i not in ctx.nondiff and o.requires_grad]
        got = iter(torch.autograd.grad(
            [outs[i] for i in keep], [x for x, n in zip(xs, need) if n],
            [grads[i] for i in keep], allow_unused=True))
        return (None,) * 4 + tuple(next(got) if n else None for n in need)


def with_plain_grad(body, plain, inputs, kwargs, nondiff=()):
    """``body(*inputs, **kwargs)``, through ``_PlainBackward`` when
    autograd records and an input requires grad (on either device, so
    the CPU tests run its backward too); called directly otherwise, as
    under ``torch.no_grad()`` in serving and decode."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _PlainBackward.apply(body, plain, kwargs, tuple(nondiff),
                                    *inputs)
    return body(*inputs, **kwargs)
