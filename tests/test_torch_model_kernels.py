"""The port's model-kernel entry point, ``repro_torch.kernels.ops``, on the
CPU: each op (the plain PyTorch version a wrapper takes for CPU tensors)
against the reference's ``repro.kernels.ops`` (its Pallas kernels in
interpret mode) and the reference's ``repro.kernels.ref`` oracles, on the
same inputs made from a seed with numpy and carried across with
``repro_torch.convert.to_tensor``.

Tolerances are the reference's own (``tests/test_kernels.py``): flash
attention 2e-5 (float32) / 2e-2 (bfloat16), decode attention 3e-5 /
2e-2, grouped matmul 2e-3 / 3e-2, rmsnorm 1e-5 / 2e-2, rtol and atol.
float16, which the reference's tests do not run: 2e-3 (4e-3 for the
grouped matmul), rtol and atol.  Both sides compute in float32 and round
once to float16 (4.9e-4 relative), so the bound leaves room for the two
frameworks' float32 sum orders and no more."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_oracle  # noqa: E402
from repro_torch.convert import to_tensor  # noqa: E402
from repro_torch.kernels import backend, ops  # noqa: E402
from repro_torch.kernels import decode_attention as b5  # noqa: E402
from repro_torch.kernels import flash_attention as b6  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    BLOCK_K, _runtime_scalar, decode_attention_route, split_count,
    split_tiles)
from repro_torch.kernels.grouped_matmul import (  # noqa: E402
    grouped_matmul_route)

F32, BF16, F16 = jnp.float32, jnp.bfloat16, jnp.float16
TOL = {"flash": (2e-5, 2e-2, 2e-3), "decode": (3e-5, 2e-2, 2e-3),
       "gmm": (2e-3, 3e-2, 4e-3), "rmsnorm": (1e-5, 2e-2, 2e-3)}
# the head dims the attention kernels took no part of before float16 and
# the whole domain: not a multiple of 8, and above 256
NEW_HEAD_DIMS = [1, 4, 12, 100, 257, 320, 512]


def _normal(seed, shape, dtype=F32):
    """A reference array from a seeded numpy draw, and its port copy."""
    a = jnp.asarray(np.random.default_rng(seed).standard_normal(shape)
                    .astype(np.float32), dtype)
    return a, to_tensor(a, device="cpu")


def _close(got, want, kind, dtype):
    tol = TOL[kind][{F32: 0, BF16: 1, F16: 2}[dtype]]
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# convert
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_to_tensor_is_exact(dtype):
    vals = np.concatenate([
        np.random.default_rng(0).standard_normal(1000) * 1e3,
        [0.0, -0.0, 1.0, -1.5, 3.4e38, -3.4e38, 1e-38, 2.0 ** -133,
         np.inf, -np.inf]]).astype(np.float32)
    a = jnp.asarray(vals, dtype)
    t = to_tensor(a, device="cpu")
    want_dtype = torch.float32 if dtype == F32 else torch.bfloat16
    assert t.dtype == want_dtype and t.shape == a.shape
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(a, np.float32))
    assert to_tensor(np.arange(5, dtype=np.int32), "cpu").dtype == torch.int32


# ---------------------------------------------------------------------------
# B4: rmsnorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,d,dtype", [
    (1, 128, F32), (7, 128, F32), (64, 512, F32), (33, 1024, F32),
    (1, 1024, BF16), (7, 128, BF16), (64, 512, BF16),
])
def test_rmsnorm_matches_reference(rows, d, dtype):
    x, xt = _normal(rows + d, (rows, d), dtype)
    s, st = _normal(1, (d,), dtype)
    got = ops.rmsnorm(xt, st)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    _close(got, ref_ops.rmsnorm(x, s), "rmsnorm", dtype)
    _close(got, ref_oracle.ref_rmsnorm(x, s), "rmsnorm", dtype)


def test_rmsnorm_leading_axes_mixed_scale_and_eps():
    """(B, S, D) input, a float32 scale on bfloat16 activations, another
    eps."""
    x, xt = _normal(3, (2, 5, 256), BF16)
    s, st = _normal(4, (256,), F32)
    got = ops.rmsnorm(xt, st, eps=1e-5)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 5, 256)
    _close(got, ref_ops.rmsnorm(x, s, 1e-5), "rmsnorm", BF16)


@pytest.mark.parametrize("rows,d,dtype,sdtype", [
    (7, 128, F16, F16), (64, 512, F16, F16), (4, 3072, F16, F32),
    (5, 96, F32, F16),
    # past the one-pass kernel's 16,384: the two-pass kernel on the card
    (3, 20_000, F16, F16), (3, 20_000, F32, F32), (2, 20_000, BF16, BF16),
    (2, 20_001, F16, F32),
])
def test_rmsnorm_float16_and_wide_rows(rows, d, dtype, sdtype):
    """float16 activations or scales, and rows wider than 16,384, against
    the reference's Pallas kernel in interpret mode: y in x's dtype."""
    x, xt = _normal(rows * d, (rows, d), dtype)
    s, st = _normal(2, (d,), sdtype)
    got = ops.rmsnorm(xt, st)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    want = ref_ops.rmsnorm(x, s)
    assert want.dtype == x.dtype
    _close(got, want, "rmsnorm", dtype)


# ---------------------------------------------------------------------------
# B6: flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,H,d,window,causal,dtype", [
    (128, 2, 64, 0, True, F32),
    (256, 4, 64, 64, True, F32),
    (256, 1, 128, 100, True, F32),
    (256, 2, 64, 300, True, F32),
    (128, 2, 64, 0, False, F32),
    (256, 2, 64, 64, False, F32),
    (128, 2, 64, 0, True, BF16),
    (256, 2, 128, 100, True, BF16),
    (128, 2, 64, 0, False, BF16),
    (128, 3, 32, 50, True, BF16),
])
def test_flash_attention_matches_reference(S, H, d, window, causal, dtype):
    B = 2
    (q, qt), (k, kt), (v, vt) = (_normal(10 + i, (B, S, H, d), dtype)
                                 for i in range(3))
    got = ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _close(got, ref_ops.flash_attention(q, k, v, causal=causal,
                                        window=window), "flash", dtype)
    _close(got, ref_oracle.ref_flash_attention(q, k, v, causal=causal,
                                               window=window),
           "flash", dtype)


@pytest.mark.parametrize("S,H,d,window,causal", [
    (128, 2, 64, 0, True), (256, 2, 128, 100, True), (128, 2, 64, 0, False),
    (128, 3, 32, 50, True),
])
def test_flash_attention_float16(S, H, d, window, causal):
    """float16 q, k, v (the 16-bit tensor-core route on the card) against
    the reference's Pallas kernel in interpret mode: out in float16."""
    (q, qt), (k, kt), (v, vt) = (_normal(70 + i, (2, S, H, d), F16)
                                 for i in range(3))
    got = ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == torch.float16 and got.shape == qt.shape
    _close(got, ref_ops.flash_attention(q, k, v, causal=causal,
                                        window=window), "flash", F16)


def test_flash_attention_reads_strided_views():
    """A (B, H, S, d) buffer viewed as (B, S, H, d): the same result as
    its contiguous copy."""
    (_, qt), (_, kt), (_, vt) = (_normal(20 + i, (1, 2, 64, 32))
                                 for i in range(3))
    views = [t.transpose(1, 2) for t in (qt, kt, vt)]
    got = ops.flash_attention(*views, window=16)
    want = ops.flash_attention(*[t.contiguous() for t in views], window=16)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# B5: decode attention
# ---------------------------------------------------------------------------


def _decode_inputs(seed, B, H, KV, K, d, dtype=F32):
    q = _normal(seed, (B, H, d), dtype)
    kc = _normal(seed + 1, (B, K, KV, d), dtype)
    vc = _normal(seed + 2, (B, K, KV, d), dtype)
    return q, kc, vc


@pytest.mark.parametrize("length,window,kv", [
    (1, 0, 1), (37, 64, 2), (256, 0, 4), (300, 300, 1), (511, 100, 2),
    (700, 64, 4), (1024, 0, 2), (1024, 300, 4), (999, 0, 1),
])
def test_decode_attention_matches_reference(length, window, kv):
    B, d, K = 2, 64, 1024
    H = kv * 2
    (q, qt), (kc, kct), (vc, vct) = _decode_inputs(length, B, H, kv, K, d)
    got = ops.decode_attention(qt, kct, vct, length, window)
    assert got.dtype == torch.float32 and got.shape == (B, H, d)
    _close(got, ref_ops.decode_attention(q, kc, vc, length, window,
                                         block_k=256), "decode", F32)
    _close(got, ref_oracle.ref_decode_attention(q, kc, vc, length,
                                                window=window),
           "decode", F32)


@pytest.mark.parametrize("group", [1, 2, 4])
def test_decode_attention_bf16_groups(group):
    B, KV, K, d = 2, 2, 512, 128
    (q, qt), (kc, kct), (vc, vct) = _decode_inputs(7, B, KV * group, KV, K,
                                                   d, BF16)
    got = ops.decode_attention(qt, kct, vct, 400, 128)
    assert got.dtype == torch.bfloat16
    _close(got, ref_ops.decode_attention(q, kc, vc, 400, 128), "decode",
           BF16)


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("length", [0, 1])
def test_decode_attention_edge_lengths(length, as_tensor):
    """length 0 gives exact zeros, as the Pallas kernel does (the
    reference oracle gives NaN there); length 1 attends to position 0
    only.  length and window as ints and as int32 tensors."""
    (q, qt), (kc, kct), (vc, vct) = _decode_inputs(3, 2, 4, 2, 256, 64)
    arg = (lambda n: torch.tensor(n, dtype=torch.int32)) if as_tensor \
        else (lambda n: n)
    got = ops.decode_attention(qt, kct, vct, arg(length), arg(64))
    want = np.asarray(ref_ops.decode_attention(q, kc, vc, length, 64))
    _close(got, want, "decode", F32)
    if length == 0:
        assert not got.any() and not np.any(want)
    else:
        # one position: the output is that position's V row, per KV head
        np.testing.assert_allclose(
            got.numpy(), np.repeat(vct[:, 0].numpy(), 2, axis=1),
            rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("group", [1, 4])
def test_decode_attention_float16(group):
    """float16 q and caches against the reference's Pallas kernel in
    interpret mode: out in float16."""
    B, KV, K, d = 2, 2, 512, 128
    (q, qt), (kc, kct), (vc, vct) = _decode_inputs(9, B, KV * group, KV, K,
                                                   d, F16)
    got = ops.decode_attention(qt, kct, vct, 400, 128)
    assert got.dtype == torch.float16
    _close(got, ref_ops.decode_attention(q, kc, vc, 400, 128,
                                         interpret=True), "decode", F16)


@pytest.mark.parametrize("length,window", [(1, 0), (5, 0), (16, 0), (13, 8)])
@pytest.mark.parametrize("d,H,KV,K", [(16, 4, 2, 16), (16, 4, 4, 48),
                                      (8, 8, 2, 48), (8, 4, 2, 16)])
def test_decode_attention_small_head_dims(d, H, KV, K, length, window):
    """The head dims B5's float32 route takes for the serving drill's
    model and the reduced configs (d 16, command-r-plus-104b's d 8, the
    reduced gemma3's window 8), at the drill's 16-slot cache and a
    48-slot one: the plain version a CPU tensor takes against the
    reference's Pallas kernel in interpret mode and its oracle."""
    B = 3
    (q, qt), (kc, kct), (vc, vct) = _decode_inputs(
        100 + d + K + length, B, H, KV, K, d)
    got = ops.decode_attention(qt, kct, vct, length, window)
    assert got.dtype == torch.float32 and got.shape == (B, H, d)
    _close(got, ref_ops.decode_attention(q, kc, vc, length, window,
                                         block_k=16, interpret=True),
           "decode", F32)
    _close(got, ref_oracle.ref_decode_attention(q, kc, vc, length,
                                                window=window),
           "decode", F32)


@pytest.mark.parametrize("length,window", [(400, 128), (512, 0)])
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("group", [12, 5])
def test_decode_attention_large_groups(group, dtype, length, window):
    """Groups above 8 query heads per KV head (command-r-plus-104b: 96
    over 8) and an odd one (hymba-1.5b: 25 over 5), which the kernel runs
    as sub-groups of at most 16 (bf16) or 8 (float32) heads a block."""
    B, KV, K, d = 2, 2, 512, 64
    (q, qt), (kc, kct), (vc, vct) = _decode_inputs(20 + group, B, KV * group,
                                                   KV, K, d, dtype)
    got = ops.decode_attention(qt, kct, vct, length, window)
    assert got.shape == (B, KV * group, d)
    _close(got, ref_ops.decode_attention(q, kc, vc, length, window,
                                         block_k=256), "decode", dtype)


# ---------------------------------------------------------------------------
# B5 and B6: the head-dim domain (any d >= 1, in the three dtypes)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", list(range(8, 257, 8)) + NEW_HEAD_DIMS)
def test_head_dim_domain_passes_the_checks(d, dtype):
    """B5's and B6's checks (only the card runs them) on meta tensors:
    every multiple of 8 from 8 to 256 and the head dims off that grid (1,
    4, 12, 100, 257, 320, 512) in the three dtypes, B5 at a group of 12,
    each run at the smallest width its route is instantiated for (the
    widest, 256, in column blocks past it); the 16-bit types take the
    tensor-core route exactly where d is a multiple of 8 up to 256 and the
    rows are 16-byte aligned."""
    code = backend.KERNEL_DTYPES[dtype]
    q = torch.empty((2, 12, d), dtype=dtype, device="meta")
    kc = torch.empty((2, 100, 1, d), dtype=dtype, device="meta")
    assert b5.check_inputs(q, kc, kc) == code
    qf = torch.empty((1, 64, 3, d), dtype=dtype, device="meta")
    assert b6.check_inputs(qf, qf, qf, window=16) == code
    tensor_cores = dtype != torch.float32 and d % 8 == 0 and d <= 256
    for mod, route in ((b5, b5.decode_attention_route(q, kc, kc)),
                       (b6, b6.flash_attention_route(qf, qf, qf))):
        assert route == ("mma" if tensor_cores else "fma")
        width = backend.padded_head_dim(d, mod.WIDTHS[route], "check")
        assert width >= min(d, mod.WIDTHS[route][-1])
        assert width in mod.WIDTHS[route]
        assert all(w < d for w in mod.WIDTHS[route] if w < width)


_REFUSED = {
    # the reference refuses d 0 too: 1 / sqrt(0) raises ZeroDivisionError
    "d0": (dict(d=0), ValueError, "d >= 1"),
    "float64": (dict(dtype=torch.float64), TypeError, "float32, bfloat16"),
    "int32": (dict(dtype=torch.int32), TypeError, "float32, bfloat16"),
    "mixed": (dict(kv_dtype=torch.bfloat16), TypeError, "one dtype"),
    "cache_d": (dict(kv_d=13), ValueError, "(do not fit|one shape)"),
    "strided_d": (dict(step=2), ValueError, "unit-strided"),
}


@pytest.mark.parametrize("case", list(_REFUSED))
def test_head_dim_domain_refuses_the_rest(case):
    """What B5's and B6's checks refuse now that every d >= 1 and float16
    are in the domain: d 0 (where the reference's kernels raise as well),
    dtypes other than float32 / bfloat16 / float16, a dtype mixed between
    q and K/V, K/V whose d differs from q's, and a head axis that is not
    unit-strided."""
    kw, error, match = _REFUSED[case]
    d, dtype = kw.get("d", 12), kw.get("dtype", torch.float16)
    kv_dtype, kv_d = kw.get("kv_dtype", dtype), kw.get("kv_d", d)
    step = kw.get("step", 1)

    def m(*shape, dt=dtype):
        full = shape[:-1] + (shape[-1] * step,)
        return torch.empty(full, dtype=dt, device="meta")[..., ::step]

    q, kc = m(2, 4, d), m(2, 100, 2, kv_d, dt=kv_dtype)
    with pytest.raises(error, match=match):
        b5.check_inputs(q, kc, kc)
    qf, kf = m(1, 64, 3, d), m(1, 64, 3, kv_d, dt=kv_dtype)
    with pytest.raises(error, match=match):
        b6.check_inputs(qf, kf, kf)
    if case == "d0":
        z = jnp.zeros((1, 128, 2, 0))
        with pytest.raises(ZeroDivisionError):
            ref_ops.flash_attention(z, z, z)
        with pytest.raises(ZeroDivisionError):
            ref_ops.decode_attention(jnp.zeros((1, 2, 0)),
                                     jnp.zeros((1, 64, 1, 0)),
                                     jnp.zeros((1, 64, 1, 0)), 3)


@pytest.mark.parametrize("dtype", [F32, BF16, F16])
@pytest.mark.parametrize("d", NEW_HEAD_DIMS)
def test_flash_attention_any_head_dim(d, dtype):
    """The plain version a CPU tensor takes at head dims off the
    multiple-of-8 grid and above 256, in the three dtypes, against the
    reference's Pallas kernel in interpret mode (which makes each block
    the full d), causal with a window."""
    (q, qt), (k, kt), (v, vt) = (_normal(80 + d + i, (1, 128, 2, d), dtype)
                                 for i in range(3))
    got = ops.flash_attention(qt, kt, vt, causal=True, window=50)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _close(got, ref_ops.flash_attention(q, k, v, causal=True, window=50),
           "flash", dtype)


@pytest.mark.parametrize("dtype", [F32, BF16, F16])
@pytest.mark.parametrize("d", NEW_HEAD_DIMS)
def test_decode_attention_any_head_dim(d, dtype):
    """The same for decode attention, at a GQA group of 8 over one KV
    head, a 128-slot cache at length 100, window 0 and 64."""
    (q, qt), (kc, kct), (vc, vct) = _decode_inputs(90 + d, 2, 8, 1, 128, d,
                                                   dtype)
    for window in (0, 64):
        got = ops.decode_attention(qt, kct, vct, 100, window)
        assert got.dtype == qt.dtype and got.shape == (2, 8, d)
        _close(got, ref_ops.decode_attention(q, kc, vc, 100, window,
                                             block_k=64, interpret=True),
               "decode", dtype)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("d", [24, 80, 96])
def test_flash_attention_padded_head_dims(d, dtype):
    """The plain version a CPU tensor takes at head dims the kernels run
    padded (d 24 at width 32, d 80 and 96 at 128) against the
    reference's Pallas kernel in interpret mode and its oracle, causal
    with a window."""
    (q, qt), (k, kt), (v, vt) = (_normal(40 + d + i, (2, 128, 2, d), dtype)
                                 for i in range(3))
    got = ops.flash_attention(qt, kt, vt, causal=True, window=50)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _close(got, ref_ops.flash_attention(q, k, v, causal=True, window=50),
           "flash", dtype)
    _close(got, ref_oracle.ref_flash_attention(q, k, v, causal=True,
                                               window=50), "flash", dtype)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("d", [24, 80, 96])
def test_decode_attention_padded_head_dims(d, dtype):
    """The same for decode attention: a group of 4 over 2 KV heads, a
    256-slot cache at length 200, window 0 and 64."""
    (q, qt), (kc, kct), (vc, vct) = _decode_inputs(60 + d, 2, 8, 2, 256, d,
                                                   dtype)
    for window in (0, 64):
        got = ops.decode_attention(qt, kct, vct, 200, window)
        assert got.dtype == qt.dtype and got.shape == (2, 8, d)
        _close(got, ref_ops.decode_attention(q, kc, vc, 200, window,
                                             block_k=64, interpret=True),
               "decode", dtype)
        _close(got, ref_oracle.ref_decode_attention(q, kc, vc, 200,
                                                    window=window),
               "decode", dtype)


@pytest.mark.parametrize("nsplit", [1, 4, 33])
@pytest.mark.parametrize("window", [0, 1, 100, 2000])   # 2000: past K
@pytest.mark.parametrize("length", [0, 1, 63, 64, 65, 1000])
def test_decode_split_tiles_cover_the_valid_range_once(length, window,
                                                       nsplit):
    """The splits' tiles, as the kernel plans them from the device's
    length and window, hold every valid position exactly once: disjoint,
    in order, equal shares +-1, none wholly outside the valid range."""
    K = 1000
    lo = max(0, length - window) if window > 0 else 0
    hi = min(length, K)
    tiles = [split_tiles(K, length, window, sp, nsplit)
             for sp in range(nsplit)]
    seen = np.zeros(K, np.int64)
    for a, b in tiles:
        assert 0 <= a <= b
        seen[max(lo, a * BLOCK_K):min(hi, b * BLOCK_K)] += 1
    assert (seen[lo:hi] == 1).all() and seen.sum() == max(0, hi - lo)
    flat = [t for a, b in tiles for t in range(a, b)]
    want = list(range(lo // BLOCK_K, -(-hi // BLOCK_K))) if hi > lo else []
    assert flat == want
    sizes = [b - a for a, b in tiles]
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("B,KV,n_sub,K,resident,want", [
    (8, 8, 1, 8192, 264, 4),    # llama3.2-3b, 2 blocks an SM x 132 SMs
    (8, 5, 1, 8192, 396, 9),    # hymba-1.5b, 3 blocks an SM
    (8, 32, 1, 4096, 396, 1),   # musicgen-large: a wave holds no split
    (8, 8, 2, 8192, 640, 5),    # two sub-groups a KV head
    (1, 1, 1, 100, 264, 2),     # at most one split a tile of the cache
])
def test_decode_split_count(B, KV, n_sub, K, resident, want):
    assert split_count(B, KV, n_sub, K, resident) == want


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 64, "mma"), (torch.float32, 64, "fma"),
    (torch.float16, 64, "mma"), (torch.float16, 12, "fma"),
    (torch.bfloat16, 320, "fma"), (torch.float32, 320, "fma")])
def test_decode_attention_route(dtype, d, route):
    """The 16-bit types on the tensor cores where TMA reads the rows (d a
    multiple of 8 up to 256), the scalar route elsewhere."""
    assert decode_attention_route(torch.zeros(1, 2, d, dtype=dtype)) == route


@pytest.mark.parametrize("name", ["length", "window"])
@pytest.mark.parametrize("dtype", [torch.int64, torch.int32, torch.int16])
def test_runtime_scalar_casts_on_the_device(name, dtype):
    """A one-element integer tensor on the call's device, int64 (torch's
    default) or any other integer dtype, is cast to int32 there and passed
    by pointer: no host read (a ``meta`` tensor has no value to read, so
    ``int()`` or ``.item()`` would raise), and the cast tensor is handed
    back to be kept alive until the launch."""
    dev = torch.device("meta")
    val = torch.tensor(6000, dtype=dtype).to(dev)
    ptr, host, keep = _runtime_scalar(name, val, dev)
    assert host == 0 and ptr is not None
    assert keep.dtype == torch.int32 and keep.device == dev
    assert keep.numel() == 1
    if dtype == torch.int32:
        assert keep is val


@pytest.mark.parametrize("val,device,error", [
    (torch.tensor(6000.0, device="meta"), "meta", TypeError),
    (torch.tensor(6000, device="meta"), "cuda", ValueError),
    (torch.tensor([1, 2], device="meta"), "meta", TypeError),
    (2 ** 31, "meta", ValueError),
])
def test_runtime_scalar_refuses(val, device, error):
    """A float tensor, a tensor on another device than the call's, more
    than one element, or an int out of int32's range raise."""
    with pytest.raises(error):
        _runtime_scalar("length", val, torch.device(device))


@pytest.mark.parametrize("val", [6000, torch.tensor(6000),
                                 torch.tensor(6000, dtype=torch.int32)])
def test_runtime_scalar_host_values(val):
    """Python ints and CPU tensors are read on the host and passed by
    value."""
    assert _runtime_scalar("length", val, torch.device("meta")) == (
        None, 6000, None)


# ---------------------------------------------------------------------------
# B7: grouped matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("E,C,D,F,dtype", [
    (2, 128, 256, 128, F32),
    (4, 256, 512, 256, F32),
    (2, 128, 256, 128, BF16),
    # kimi-k2's experts cut down: C ragged against the wgmma route's
    # 128-row tile, and dividing the reference's own blocks
    (4, 56, 192, 64, F32),
    (4, 56, 192, 64, BF16),
    (2, 128, 256, 128, F16),
    (4, 56, 192, 64, F16),
])
def test_grouped_matmul_matches_reference(E, C, D, F, dtype):
    x, xt = _normal(0, (E, C, D), dtype)
    w, wt = _normal(1, (E, D, F), dtype)
    got = ops.grouped_matmul(xt, wt)
    assert got.dtype == xt.dtype and got.shape == (E, C, F)
    _close(got, ref_ops.grouped_matmul(x, w), "gmm", dtype)
    _close(got, ref_oracle.ref_grouped_matmul(x, w), "gmm", dtype)


@pytest.mark.parametrize("dtype", [F32, BF16, F16])
def test_grouped_matmul_ragged(dtype):
    """Shapes off every block size (the reference's Pallas kernel asserts
    divisibility; the oracle holds the port)."""
    x, xt = _normal(5, (3, 50, 100), dtype)
    w, wt = _normal(6, (3, 100, 70), dtype)
    _close(ops.grouped_matmul(xt, wt), ref_oracle.ref_grouped_matmul(x, w),
           "gmm", dtype)


def _meta_view(shape, dtype, offset):
    """A contiguous ``meta`` tensor of ``shape`` that starts ``offset``
    elements into its storage (nothing is allocated or launched)."""
    n = int(np.prod(shape))
    return torch.empty(n + offset, dtype=dtype,
                       device="meta")[offset:].view(shape)


@pytest.mark.parametrize("E,C,D,F,dtype,x_off,w_off,route", [
    # phi3.5-moe expert up and down, kimi-k2 expert up (64 of 384
    # experts), and the ragged C, D, F edge: chip_smoke's wgmma cases
    (16, 640, 4096, 6400, torch.bfloat16, 0, 0, "wgmma"),
    (16, 640, 6400, 4096, torch.bfloat16, 0, 0, "wgmma"),
    (64, 112, 7168, 2048, torch.bfloat16, 0, 0, "wgmma"),
    (2, 200, 1000, 520, torch.bfloat16, 0, 0, "wgmma"),
    # D and F off multiples of 8, D = 0, or a view 2 bytes off alignment
    (3, 50, 100, 70, torch.bfloat16, 0, 0, "mma_sync"),
    (2, 64, 64, 260, torch.bfloat16, 0, 0, "mma_sync"),
    (2, 64, 0, 64, torch.bfloat16, 0, 0, "mma_sync"),
    (2, 64, 64, 64, torch.bfloat16, 1, 0, "mma_sync"),
    (2, 64, 64, 64, torch.bfloat16, 0, 1, "mma_sync"),
    (2, 64, 64, 64, torch.bfloat16, 8, 8, "wgmma"),
    # float16 takes the same routes as bfloat16
    (16, 640, 4096, 6400, torch.float16, 0, 0, "wgmma"),
    (3, 50, 100, 70, torch.float16, 0, 0, "mma_sync"),
    (2, 64, 64, 64, torch.float16, 1, 0, "mma_sync"),
    # float32 keeps the IEEE-FMA kernel whatever its shape
    (16, 640, 4096, 6400, torch.float32, 0, 0, "fma"),
    (3, 50, 100, 70, torch.float32, 0, 0, "fma"),
])
def test_grouped_matmul_route(E, C, D, F, dtype, x_off, w_off, route):
    x = _meta_view((E, C, D), dtype, x_off)
    w = _meta_view((E, D, F), dtype, w_off)
    assert x.is_contiguous() and w.is_contiguous()
    assert grouped_matmul_route(x, w) == route


# ---------------------------------------------------------------------------
# the slice: the four ops composed, port against reference
# ---------------------------------------------------------------------------


def _block(m, x, scale, wq, wk, wv, w_up):
    """norm -> q/k/v -> causal windowed attention -> decode of the last
    token against the cache -> expert product, through one package's ops
    (``m``)."""
    B, S, D = x.shape
    H, d = 4, 32
    h = m.rmsnorm(x, scale)
    q, k, v = ((h @ w).reshape(B, S, H, d) for w in (wq, wk, wv))
    att = m.flash_attention(q, k, v, causal=True, window=24)
    # the cache in the model layout, 2 KV heads (every other head)
    kc, vc = k[:, :, ::2], v[:, :, ::2]
    dec = m.decode_attention(q[:, -1], kc, vc, S, 24)
    tokens = att.reshape(B * S, H * d)[: 4 * 16].reshape(4, 16, H * d)
    return att, dec, m.grouped_matmul(tokens, w_up)


def test_ops_slice_matches_reference():
    rng = np.random.default_rng(42)
    B, S, D = 2, 64, 96
    arrays = [rng.standard_normal(s).astype(np.float32) * f for s, f in (
        ((B, S, D), 1.0), ((D,), 1.0), ((D, 128), 0.1), ((D, 128), 0.1),
        ((D, 128), 0.1), ((4, 128, 48), 0.1))]
    ref = _block(ref_ops, *[jnp.asarray(a) for a in arrays])
    port = _block(ops, *[to_tensor(a, device="cpu") for a in arrays])
    for got, want, kind in zip(port, ref, ("flash", "decode", "gmm")):
        _close(got, want, kind, F32)
    # decode of the last token sees what flash attention's last row saw,
    # on the KV heads the decode cache keeps
    att, dec, _ = port
    np.testing.assert_allclose(dec[:, ::2].numpy(), att[:, -1, ::2].numpy(),
                               rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# wrappers: no launch on the CPU, a refusal anywhere else
# ---------------------------------------------------------------------------


def _meta(*shape):
    return torch.empty(shape, device="meta")


@pytest.mark.parametrize("op,args", [
    ("rmsnorm", lambda: (_meta(4, 128), _meta(128))),
    ("flash_attention", lambda: (_meta(1, 64, 2, 32),) * 3),
    ("decode_attention", lambda: (_meta(1, 2, 32), _meta(1, 64, 1, 32),
                                  _meta(1, 64, 1, 32), 10)),
    ("grouped_matmul", lambda: (_meta(2, 8, 16), _meta(2, 16, 8))),
])
def test_wrappers_refuse_meta_and_launch_nothing_on_cpu(op, args):
    fn = getattr(ops, op)
    with pytest.raises(ValueError, match="no kernel for meta"):
        fn(*args())
    cpu = [torch.zeros(a.shape) if isinstance(a, torch.Tensor) else a
           for a in args()]
    before = fn.launches
    out = fn(*cpu)
    assert fn.launches == before and out.device.type == "cpu"
    assert torch.isfinite(out).all()
