"""The port's SSD chunked scan on the CPU: ``repro_torch.kernels.ops.
ssd_scan`` (the plain version the B8 wrapper takes for CPU tensors)
against the reference's ``repro.kernels.ops.ssd_scan`` (its Pallas kernel
in interpret mode) and the reference model's ``ssd_chunked``, and the
port's oracles (``ref_ssd_chunk``, ``ssd_chunked``, ``_segsum``) against
theirs, on the same inputs made from a seed with numpy and carried across
with ``repro_torch.convert.to_tensor``.

Tolerances: ``ops.ssd_scan`` at the reference's own rtol = atol = 2e-3
(``tests/test_kernels.py``: the Pallas kernel's cumsum is a triangular
matmul, the oracle's a cumsum, and the contractions run in other
orders); bf16 outputs at the reference's bf16 tolerance for the model
kernels, 2e-2; float16 y at 4e-3 (both sides round a float32 y once to
float16, 4.9e-4 relative, over the float32 2e-3); the oracles, which follow the same formulas step for step,
at 1e-5; ``ssd_chunked`` in float64 against the float64 recurrence at
1e-10.  Cases are ``parametrize``d (no ``@given``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_oracle  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro_torch.convert import to_tensor  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as port_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan_route  # noqa: E402
from repro_torch.models import layers as port_layers  # noqa: E402

F32, BF16, F16 = jnp.float32, jnp.bfloat16, jnp.float16
KERNEL_TOL = 2e-3
BF16_TOL = 2e-2
F16_TOL = 4e-3
ORACLE_TOL = 1e-5


def _inputs(seed, B, S, H, G, P, N, dtype=F32, dt_dtype=F32):
    """x, dt (softplus'd), a (negative), b, c as reference arrays and as
    port tensors."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(H)).astype(np.float32)
    b = rng.standard_normal((B, S, G, N)).astype(np.float32)
    c = rng.standard_normal((B, S, G, N)).astype(np.float32)
    ref = (jnp.asarray(x, dtype), jnp.asarray(dt, dt_dtype), jnp.asarray(a),
           jnp.asarray(b, dtype), jnp.asarray(c, dtype))
    return ref, tuple(to_tensor(t, device="cpu") for t in ref)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("G_is_H", [False, True])
@pytest.mark.parametrize("H", [1, 2, 4])
@pytest.mark.parametrize("chunk", [16, 32, 64])
@pytest.mark.parametrize("S", [64, 128])
def test_ssd_scan_matches_reference(S, chunk, H, G_is_H):
    B, P, N = 2, 16, 32
    G = H if G_is_H else 1
    ref, port = _inputs(S * chunk + H + 7 * G, B, S, H, G, P, N)
    y, state = ops.ssd_scan(*port, chunk=chunk)
    assert y.dtype == torch.float32 and y.shape == (B, S, H, P)
    assert state.dtype == torch.float32 and state.shape == (B, H, P, N)
    y_k, s_k = ref_ops.ssd_scan(*ref, chunk=chunk)
    _close(y, y_k, KERNEL_TOL)
    _close(state, s_k, KERNEL_TOL)
    y_r, s_r = ref_layers.ssd_chunked(*ref, chunk)
    _close(y, y_r, KERNEL_TOL)
    _close(state, s_r, KERNEL_TOL)


@pytest.mark.parametrize("dt_dtype", [F32, BF16])
def test_ssd_scan_bf16_matches_reference(dt_dtype):
    """bf16 x, b and c (and dt): y in bf16, rounded once from float32;
    the state stays float32 and, computed from the same bf16 values, is
    held at the float32 tolerance."""
    B, S, H, G, P, N, chunk = 2, 64, 4, 2, 16, 32, 32
    ref, port = _inputs(11, B, S, H, G, P, N, BF16, dt_dtype)
    y, state = ops.ssd_scan(*port, chunk=chunk)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    y_k, s_k = ref_ops.ssd_scan(*ref, chunk=chunk)
    assert y_k.dtype == BF16
    _close(y, y_k, BF16_TOL)
    _close(state, s_k, KERNEL_TOL)
    # one rounding: the bf16 y is the float32 scan of the same values
    y32, s32 = ops.ssd_scan(port[0].float(), port[1].float(), port[2],
                            port[3].float(), port[4].float(), chunk=chunk)
    assert torch.equal(y, y32.to(torch.bfloat16))
    assert torch.equal(state, s32)


@pytest.mark.parametrize("dt_dtype", [F32, F16])
def test_ssd_scan_float16_matches_reference(dt_dtype):
    """float16 x, b and c (and dt): y in float16, the state float32,
    against the reference's Pallas kernel in interpret mode; y is the
    float32 scan of the same values rounded once."""
    B, S, H, G, P, N, chunk = 2, 64, 4, 2, 16, 32, 32
    ref, port = _inputs(12, B, S, H, G, P, N, F16, dt_dtype)
    y, state = ops.ssd_scan(*port, chunk=chunk)
    assert y.dtype == torch.float16 and state.dtype == torch.float32
    y_k, s_k = ref_ops.ssd_scan(*ref, chunk=chunk)
    assert y_k.dtype == F16
    _close(y, y_k, F16_TOL)
    _close(state, s_k, KERNEL_TOL)
    y32, s32 = ops.ssd_scan(port[0].float(), port[1].float(), port[2],
                            port[3].float(), port[4].float(), chunk=chunk)
    assert torch.equal(y, y32.to(torch.float16))
    assert torch.equal(state, s32)


@pytest.mark.parametrize("B,S,H,G,P,N,chunk,dtype", [
    # P past 64 and N past 128 (the kernel's column blocks and slices), a
    # chunk of 2,048 (past the 1,024 the kernel once capped), and P, N
    # off every tile width
    (1, 4096, 2, 1, 128, 256, 2048, F32),
    (1, 4096, 2, 1, 128, 256, 2048, F16),
    (2, 256, 2, 1, 130, 260, 64, F32),
    (1, 256, 4, 2, 128, 256, 128, BF16),
])
def test_ssd_scan_whole_domain_matches_reference(B, S, H, G, P, N, chunk,
                                                 dtype):
    """Shapes the reference's kernel takes and B8 once refused on the
    card: against the Pallas kernel in interpret mode.  Over a 2,048-long
    chunk the cumulative decay reaches the thousands, and float32 cumsums
    put both sides ~4e-3 (of 1 + |value|) from a float64 evaluation, by
    different amounts: there the port is held to ``ssd_chunked`` in
    float64, no further from it than the reference's kernel (or within
    the kernel tolerance), as the card holds B8."""
    ref, port = _inputs(P + N + chunk, B, S, H, G, P, N, dtype)
    y, state = ops.ssd_scan(*port, chunk=chunk)
    assert y.shape == (B, S, H, P) and state.shape == (B, H, P, N)
    y_k, s_k = ref_ops.ssd_scan(*ref, chunk=chunk)
    if chunk <= 256:
        _close(y, y_k, {F32: KERNEL_TOL, BF16: BF16_TOL, F16: F16_TOL}[dtype])
        _close(state, s_k, KERNEL_TOL)
        return
    truth = port_layers.ssd_chunked(*port, chunk, dtype=torch.float64)
    for got, want, exact in zip((y, state), (y_k, s_k), truth):
        def rel(t):
            t = torch.as_tensor(np.asarray(t, np.float64))
            return float(((t - exact).abs() / (1 + exact.abs())).max())
        assert rel(got.double()) <= max(rel(want), KERNEL_TOL)


def test_ssd_scan_contracts_raise():
    _, (x, dt, a, b, c) = _inputs(3, 1, 48, 4, 2, 8, 8)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ops.ssd_scan(x, dt, a, b, c, chunk=32)
    with pytest.raises(ValueError, match="H % G"):
        ops.ssd_scan(x, dt, a, b[:, :, :1].expand(-1, -1, 3, -1),
                     c[:, :, :1].expand(-1, -1, 3, -1), chunk=16)
    meta = [t.to("meta") for t in (x, dt, a, b, c)]
    with pytest.raises(ValueError, match="no kernel"):
        ops.ssd_scan(*meta, chunk=16)
    before = ops.ssd_scan.launches
    ops.ssd_scan(x, dt, a, b, c, chunk=16)        # CPU: the plain version
    assert ops.ssd_scan.launches == before


def _meta_ssd(B, S, H, G, P, N, dtype=torch.float32, dt_dtype=None,
              a_dtype=torch.float32, bc_dtype=None):
    """``meta`` tensors of the B8 inputs' shapes and dtypes: nothing is
    allocated, and any read of a value would raise."""
    def m(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")
    bc = bc_dtype or dtype
    return (m((B, S, H, P), dtype), m((B, S, H), dt_dtype or torch.float32),
            m((H,), a_dtype), m((B, S, G, N), bc), m((B, S, G, N), bc))


@pytest.mark.parametrize("B,S,H,G,P,N,dtype", [
    # chip_smoke's phase 6 cases: mamba2-780m fp32 and bf16, hymba-1.5b's
    # SSM heads, G = H, one chunk, the decay edges, the ragged edge (P 20,
    # N 10, chunk 48: zero-padded tiles) and G 4 of H 48
    (2, 4096, 48, 1, 64, 128, torch.float32),
    (2, 4096, 48, 1, 64, 128, torch.bfloat16),
    (2, 4096, 50, 1, 64, 16, torch.bfloat16),
    (1, 512, 48, 48, 64, 128, torch.float32),
    (1, 256, 48, 1, 64, 128, torch.float32),
    (1, 1024, 48, 1, 64, 128, torch.float32),
    (1, 96, 3, 1, 20, 10, torch.float32),
    (1, 1024, 48, 4, 64, 128, torch.float32),
    # float16, and P past 64 / N past 128 (phase 15's cases)
    (2, 4096, 48, 1, 64, 128, torch.float16),
    (1, 4096, 8, 1, 128, 256, torch.float32),
    (1, 4096, 8, 1, 128, 256, torch.float16),
    (1, 64, 4, 2, 65, 129, torch.bfloat16),
])
def test_ssd_scan_route(B, S, H, G, P, N, dtype):
    """Every shape the kernel takes goes to the split-TF32 ``mma``
    kernel: there is no scalar route left."""
    assert ssd_scan_route(*_meta_ssd(B, S, H, G, P, N, dtype)) == "mma"
    for dt_dtype in (torch.bfloat16, torch.float16):
        assert ssd_scan_route(*_meta_ssd(B, S, H, G, P, N, dtype,
                                         dt_dtype=dt_dtype)) == "mma"


@pytest.mark.parametrize("kwargs,error,match", [
    ({"dtype": torch.float64}, TypeError, "float32, bfloat16 or float16"),
    ({"bc_dtype": torch.bfloat16}, TypeError, "one dtype for all"),
    ({"dt_dtype": torch.float64}, TypeError, "float32, bfloat16 or float16"),
    ({"a_dtype": torch.bfloat16}, TypeError, "a must be float32"),
    ({"a_dtype": torch.float16}, TypeError, "a must be float32"),
    ({"dtype": torch.float16, "bc_dtype": torch.float32}, TypeError,
     "one dtype for all"),
])
def test_ssd_scan_route_refuses(kwargs, error, match):
    """What the kernel cannot take raises before any launch: dtypes
    other than float32 / bfloat16 / float16 or mixed among x, b and c,
    and a that is not float32.  (P and N are no longer capped: P 65 and
    N 129, once refused here, are ``test_ssd_scan_route`` cases.)"""
    shape = {"B": 1, "S": 64, "H": 4, "G": 2, "P": 16, "N": 32}
    with pytest.raises(error, match=match):
        ssd_scan_route(*_meta_ssd(**shape, **kwargs))


def test_ssd_scan_single_chunk_and_strided_views():
    """One chunk (no carry), and x, b, c as strided views of one buffer,
    as the model slices them out of its conv output."""
    B, S, H, P, N = 2, 32, 2, 16, 8
    rng = np.random.default_rng(5)
    buf = rng.standard_normal((B, S, H * P + 2 * N)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(H)).astype(np.float32)
    tb = torch.from_numpy(buf)
    x = tb[..., :H * P].reshape(B, S, H, P)
    b = tb[..., H * P:H * P + N].reshape(B, S, 1, N)
    c = tb[..., H * P + N:].reshape(B, S, 1, N)
    assert not x.is_contiguous()
    y, state = ops.ssd_scan(x, torch.from_numpy(dt), torch.from_numpy(a), b,
                            c, chunk=S)
    jx = jnp.asarray(buf[..., :H * P].reshape(B, S, H, P))
    jb = jnp.asarray(buf[..., H * P:H * P + N].reshape(B, S, 1, N))
    jc = jnp.asarray(buf[..., H * P + N:].reshape(B, S, 1, N))
    y_k, s_k = ref_ops.ssd_scan(jx, jnp.asarray(dt), jnp.asarray(a), jb, jc,
                                chunk=S)
    _close(y, y_k, KERNEL_TOL)
    _close(state, s_k, KERNEL_TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_ref_ssd_chunk_matches_reference(with_state):
    B, L, H, P, N = 2, 16, 3, 8, 12
    ref, port = _inputs(21, B, L, H, H, P, N)
    init = None
    if with_state:
        s0 = np.random.default_rng(22).standard_normal(
            (B, H, P, N)).astype(np.float32)
        init = (jnp.asarray(s0), torch.from_numpy(s0))
    y_r, s_r = ref_oracle.ref_ssd_chunk(*ref, None if init is None
                                        else init[0])
    y, s = port_ref.ref_ssd_chunk(*port, None if init is None else init[1])
    _close(y, y_r, ORACLE_TOL)
    _close(s, s_r, ORACLE_TOL)


def test_segsum_matches_reference():
    x = np.random.default_rng(9).standard_normal((2, 3, 17)).astype(
        np.float32)
    want = np.asarray(ref_layers._segsum(jnp.asarray(x)))
    got = port_layers._segsum(torch.from_numpy(x)).numpy()
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    assert np.array_equal(got[~fin], want[~fin])
    np.testing.assert_allclose(got[fin], want[fin], rtol=ORACLE_TOL,
                               atol=ORACLE_TOL)


@pytest.mark.parametrize("G,with_state", [(1, False), (2, True), (4, False)])
def test_ssd_chunked_matches_reference(G, with_state):
    B, S, H, P, N, chunk = 2, 32, 4, 8, 16, 8
    ref, port = _inputs(31 + G, B, S, H, G, P, N)
    kw_ref, kw_port = {}, {}
    if with_state:
        s0 = np.random.default_rng(32).standard_normal(
            (B, H, P, N)).astype(np.float32)
        kw_ref["init_state"] = jnp.asarray(s0)
        kw_port["init_state"] = torch.from_numpy(s0)
    y_r, s_r = ref_layers.ssd_chunked(*ref, chunk, **kw_ref)
    y, s = port_layers.ssd_chunked(*port, chunk, **kw_port)
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    _close(y, y_r, ORACLE_TOL)
    _close(s, s_r, ORACLE_TOL)
    # the plain algorithm and the kernel's plain version agree too
    if not with_state:
        y_o, s_o = ops.ssd_scan(*port, chunk=chunk)
        _close(y_o, y_r, KERNEL_TOL)
        _close(s_o, s_r, KERNEL_TOL)


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_chunked_float64_matches_recurrence(G):
    """``ssd_chunked`` in float64, the evaluation B8 is held to for
    accuracy on the card, against the SSD recurrence stepped one position
    at a time in float64 on the same inputs."""
    B, S, H, P, N, chunk = 2, 48, 4, 8, 16, 16
    _, (x, dt, a, b, c) = _inputs(41 + G, B, S, H, G, P, N)
    y, s = port_layers.ssd_chunked(x, dt, a, b, c, chunk,
                                   dtype=torch.float64)
    assert y.dtype == torch.float64 and s.dtype == torch.float64
    xn, dtn, an = (t.double().numpy() for t in (x, dt, a))
    bh = np.repeat(b.double().numpy(), H // G, axis=2)
    ch = np.repeat(c.double().numpy(), H // G, axis=2)
    st = np.zeros((B, H, P, N))
    ys = []
    for t in range(S):
        dec = np.exp(dtn[:, t] * an[None, :])
        st = st * dec[..., None, None] + np.einsum(
            "bh,bhp,bhn->bhpn", dtn[:, t], xn[:, t], bh[:, t])
        ys.append(np.einsum("bhpn,bhn->bhp", st, ch[:, t]))
    np.testing.assert_allclose(y.numpy(), np.stack(ys, 1), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(s.numpy(), st, rtol=1e-10, atol=1e-10)
