"""The port's attention, MLP and MoE layers on the CPU: each function of
``repro_torch.models.layers`` against the reference's
``repro.models.layers`` on the same inputs (made from a seed with numpy)
and the same weights (the reference's initializers, carried across with
``repro_torch.convert.params_from_reference``).

Grades: float32 outputs at rtol = atol = 1e-4 (the layers run B6's, B5's
and B7's plain versions on the CPU, whose sums run in other orders than
XLA's); the rotary embedding at rtol 1e-5 (XLA's and PyTorch's
``pow`` / ``cos`` / ``sin`` may differ by a few ulps); int8 values,
masks, expert ids and queue positions exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as ref_layers  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.models import layers  # noqa: E402

TOL = 1e-4
ROPE_RTOL = 1e-5


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _both(a):
    """A numpy array as (a JAX array, a CPU tensor)."""
    return jnp.asarray(a), torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# norms and rotary embeddings
# ---------------------------------------------------------------------------


def test_rmsnorm_noscale_matches_reference():
    jx, tx = _both(_normal(0, (3, 5, 4, 32), 3.0))
    _close(layers.rmsnorm_noscale(tx), ref_layers.rmsnorm_noscale(jx), 1e-6)


@pytest.mark.parametrize("d_head,theta", [(128, 5e5), (64, 1e4),
                                          (256, 1e6), (16, 75e6)])
def test_rope_matches_reference(d_head, theta):
    """Positions up to 4,096: angles of thousands of radians, where the
    two libraries' cos / sin may differ by ulps."""
    np.testing.assert_allclose(
        layers.rope_frequencies(d_head, theta).numpy(),
        np.asarray(ref_layers.rope_frequencies(d_head, theta)),
        rtol=ROPE_RTOL, atol=0)
    x = _normal(1, (2, 64, 3, d_head))
    pos = np.stack([np.arange(64), np.arange(4033, 4097)]).astype(np.int32)
    want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=ROPE_RTOL, atol=ROPE_RTOL)


def test_rope_rotates_halves_not_pairs():
    """A unit vector in the first half at dim 0 rotates into dim d/2."""
    x = torch.zeros((1, 1, 1, 8))
    x[..., 0] = 1.0
    out = layers.apply_rope(x, torch.tensor([[1]]), 1.0)
    assert abs(float(out[..., 0]) - np.cos(1.0)) < 1e-6
    assert abs(float(out[..., 4]) - np.sin(1.0)) < 1e-6
    assert float(out[..., 1].abs()) == 0.0


# ---------------------------------------------------------------------------
# attention pieces
# ---------------------------------------------------------------------------


def test_quantize_kv_exact():
    x = _normal(2, (2, 7, 3, 16), 2.0)
    x[0, 0, 0] = 0.0                                 # the 1e-8 scale floor
    x[1, 2, 1, 3] = 40.0                             # one large outlier
    wq, ws = ref_layers.quantize_kv(jnp.asarray(x))
    gq, gs = layers.quantize_kv(torch.from_numpy(x))
    assert gq.dtype == torch.int8 and gs.dtype == torch.float32
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


@pytest.mark.parametrize("window", [0, 1, 3, 8, 100])
def test_attn_mask_exact(window):
    q_pos = np.array([0, 5, 9, 17], np.int32)
    k_pos = np.arange(20, dtype=np.int32)
    want = ref_layers._attn_mask(jnp.asarray(q_pos), jnp.asarray(k_pos),
                                 window)
    got = layers._attn_mask(torch.from_numpy(q_pos), torch.from_numpy(k_pos),
                            window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("window,block", [(4, 4), (3, 4), (1, 8), (8, 8)])
def test_blocked_local_attention_matches_reference(window, block):
    q, k, v = (_normal(3 + i, (2, 32, 4, 16)) for i in range(3))
    scale = 1.0 / 4.0
    want = ref_layers._blocked_local_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window, block, scale)
    got = layers._blocked_local_attention(
        *map(torch.from_numpy, (q, k, v)), window, block, scale)
    _close(got, want)


# ---------------------------------------------------------------------------
# the attention layer
# ---------------------------------------------------------------------------

ATTN = dict(n_heads=8, n_kv_heads=2, d_head=16)


def _attn_params(qk_norm, seed=0, n_heads=8, n_kv_heads=2, d_model=64):
    rp = ref_layers.init_attention(jax.random.PRNGKey(seed), d_model, n_heads,
                                   n_kv_heads, 16, qk_norm)
    if qk_norm:   # non-unit scales, so that the norms' scales count
        rng = np.random.default_rng(seed)
        for n in ("q_norm", "k_norm"):
            rp[n] = {"scale": jnp.asarray(
                1 + 0.3 * rng.standard_normal(16).astype(np.float32))}
    return rp, params_from_reference(rp, device="cpu")


@pytest.mark.parametrize("window,qk_norm,theta,heads", [
    (0, False, 1e4, (8, 2)), (0, True, 5e5, (8, 2)), (5, False, 1e4, (8, 2)),
    (5, True, 1e3, (4, 4)), (0, False, 1e6, (8, 1))])
def test_attention_prefill_matches_reference(window, qk_norm, theta, heads):
    n_heads, n_kv = heads
    rp, pp = _attn_params(qk_norm, n_heads=n_heads, n_kv_heads=n_kv)
    kw = dict(n_heads=n_heads, n_kv_heads=n_kv, d_head=16, theta=theta,
              window=window, qk_norm=qk_norm)
    jx, tx = _both(_normal(5, (2, 24, 64)))
    want, _ = ref_layers.attention(rp, jx, **kw)
    got, cache = layers.attention(pp, tx, **kw)
    assert cache is None and got.shape == tuple(want.shape)
    _close(got, want)


@pytest.mark.parametrize("window", [0, 4, 8])
def test_attention_blocked_local_matches_reference(window):
    """The reference with ``local_block=8`` (its blocked local attention
    for windowed layers; full attention for global ones) against the
    port's attention, where B6 applies the window itself."""
    rp, pp = _attn_params(False)
    kw = dict(ATTN, theta=1e4, window=window)
    jx, tx = _both(_normal(6, (2, 32, 64)))
    want, _ = ref_layers.attention(rp, jx, local_block=8, **kw)
    _close(layers.attention(pp, tx, **kw)[0], want)


def _caches(kind, B=2, K=12, KV=2, d=16):
    """(reference caches, the port's) holding earlier tokens: bf16 values
    for "bf16", int8 values with scales for "int8", float32 otherwise."""
    rng = np.random.default_rng(7)
    if kind == "int8":
        vals = [rng.integers(-127, 128, (B, K, KV, d)).astype(np.int8)
                for _ in range(2)]
        vals += [(rng.random((B, K, KV)) * 0.05 + 1e-3).astype(np.float32)
                 for _ in range(2)]
        ref = tuple(jnp.asarray(v) for v in vals)
    else:
        dt = jnp.bfloat16 if kind == "bf16" else jnp.float32
        ref = tuple(jnp.asarray(rng.standard_normal((B, K, KV, d)), dt)
                    for _ in range(2))
    return ref, tuple(params_from_reference({"c": c}, "cpu")["c"]
                      for c in ref)


@pytest.mark.parametrize("kind,window,start,S", [
    ("bf16", 0, 5, 1), ("bf16", 3, 9, 1), ("f32", 0, 0, 1),
    ("f32", 4, 6, 3), ("int8", 0, 4, 1), ("int8", 2, 7, 2),
    ("bf16", 0, 12, 1), ("f32", 5, 14, 2), ("int8", 0, 11, 3)])
def test_attention_decode_matches_reference(kind, window, start, S):
    """Decode against a cache of 12 slots, for a float32 model: a bf16
    cache (cast to float32 before B5), a float32 one, the int8 one
    (dequantised).  ``start`` at or past ``12 - S`` takes
    ``dynamic_update_slice``'s clamp: the last S slots are written.  The
    caches given are updated in place and returned."""
    rp, pp = _attn_params(True)
    ref_cache, cache = _caches(kind)
    kw = dict(ATTN, theta=1e4, window=window, qk_norm=True)
    jx, tx = _both(_normal(8, (2, S, 64)))
    want, want_cache = ref_layers.attention(
        rp, jx, kv_cache=ref_cache, cache_len=jnp.asarray(start, jnp.int32),
        **kw)
    got, got_cache = layers.attention(
        pp, tx, kv_cache=cache, cache_len=torch.tensor(start,
                                                       dtype=torch.int32),
        **kw)
    assert all(g is c for g, c in zip(got_cache, cache))
    _close(got, want)
    for g, w in zip(got_cache, want_cache):   # int8 values exact
        if g.dtype == torch.int8:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            _close(g, w)


# ---------------------------------------------------------------------------
# MLP and MoE
# ---------------------------------------------------------------------------


def test_mlp_matches_reference():
    rp = ref_layers.init_mlp(jax.random.PRNGKey(1), 64, 96)
    pp = params_from_reference(rp, "cpu")
    jx, tx = _both(_normal(9, (2, 5, 64)))
    _close(layers.mlp(pp, tx), ref_layers.mlp(rp, jx))


def _router(seed, D=64, E=8):
    return _normal(seed, (D, E), 0.3)


@pytest.mark.parametrize("E,top_k", [(8, 2), (16, 2), (384, 8)])
def test_moe_routing_matches_reference(E, top_k):
    w = _router(10, E=E)
    x = _normal(11, (40, 64))
    want = ref_layers.moe_routing(jnp.asarray(w), jnp.asarray(x), top_k)
    got = layers.moe_routing(torch.from_numpy(w), torch.from_numpy(x), top_k)
    _close(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    _close(got[2], want[2])


def test_moe_routing_ties_take_the_lower_index():
    """Tied probabilities (a zero router row block, zero tokens, equal
    columns) choose the lower expert first, as ``lax.top_k`` does."""
    w = _router(12)
    w[:, 3] = w[:, 6]                      # experts 3 and 6 always tie
    w[:, 1] = w[:, 6]                      # and 1 with them
    x = _normal(13, (24, 64))
    x[:8] = 0.0                            # every expert ties
    for top_k in (1, 2, 3):
        want = ref_layers.moe_routing(jnp.asarray(w), jnp.asarray(x), top_k)
        got = layers.moe_routing(torch.from_numpy(w), torch.from_numpy(x),
                                 top_k)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert (got[1][:8] == torch.arange(top_k)).all()
        _close(got[0], want[0])


@pytest.mark.parametrize("E,k,T", [(8, 2, 50), (16, 2, 64), (384, 8, 96)])
def test_expert_positions_match_reference(E, k, T):
    rng = np.random.default_rng(E + T)
    top_e = np.stack([rng.choice(E, k, replace=False) for _ in range(T)]
                     ).astype(np.int32)
    top_e[: T // 4, 0] = 3                   # crowd one expert's queue
    want = ref_layers._expert_positions(jnp.asarray(top_e), E)
    want_big = ref_layers._expert_positions_big(jnp.asarray(top_e), E)
    t = torch.from_numpy(top_e).long()
    np.testing.assert_array_equal(
        layers._expert_positions(t, E).numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        layers._expert_positions_big(t, E).numpy(), np.asarray(want_big))


@pytest.mark.parametrize("E,top_k,capacity,shared,start,n_local", [
    (8, 2, 8, 0, 0, None),       # tight capacity: slots dropped
    (8, 2, 32, 1, 0, None),      # roomy, with a shared expert
    (4, 2, 8, 2, 0, None),
    (8, 2, 16, 0, 3, 3),         # a local slab of experts 3-5
    (64, 4, 8, 0, 0, None),      # the sort-based positions
])
def test_moe_apply_local_matches_reference(E, top_k, capacity, shared, start,
                                           n_local):
    rp = ref_layers.init_moe(jax.random.PRNGKey(E), 64, E, 48, shared)
    if n_local is not None:
        for n in ("w_gate", "w_up", "w_down"):
            rp[n] = rp[n][start:start + n_local]
    pp = params_from_reference(rp, "cpu")
    jx, tx = _both(_normal(14, (40, 64)))
    kw = dict(top_k=top_k, capacity=capacity, n_experts=E,
              expert_start=start, n_local_experts=n_local)
    want_y, want_aux = ref_layers.moe_apply_local(rp, jx, **kw)
    got_y, got_aux = layers.moe_apply_local(pp, tx, **kw)
    _close(got_y, want_y)
    _close(got_aux, want_aux)
