"""The port's two kernel modules on the CPU: each plain PyTorch version
(the path a wrapper takes for CPU tensors) against the reference's
Pallas kernel in interpret mode and the reference's XLA twin, on the
same numpy inputs made from a seed.

Grades: booleans, round counts, min/max and first-crossing outputs are
exact; the availability integral is a float32 sum in another order,
held to rtol=3e-6 as the reference's own kernel test holds it."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ufa import propagation as ref_prop  # noqa: E402
from repro.kernels.ufa import reduce as ref_red  # noqa: E402
from repro_torch.kernels.ufa import propagation as port_prop  # noqa: E402
from repro_torch.kernels.ufa import reduce as port_red  # noqa: E402

THRESH = 0.999
EXACT_REDUCE = ("avail_min", "util_peak", "cloud_peak", "restore_t",
                "below_seen")


# ---------------------------------------------------------------------------
# B1: segmented timeline verdict reduction
# ---------------------------------------------------------------------------


def _series(seed, S=37, T=240, R=6):
    """Tier fractions hovering around the threshold, plus hand-set rows:
    a tier never below, one below at t=0 and back at t=1, one below from
    the middle to the end, and one below only at the last step."""
    rng = np.random.default_rng(seed)
    avail = (0.999 + 0.001 * rng.random((S, T))).astype(np.float32)
    util = (rng.random((S, T)) * 1.5).astype(np.float32)
    cloud = (rng.random((S, T)) * 1e5 - 1e4).astype(np.float32)
    frac = (0.995 + 0.01 * rng.random((S, T, R))).astype(np.float32)
    frac[0] = 1.0                              # never below
    frac[1, 0, :] = 0.5                        # below at t=0 only
    frac[1, 1:, :] = 1.0
    frac[2, T // 2:, 0] = 0.5                  # below from the middle on
    frac[2, :T // 2, 0] = 1.0
    frac[3, :, 1] = 1.0
    frac[3, -1, 1] = 0.5                       # below at the last step only
    ts = (np.arange(T) * 30.0).astype(np.float32)
    return avail, util, cloud, frac, ts


def _to_np(d):
    return {k: np.asarray(v) for k, v in d.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_timeline_reduce_plain_matches_reference(seed):
    avail, util, cloud, frac, ts = _series(seed)
    j = [jnp.asarray(a) for a in (avail, util, cloud, frac, ts)]
    pallas = _to_np(ref_red.timeline_reduce(*j, thresh=THRESH, block_s=8))
    xla = _to_np(ref_red.ref_timeline_reduce(*j, thresh=THRESH))
    t = [torch.from_numpy(a) for a in (avail, util, cloud, frac, ts)]
    plain = _to_np(port_red.ref_timeline_reduce(*t, thresh=THRESH))
    via_wrapper = _to_np(port_red.timeline_reduce(*t, thresh=THRESH))
    assert set(plain) == set(pallas)
    for k in EXACT_REDUCE:
        assert plain[k].dtype == pallas[k].dtype, k
        assert np.array_equal(plain[k], pallas[k]), k
        assert np.array_equal(plain[k], xla[k]), k
        assert np.array_equal(via_wrapper[k], plain[k]), k
    np.testing.assert_allclose(plain["avail_int"], pallas["avail_int"],
                               rtol=3e-6)
    np.testing.assert_allclose(plain["avail_int"], xla["avail_int"],
                               rtol=3e-6)
    # the hand-set rows
    assert not plain["below_seen"][0].any()
    assert np.isinf(plain["restore_t"][0]).all()
    assert (plain["restore_t"][1] == ts[1]).all()
    assert plain["below_seen"][2, 0] and np.isinf(plain["restore_t"][2, 0])
    assert plain["below_seen"][3, 1] and np.isinf(plain["restore_t"][3, 1])


def test_timeline_reduce_padded_rows_and_single_step():
    """S not a multiple of the reference's block (its padded rows carry
    tier_frac 1.0 and must not leak), and T == 1 (dt[0] == 0)."""
    avail, util, cloud, frac, ts = _series(5, S=19, T=33, R=3)
    j = [jnp.asarray(a) for a in (avail, util, cloud, frac, ts)]
    pallas = _to_np(ref_red.timeline_reduce(*j, thresh=THRESH, block_s=8))
    t = [torch.from_numpy(a) for a in (avail, util, cloud, frac, ts)]
    plain = _to_np(port_red.timeline_reduce(*t, thresh=THRESH))
    for k in EXACT_REDUCE:
        assert np.array_equal(plain[k], pallas[k]), k
    one = port_red.timeline_reduce(
        torch.ones(2, 1), torch.zeros(2, 1), torch.zeros(2, 1),
        torch.ones(2, 1, 3), torch.from_numpy(ts[:1]), thresh=THRESH)
    assert one["avail_int"].tolist() == [0.0, 0.0]
    assert not one["below_seen"].any()


def test_timeline_reduce_cpu_launches_no_kernel():
    before = port_red.timeline_reduce.launches
    avail, util, cloud, frac, ts = _series(0, S=4, T=8, R=2)
    port_red.timeline_reduce(*[torch.from_numpy(a) for a in
                               (avail, util, cloud, frac, ts)],
                             thresh=THRESH)
    assert port_red.timeline_reduce.launches == before


# ---------------------------------------------------------------------------
# B2: ELL propagation fixed point
# ---------------------------------------------------------------------------


def _random_csr(rng, n, p_edge=0.15, p_close=0.5):
    m = rng.random((n, n)) < p_edge
    np.fill_diagonal(m, False)
    src, dst = np.nonzero(m)
    closed = rng.random(len(src)) < p_close
    indptr = np.searchsorted(src, np.arange(n + 1)).astype(np.int64)
    return indptr, src.astype(np.int32), dst.astype(np.int32), closed


def _both(dark, ell_dst, ell_closed):
    ref = ref_prop.fixed_point_ell(jnp.asarray(dark), jnp.asarray(ell_dst),
                                   jnp.asarray(ell_closed))
    got = port_prop.fixed_point_ell(torch.from_numpy(dark),
                                    torch.from_numpy(ell_dst),
                                    torch.from_numpy(ell_closed))
    return (np.asarray(ref[0]), int(ref[1])), (got[0].numpy(), int(got[1]))


@pytest.mark.parametrize("seed", range(6))
def test_fixed_point_plain_matches_reference(seed):
    """Random cyclic graphs x random dark batches: broken matrix AND round
    count exact against the Pallas kernel (interpret) and the reference's
    scatter-max twin."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 80))
    indptr, src, dst, closed = _random_csr(rng, n)
    ell_dst, ell_closed, slot = port_prop.ell_from_csr(n, indptr, dst, closed)
    want = ref_prop.ell_from_csr(n, indptr, dst, closed)
    for a, b in zip((ell_dst, ell_closed, slot), want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    dark = rng.random((5, n)) < rng.uniform(0.05, 0.5)
    (rb, rr), (gb, gr) = _both(dark, ell_dst, ell_closed)
    assert np.array_equal(gb, rb) and gr == rr
    xb, xr = ref_prop.ref_fixed_point(jnp.asarray(dark), jnp.asarray(src),
                                      jnp.asarray(dst), jnp.asarray(closed))
    assert np.array_equal(gb, np.asarray(xb)) and gr == int(xr)


def test_fixed_point_cycle_and_fail_open_boundary():
    # a->b, b->c, c->a fail-close (a cycle), c->d fail-close, b->e
    # fail-OPEN: darkening d breaks the whole cycle but spares e
    src = np.array([0, 1, 1, 2, 2], np.int32)
    dst = np.array([1, 2, 4, 0, 3], np.int32)
    closed = np.array([True, True, False, True, True])
    indptr = np.searchsorted(src, np.arange(6)).astype(np.int64)
    ell_dst, ell_closed, _ = port_prop.ell_from_csr(5, indptr, dst, closed)
    dark = np.zeros((2, 5), bool)
    dark[0, 3] = True
    dark[1, 4] = True
    (rb, rr), (gb, gr) = _both(dark, ell_dst, ell_closed)
    assert gb[0].tolist() == [True, True, True, True, False]
    assert gb[1].tolist() == [False, False, False, False, True]
    assert np.array_equal(gb, rb) and gr == rr


def test_fixed_point_long_chain_round_count():
    """A 30-hop fail-close chain: Jacobi rounds move one hop each, so the
    round count is the chain length plus the final no-change round."""
    n = 31
    src = np.arange(1, n, dtype=np.int32)          # u calls u - 1
    dst = np.arange(0, n - 1, dtype=np.int32)
    indptr = np.searchsorted(src, np.arange(n + 1)).astype(np.int64)
    ell_dst, ell_closed, _ = port_prop.ell_from_csr(
        n, indptr, dst, np.ones(n - 1, bool))
    dark = np.zeros((3, n), bool)
    dark[0, 0] = True
    dark[1, 15] = True
    (rb, rr), (gb, gr) = _both(dark, ell_dst, ell_closed)
    assert gr == rr == n
    assert np.array_equal(gb, rb)
    assert gb[0].all() and not gb[1, :15].any() and gb[1, 15:].all()
    assert not gb[2].any()


def test_fixed_point_empty_cases():
    # edge-free graph: K == 0, one no-change round, broken == dark
    ell_dst, ell_closed, slot = port_prop.ell_from_csr(
        6, np.zeros(7, np.int64), np.zeros(0, np.int64), np.zeros(0, bool))
    assert ell_dst.shape == (6, 0) and slot.shape == (0,)
    dark = np.eye(6, dtype=bool)[:3]
    (rb, rr), (gb, gr) = _both(dark, ell_dst, ell_closed)
    assert np.array_equal(gb, dark) and gr == rr == 1
    # empty scenario batch
    rng = np.random.default_rng(1)
    indptr, _, dst, closed = _random_csr(rng, 10)
    ed, ec, _ = port_prop.ell_from_csr(10, indptr, dst, closed)
    (rb, rr), (gb, gr) = _both(np.zeros((0, 10), bool), ed, ec)
    assert gb.shape == (0, 10) and gr == rr == 1


def test_fixed_point_cpu_launches_no_kernel():
    before = port_prop.fixed_point_ell.launches
    rng = np.random.default_rng(2)
    indptr, _, dst, closed = _random_csr(rng, 12)
    ed, ec, _ = port_prop.ell_from_csr(12, indptr, dst, closed)
    port_prop.fixed_point_ell(torch.from_numpy(rng.random((2, 12)) < 0.3),
                              torch.from_numpy(ed), torch.from_numpy(ec))
    assert port_prop.fixed_point_ell.launches == before
