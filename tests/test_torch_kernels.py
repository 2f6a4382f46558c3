"""The port's three kernel modules on the CPU: each plain PyTorch version
(the path a wrapper takes for CPU tensors) against the reference's
Pallas kernel in interpret mode and the reference's XLA twin, on the
same numpy inputs made from a seed.

Grades: booleans, round counts, histogram counts, min/max and
first-crossing outputs are exact; the availability integral is a float32 sum in another order,
held to rtol=3e-6 as the reference's own kernel test holds it."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ufa import ingest as ref_ing  # noqa: E402
from repro.kernels.ufa import propagation as ref_prop  # noqa: E402
from repro.kernels.ufa import reduce as ref_red  # noqa: E402
from repro_torch.kernels import backend  # noqa: E402
from repro_torch.kernels.ufa import ingest as port_ing  # noqa: E402
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
# B1: the wrapper's output views; a numpy model of the kernel's walk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,R", [(4_096, 7), (5, 8), (1, 1), (0, 3)])
def test_timeline_reduce_output_views_on_meta(S, R):
    """The wrapper's one float32 buffer (stats, then restore_t) and one
    bool array give the plain version's keys, shapes and dtypes."""
    buf, seen, out = port_red._outputs(S, R, "meta")
    assert buf.shape == (S * (4 + R),) and buf.dtype == torch.float32
    assert seen.shape == (S, R) and seen.dtype == torch.bool
    want = port_red.ref_timeline_reduce(
        torch.ones(S, 2), torch.ones(S, 2), torch.ones(S, 2),
        torch.ones(S, 2, R), torch.arange(2.0), thresh=THRESH)
    assert list(out) == list(want)
    for k, w in want.items():
        assert out[k].device.type == "meta", k
        assert (out[k].shape, out[k].dtype) == (w.shape, w.dtype), k
    # the four stats are the columns of one (S, 4) array, restore_t follows
    assert out["avail_int"].stride() == (4,)
    assert out["util_peak"].storage_offset() == 2
    assert out["restore_t"].storage_offset() == 4 * S
    assert out["restore_t"].stride() == (R, 1)


FULL = 0xFFFFFFFF
MODEL_ROWS_PER_BLOCK = 8    # csrc/timeline_reduce.cu's ROWS_PER_BLOCK
MODEL_WINDOWS = 4           # ... and WINDOWS: 32-step windows loaded at once


def _ballot(pred):
    """A warp's ``__ballot_sync``: lane l's predicate in bit l."""
    return int(np.dot(pred.astype(np.int64), 1 << np.arange(32)))


def _ffs(x):
    """``__ffs``: the 1-based index of the lowest set bit, 0 for none."""
    return (x & -x).bit_length()


def _model_stats(a, u, c, dt):
    """One warp's ``row_stats``: lane-strided float32 sums and extrema
    over loads of ``MODEL_WINDOWS`` windows (each lane's steps clamped to
    the row's last, the sums predicated), finished by xor butterflies."""
    T = len(a)
    lanes = np.arange(32)
    acc = np.zeros(32, np.float32)
    amin = np.full(32, np.inf, np.float32)
    umax = np.full(32, -np.inf, np.float32)
    cmax = np.full(32, -np.inf, np.float32)
    for c0 in range(0, T, 32 * MODEL_WINDOWS):
        t = [np.minimum(c0 + 32 * w + lanes, T - 1)
             for w in range(MODEL_WINDOWS)]
        loads = [(a[tw], u[tw], c[tw], dt[tw]) for tw in t]
        for w, (av, uv, cv, d) in enumerate(loads):
            v = c0 + 32 * w + lanes < T
            acc[v] = acc[v] + av[v] * d[v]      # float32 mul, then add
            amin[v] = np.minimum(amin[v], av[v])
            umax[v] = np.maximum(umax[v], uv[v])
            cmax[v] = np.maximum(cmax[v], cv[v])
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[lanes ^ off]
        amin = np.minimum(amin, amin[lanes ^ off])
        umax = np.maximum(umax, umax[lanes ^ off])
        cmax = np.maximum(cmax, cmax[lanes ^ off])
    return np.array([acc[0], min(amin[0], np.float32(1)),
                     max(umax[0], np.float32(0)),
                     max(cmax[0], np.float32(0))], np.float32)


def _model_crossings(fr, ts, thresh):
    """One warp's ``row_crossings``: the loads and ballots (one a tier)
    of ``MODEL_WINDOWS`` 32-step windows first, each lane's step clamped
    to the row's last, then each window's logic in order with the carried
    warp-uniform ``seen`` and ``found`` flags; the first crossing kept as
    a step index and its time read at the end."""
    T, R = fr.shape
    lanes = np.arange(32)
    seen, found, cross_t = [False] * R, [False] * R, [0] * R
    for c0 in range(0, T, 32 * MODEL_WINDOWS):
        below = []
        for w in range(MODEL_WINDOWS):
            v = c0 + 32 * w + lanes < T
            f = fr[np.minimum(c0 + 32 * w + lanes, T - 1)]
            below.append([_ballot(v & (f[:, r] < np.float32(thresh)))
                          for r in range(R)])
        for w in range(MODEL_WINDOWS):
            t0 = c0 + 32 * w
            left = T - t0
            valid_bits = (FULL if left >= 32
                          else (1 << left) - 1 if left > 0 else 0)
            for r in range(R):
                b = below[w][r]
                # lanes after the window's first below lane, all once seen
                first = b & (-b & FULL)
                after = FULL if seen[r] else ~(((first << 1) & FULL) - 1) & FULL
                cross = 0 if found[r] else ~b & valid_bits & after
                cross_t[r] = t0 + _ffs(cross) - 1 if cross else cross_t[r]
                found[r] = found[r] or cross != 0
                seen[r] = seen[r] or b != 0
    rest = np.array([ts[cross_t[r]] if found[r] else np.inf
                     for r in range(R)], np.float32)
    return rest, np.array(seen)


def _model_timeline_reduce(avail, util, cloud, frac, ts, thresh):
    """The CUDA launch as a walk: eight rows a block, a warp a row, every
    row written exactly once."""
    S, T, R = frac.shape
    dt = np.zeros(T, np.float32)
    dt[1:] = np.maximum(ts[1:] - ts[:-1], np.float32(0))
    stats = np.full((S, 4), np.nan, np.float32)
    rest = np.full((S, R), np.nan, np.float32)
    seen = np.zeros((S, R), bool)
    written = np.zeros(S, int)
    for block in range(-(-S // MODEL_ROWS_PER_BLOCK)):
        for i in range(block * MODEL_ROWS_PER_BLOCK,
                       min(S, (block + 1) * MODEL_ROWS_PER_BLOCK)):
            rest[i], seen[i] = _model_crossings(frac[i], ts, thresh)
            stats[i] = _model_stats(avail[i], util[i], cloud[i], dt)
            written[i] += 1
    assert (written == 1).all()
    return {"avail_int": stats[:, 0], "avail_min": stats[:, 1],
            "util_peak": stats[:, 2], "cloud_peak": stats[:, 3],
            "restore_t": rest, "below_seen": seen}


def _crossing_series(S, T, R, seed):
    """``_series``' distributions at (S, T, R), plus tiers set by hand,
    each at its own (row, tier) slot while slots last: below only at the
    last step; below at lane 31 of the first window, crossing at lane 0
    of the next; below through lane 30, crossing at lane 31; below from
    step 20 to 40, crossing past a window edge; below at step 0 only."""
    rng = np.random.default_rng(seed)
    avail = (0.999 + 0.001 * rng.random((S, T))).astype(np.float32)
    util = (rng.random((S, T)) * 1.5).astype(np.float32)
    cloud = (rng.random((S, T)) * 1e5 - 1e4).astype(np.float32)
    frac = (0.995 + 0.01 * rng.random((S, T, R))).astype(np.float32)
    ts = (np.arange(T) * 30.0).astype(np.float32)
    patterns = ([T - 1], [min(31, T - 1)], list(range(min(31, T - 1))),
                list(range(min(20, T - 1), min(41, T))), [0])
    for k, below in enumerate(patterns[:S * R]):
        i, r = k % S, k // S
        frac[i, :, r] = 1.0
        frac[i, below, r] = 0.5
    return avail, util, cloud, frac, ts


@pytest.mark.parametrize("S,T,R", [
    (1, 1, 1),          # one step, one tier
    (3, 31, 7),         # under one window
    (9, 32, 8),         # one whole window; a second block of rows
    (5, 33, 7),         # a window edge: crossings at lane 31 and lane 0
    (4, 65, 1),         # one tier over three windows
    (9, 128, 8),        # one whole load of four windows
    (8, 129, 7),        # a step into the second load
    (9, 241, 8),        # the sweep's T + 1, R 8
])
def test_timeline_reduce_model_matches_pallas(S, T, R):
    """The kernel's walk, exactly against the Pallas kernel in interpret
    mode on the five selected outputs and within rtol 3e-6 on avail_int,
    which the model sums in the kernel's own order.  It checks the
    algorithm (ballots, carried flags, loads clamped at the row's end);
    only the card runs the kernel itself (chip_smoke.py, phases 1, 1b)."""
    host = _crossing_series(S, T, R, seed=S * 100 + T * 10 + R)
    got = _model_timeline_reduce(*host, THRESH)
    pallas = _to_np(ref_red.timeline_reduce(
        *[jnp.asarray(a) for a in host], thresh=THRESH, block_s=8))
    for k in EXACT_REDUCE:
        assert got[k].dtype == pallas[k].dtype, k
        assert np.array_equal(got[k], pallas[k]), k
    np.testing.assert_allclose(got["avail_int"], pallas["avail_int"],
                               rtol=3e-6)
    # the hand-set crossings landed where they were put
    frac, ts = host[3], host[4]
    if T >= 33 and S * R > 1:
        i, r = 1 % S, 1 // S
        assert got["restore_t"][i, r] == ts[32]
    if T >= 42 and S * R > 3:
        i, r = 3 % S, 3 // S
        assert got["restore_t"][i, r] == ts[41]


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


# ---------------------------------------------------------------------------
# B3: outcome-code histogram
# ---------------------------------------------------------------------------


def _records(rng, n_records, n_edges):
    eid = rng.integers(0, n_edges, n_records).astype(np.int32)
    failed = rng.random(n_records) < 0.3
    errored = rng.random(n_records) < 0.4
    return eid, failed, errored


def _np_hist(eid, failed, errored, n_edges):
    keep = (eid >= 0) & (eid < n_edges)
    code = failed.astype(np.int64) * 2 + errored.astype(np.int64)
    return np.bincount((eid.astype(np.int64) * 4 + code)[keep],
                       minlength=n_edges * 4).reshape(-1, 4)


def _port_hist(eid, failed, errored, n_edges):
    return port_ing.ingest_hist(torch.from_numpy(eid),
                                torch.from_numpy(failed),
                                torch.from_numpy(errored), n_edges).numpy()


@pytest.mark.parametrize("n_records,n_edges,block_n", [
    (10_000, 257, 4096),       # the reference's multi-block grid, padded rows
    (5_000, 256, 4096),        # n_edges a multiple of 8: the reference's
                               # pad-sentinel regression case
    (999, 8, 256),             # tiny universe, heavy duplicates
    (4096, 1000, 4096),        # single block, no record padding
])
def test_ingest_hist_plain_matches_reference(n_records, n_edges, block_n):
    """Counts exact against the Pallas kernel (interpret mode), its XLA
    twin and a numpy bincount, through the plain version and through the
    wrapper on CPU tensors."""
    rng = np.random.default_rng(n_records)
    eid, failed, errored = _records(rng, n_records, n_edges)
    j = (jnp.asarray(eid), jnp.asarray(failed), jnp.asarray(errored))
    pallas = np.asarray(ref_ing.ingest_hist(*j, n_edges, block_n=block_n))
    xla = np.asarray(ref_ing.ref_ingest_hist(*j, n_edges))
    t = (torch.from_numpy(eid), torch.from_numpy(failed),
         torch.from_numpy(errored))
    plain = port_ing.ref_ingest_hist(*t, n_edges)
    got = _port_hist(eid, failed, errored, n_edges)
    assert plain.dtype == torch.int32 and plain.shape == (n_edges, 4)
    assert got.dtype == pallas.dtype == np.int32
    assert np.array_equal(got, pallas)
    assert np.array_equal(got, xla)
    assert np.array_equal(plain.numpy(), got)
    assert np.array_equal(got, _np_hist(eid, failed, errored, n_edges))
    assert got.sum() == n_records


@pytest.mark.parametrize("n_edges", [256, 257])
def test_ingest_hist_drops_out_of_range_ids(n_edges):
    """Ids equal to ``n_edges`` (the reference's pad sentinel when
    ``n_edges`` is a multiple of 8) and above it are dropped, as the
    reference drops them; negative ids are dropped by the port."""
    rng = np.random.default_rng(n_edges)
    eid, failed, errored = _records(rng, 3000, n_edges)
    eid[::7] = n_edges
    eid[1::11] = n_edges + 1 + rng.integers(0, 1000, len(eid[1::11]))
    j = (jnp.asarray(eid), jnp.asarray(failed), jnp.asarray(errored))
    pallas = np.asarray(ref_ing.ingest_hist(*j, n_edges, block_n=1024))
    xla = np.asarray(ref_ing.ref_ingest_hist(*j, n_edges))
    got = _port_hist(eid, failed, errored, n_edges)
    assert np.array_equal(got, pallas) and np.array_equal(got, xla)
    assert got.sum() == int(np.count_nonzero(eid < n_edges))
    neg = eid.copy()
    neg[2::13] = -1 - rng.integers(0, 5, len(neg[2::13]))
    got_neg = _port_hist(neg, failed, errored, n_edges)
    assert np.array_equal(got_neg, _np_hist(neg, failed, errored, n_edges))
    assert got_neg.sum() == int(np.count_nonzero((neg >= 0)
                                                 & (neg < n_edges)))


def test_ingest_hist_empty():
    z = np.zeros(0, np.int32)
    zb = np.zeros(0, bool)
    got = _port_hist(z, zb, zb, 16)
    assert got.shape == (16, 4) and got.sum() == 0
    assert np.array_equal(got, np.asarray(ref_ing.ingest_hist(
        jnp.asarray(z), jnp.asarray(zb), jnp.asarray(zb), 16)))
    assert _port_hist(z, zb, zb, 0).shape == (0, 4)
    five = np.zeros(5, np.int32)
    out = _port_hist(five, five.astype(bool), five.astype(bool), 0)
    assert out.shape == (0, 4) == ref_ing.ingest_hist(
        jnp.asarray(five), jnp.asarray(five), jnp.asarray(five), 0).shape


def test_ingest_hist_cpu_launches_no_kernel():
    before = port_ing.ingest_hist.launches
    eid, failed, errored = _records(np.random.default_rng(3), 100, 9)
    _port_hist(eid, failed, errored, 9)
    assert port_ing.ingest_hist.launches == before


# ---------------------------------------------------------------------------
# B2 and B3 routes, and the wrappers' checks on meta tensors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("U,n,K,cluster,route", [
    (8, 21_979, 16, 8, "cluster"),        # paper scale, the sweep's batch
    (512, 21_979, 16, 8, "cluster"),      # the planner's blast-radius batch
    (1, 25_120, 16, 8, "cluster"),        # the last n 8 CTAs hold at K 16
    (1, 25_121, 16, 16, "cluster"),       # ... one past it: 16 CTAs
    (1, 50_240, 16, 16, "cluster"),       # the last n 16 CTAs hold
    (1, 50_241, 16, 0, "rounds"),         # ... one past it
    (8, 21_979, 18, 8, "cluster"),        # the widest K 8 CTAs hold at n
    (8, 21_979, 19, 16, "cluster"),       # 21,979 ...
    (8, 21_979, 39, 16, "cluster"),       # ... and 16 CTAs
    (8, 21_979, 40, 0, "rounds"),
    (32 * 65_535, 100, 8, 8, "cluster"),  # the most groups one launch takes
    (32 * 65_535 + 1, 100, 8, 8, "rounds"),
])
def test_fixed_point_route(U, n, K, cluster, route):
    """The cluster route while a CTA holds its callers' words and all K
    slots in its opt-in shared memory (8 CTAs first, 16 only where 8 do
    not fit) and the row groups fit one grid; the rounds route past
    either limit."""
    assert port_prop.fixed_point_cluster(n, K) == cluster
    assert port_prop.fixed_point_route(U, n, K) == route
    if cluster:
        assert port_prop.cluster_smem(n, K, cluster) <= backend.SMEM_OPTIN
    for C in port_prop.CLUSTER_SIZES:
        if C < cluster or not cluster:
            assert port_prop.cluster_smem(n, K, C) > backend.SMEM_OPTIN


def test_fixed_point_cluster_smem_at_paper_scale():
    # 2,748 callers a CTA: flags 16 B, words 2 x 4 B, 16 slot addresses
    # x 4 B and a 2-byte count a caller
    assert port_prop.cluster_smem(21_979, 16, 8) == 16 + 2_748 * 74
    assert port_prop.cluster_smem(21_979, 16, 8) == 203_368


@pytest.mark.parametrize("n_edges,route", [
    (120_827, "buckets"),  # paper scale: 7,552 edges, 120,832 B a range
    (232_448, "buckets"),  # the last universe a CTA holds a sixteenth of
    (232_449, "global"),   # ... one past it
    (1, "buckets"),
    (2 ** 31 - 1, "global"),
])
def test_ingest_hist_route(n_edges, route):
    assert port_ing.ingest_hist_route(n_edges) == route
    assert (port_ing.range_bytes(n_edges) <= backend.SMEM_OPTIN) == (
        route == "buckets")


def test_routes_refuse_negative_shapes():
    with pytest.raises(ValueError):
        port_prop.fixed_point_route(-1, 10, 8)
    with pytest.raises(ValueError):
        port_ing.ingest_hist_route(-1)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("args,error,match", [
    ((_meta((4, 50), torch.uint8), _meta((50, 8), torch.int32),
      _meta((50, 8), torch.bool)), TypeError, "dark bool"),
    ((_meta((4, 50), torch.bool), _meta((50, 8), torch.int64),
      _meta((50, 8), torch.bool)), TypeError, "ell_dst int32"),
    ((_meta((4, 50), torch.bool), _meta((50, 8), torch.int32),
      _meta((50, 8), torch.uint8)), TypeError, "ell_closed bool"),
    ((_meta((4, 50), torch.bool), _meta((49, 8), torch.int32),
      _meta((49, 8), torch.bool)), ValueError, r"\(n, K\)"),
    ((_meta((4, 50), torch.bool), _meta((50, 8), torch.int32),
      _meta((50, 7), torch.bool)), ValueError, r"\(n, K\)"),
    ((_meta((200,), torch.bool), _meta((50, 8), torch.int32),
      _meta((50, 8), torch.bool)), ValueError, r"\(S, n\)"),
    ((_meta((4, 50), torch.bool), _meta((50, 8), torch.int32),
      _meta((50, 8), torch.bool)), ValueError, "no kernel for meta"),
])
def test_fixed_point_ell_checks_meta(args, error, match):
    """Off the CPU the wrapper checks dtype and shape before anything
    else, and refuses a device without a kernel: nothing launches."""
    before = port_prop.fixed_point_ell.launches
    with pytest.raises(error, match=match):
        port_prop.fixed_point_ell(*args)
    assert port_prop.fixed_point_ell.launches == before


@pytest.mark.parametrize("args,error,match", [
    ((_meta((100,), torch.int64), _meta((100,), torch.bool),
      _meta((100,), torch.bool), 10), TypeError, "edge_id int32"),
    ((_meta((100,), torch.int32), _meta((100,), torch.uint8),
      _meta((100,), torch.bool), 10), TypeError, "edge_id int32"),
    ((_meta((100,), torch.int32), _meta((100,), torch.bool),
      _meta((100,), torch.int32), 10), TypeError, "edge_id int32"),
    ((_meta((100,), torch.int32), _meta((99,), torch.bool),
      _meta((100,), torch.bool), 10), ValueError, r"three \(N,\)"),
    ((_meta((10, 10), torch.int32), _meta((100,), torch.bool),
      _meta((100,), torch.bool), 10), ValueError, r"three \(N,\)"),
    ((_meta((100,), torch.int32), _meta((100,), torch.bool),
      _meta((100,), torch.bool), -1), ValueError, "n_edges=-1"),
    ((_meta((100,), torch.int32), _meta((100,), torch.bool),
      _meta((100,), torch.bool), 2 ** 31), ValueError, "out of range"),
    ((_meta((100,), torch.int32), _meta((100,), torch.bool),
      _meta((100,), torch.bool), 232_449), ValueError, "no kernel for meta"),
    ((_meta((100,), torch.int32), _meta((100,), torch.bool),
      _meta((100,), torch.bool), 10), ValueError, "no kernel for meta"),
])
def test_ingest_hist_checks_meta(args, error, match):
    before = port_ing.ingest_hist.launches
    with pytest.raises(error, match=match):
        port_ing.ingest_hist(*args)
    assert port_ing.ingest_hist.launches == before


# ---------------------------------------------------------------------------
# B2's cluster route: 32-row groups, callers split over a cluster's CTAs
# ---------------------------------------------------------------------------

CHAINS = (2, 5, 9, 14)      # fail-close relay chains of these many hops


def _relay_graph(seed, n=120):
    """Random cyclic edges (a third fail-close) plus fail-close relay
    chains of CHAINS hops over services of their own: darkening a chain's
    tail breaks one more service a round up to its head."""
    rng = np.random.default_rng(seed)
    heads, chain_edges, base = [], [], n
    for hops in CHAINS:
        ids = np.arange(base, base + hops + 1)
        chain_edges += [(int(ids[i + 1]), int(ids[i]))
                        for i in range(hops)]         # caller -> callee
        heads.append(int(ids[0]))
        base += hops + 1
    total = base
    m = rng.random((n, n)) < 0.04
    np.fill_diagonal(m, False)
    src, dst = np.nonzero(m)
    closed = rng.random(len(src)) < 0.33
    src = np.concatenate([src, [e[0] for e in chain_edges]])
    dst = np.concatenate([dst, [e[1] for e in chain_edges]])
    closed = np.concatenate([closed, np.ones(len(chain_edges), bool)])
    order = np.argsort(src, kind="stable")
    src, dst, closed = src[order], dst[order], closed[order]
    indptr = np.searchsorted(src, np.arange(total + 1)).astype(np.int64)
    return total, indptr, dst.astype(np.int32), closed, heads


def _relay_dark(rng, U, total, heads):
    """Row r darkens chain (r // 32 + r) % 4's tail, so that each 32-row
    group holds another mix of chains, plus a few random services."""
    dark = rng.random((U, total)) < 0.01
    for r in range(U):
        dark[r, heads[(r // 32 + r) % len(heads)]] = True
    return dark


def _cluster_emulation(dark, ell_dst, ell_closed, C=8):
    """What csrc/fixed_point_ell.cu's cluster route computes, in numpy:
    32 rows a uint32 word; C CTAs each owning ceil(n / C) callers and a
    compacted list of their closed slots; Jacobi rounds of gathered words
    until no CTA's words change or n + 1 rounds ran; a caller whose word
    is already full skips its gather.  Returns (broken, rounds, the
    groups' rounds)."""
    U, n = dark.shape
    m = -(-n // C)
    broken = np.zeros_like(dark)
    group_rounds = []
    for row0 in range(0, U, 32):
        rows = min(32, U - row0)
        full = np.uint32((1 << rows) - 1)
        bits = dark[row0:row0 + rows].astype(np.uint32)
        cur = (bits << np.arange(rows, dtype=np.uint32)[:, None]).sum(
            axis=0, dtype=np.uint32)
        slots = [[ell_dst[u][ell_closed[u]] for u in range(r * m,
                                                          min(n, (r + 1) * m))]
                 for r in range(C)]
        rounds, go = 0, True
        while go:
            nxt = cur.copy()
            changed = False
            for r in range(C):
                for i, callees in enumerate(slots[r]):
                    u = r * m + i
                    if cur[u] != full and len(callees):
                        nxt[u] = cur[u] | np.bitwise_or.reduce(cur[callees])
                    changed |= bool(nxt[u] != cur[u])
            cur, rounds = nxt, rounds + 1
            go = changed and rounds < n + 1
        group_rounds.append(rounds)
        broken[row0:row0 + rows] = (cur[None, :] >> np.arange(
            rows, dtype=np.uint32)[:, None]) & 1
    return broken, max(group_rounds), group_rounds


@pytest.mark.parametrize("U", [1, 7, 32, 33, 100])
@pytest.mark.parametrize("seed", [0, 1])
def test_fixed_point_row_groups(U, seed):
    """The decomposition the cluster route rests on, on graphs whose relay
    chains converge at different rounds in different 32-row groups: each
    group's fixed point side by side is the slab's ``broken``, the
    largest group's round count is the slab's ``rounds`` (against
    ``ref_fixed_point`` and the reference's Pallas kernel in interpret
    mode), and the bit-sliced, cluster-split emulation of the kernel
    gives both, with C 8 and 16 CTAs (n not a multiple of either)."""
    rng = np.random.default_rng(100 + seed)
    total, indptr, dst, closed, heads = _relay_graph(seed)
    ell_dst, ell_closed, _ = port_prop.ell_from_csr(total, indptr, dst,
                                                    closed)
    dark = _relay_dark(rng, U, total, heads)
    (rb, rr), (gb, gr) = _both(dark, ell_dst, ell_closed)
    assert np.array_equal(gb, rb) and gr == rr
    groups = [port_prop.ref_fixed_point(
        torch.from_numpy(dark[r0:r0 + 32]), torch.from_numpy(ell_dst),
        torch.from_numpy(ell_closed)) for r0 in range(0, U, 32)]
    assert np.array_equal(np.concatenate([b.numpy() for b, _ in groups]), gb)
    assert max(r for _, r in groups) == gr
    if U > 32:
        assert len({r for _, r in groups}) > 1, "groups converge together"
    for C in (8, 16):
        assert total % C
        eb, er, per_group = _cluster_emulation(dark, ell_dst, ell_closed, C)
        assert np.array_equal(eb, gb) and er == gr
        assert per_group == [r for _, r in groups]
