// Segmented timeline verdict reduction for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/ufa/reduce.py
// (timeline_reduce / _reduce_kernel): per scenario row of T steps
//
//   avail_int  = sum_t avail[t] * dt[t]       dt[0] = 0, dt[t] = max(ts[t]-ts[t-1], 0)
//   avail_min  = min(1, min_t avail[t])
//   util_peak  = max(0, max_t util[t])        cloud_peak likewise
//   below      = tier_frac[t, r] < thresh     per tier r
//   restore_t  = ts of the first t with (below seen at or before t) & !below[t]
//   below_seen = below seen at any t
//
// written as the Pallas kernel's own layout: stats (S, 4) float32 (the
// first four, in that order), restore_t (S, R) float32, below_seen (S, R)
// bytes.
//
// What bounds it: memory.  Each scenario reads (3 + R) * T floats once and
// writes 4 + 2R values; there is about one arithmetic operation per byte,
// far below the card's balance point.  At the sweep engine's 4,096-wide
// chunk (T = 240, R = 7) that is 39 MB, about 12 us at 3.35 TB/s, and to
// reach that rate some 2.5-3 MB must be in flight at once (Little's law).
//
// Design: one warp a scenario row, eight rows a block, straight from
// global memory, no shared memory.  The dot with dt and the min/max run as
// warp-strided passes over T (consecutive lanes on consecutive steps, so
// every load is coalesced) finished by __shfl_xor_sync butterflies, with
// __fmul_rn / __fadd_rn so that no FMA is contracted.  The first-crossing
// search needs no sequential loop over t: per tier and 32-step window the
// warp takes one __ballot_sync of `below`; with the window's bits and a
// warp-uniform "seen" flag carried from earlier windows, the first
// crossing is the lowest set bit of (~below & valid & lanes after the
// first below), found with __ffs, and kept as a step index.  After the
// ballots lane r keeps tier r's state, so that logic runs once a window
// for all tiers, not once a tier.  A row is a chain of dependent latencies
// more than of instructions, so both passes issue the loads (and the
// ballots) of four 32-step windows ahead of their logic, and the grid
// keeps many rows' warps in flight.  Every output is a selection except
// avail_int, a sum in another order than the sequential scan
// (float32-tight, not bitwise).
//
// The Pallas kernel's 128-row blocking is not carried over: a TPU block
// filled VMEM, here the unit is a warp.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_TIERS 8
#define FULL_MASK 0xffffffffu
#define ROWS_PER_BLOCK 8
#define WINDOWS 4                       // 32-step windows loaded at once

// One scenario row's statistics, one warp: a, u, c its T steps, ts the
// step times; writes stats[0..4) (16-byte aligned).  Lane l sums its steps
// l, l + 32, ... in order, with dt from two ts loads a step; the loads of
// WINDOWS steps a lane are issued together, ahead of the sums, so that
// their latencies overlap.
__device__ __forceinline__ void row_stats(const float* a, const float* u,
                                          const float* c, const float* ts,
                                          int T, int lane, float* stats) {
  float acc = 0.0f, amin = INFINITY, umax = -INFINITY, cmax = -INFINITY;
  for (int c0 = 0; c0 < T; c0 += 32 * WINDOWS) {
    float av[WINDOWS], uv[WINDOWS], cv[WINDOWS], d[WINDOWS];
#pragma unroll
    for (int w = 0; w < WINDOWS; ++w) {
      const int t = min(c0 + 32 * w + lane, T - 1);
      av[w] = a[t];
      uv[w] = u[t];
      cv[w] = c[t];
      d[w] = t == 0 ? 0.0f : fmaxf(__fsub_rn(ts[t], ts[t - 1]), 0.0f);
    }
#pragma unroll
    for (int w = 0; w < WINDOWS; ++w) {
      if (c0 + 32 * w + lane < T) {
        acc = __fadd_rn(acc, __fmul_rn(av[w], d[w]));
        amin = fminf(amin, av[w]);
        umax = fmaxf(umax, uv[w]);
        cmax = fmaxf(cmax, cv[w]);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc = __fadd_rn(acc, __shfl_xor_sync(FULL_MASK, acc, off));
    amin = fminf(amin, __shfl_xor_sync(FULL_MASK, amin, off));
    umax = fmaxf(umax, __shfl_xor_sync(FULL_MASK, umax, off));
    cmax = fmaxf(cmax, __shfl_xor_sync(FULL_MASK, cmax, off));
  }
  if (lane == 0)
    *reinterpret_cast<float4*>(stats) =
        make_float4(acc, fminf(amin, 1.0f), fmaxf(umax, 0.0f),
                    fmaxf(cmax, 0.0f));
}

// One scenario row's first crossings, one warp: fr the row's T x R tier
// fractions (step-major), ts the step times; writes restore_t[0..R) and
// below_seen[0..R).  One ballot a tier and window; lane r keeps tier r's
// state, so the crossing logic runs once a window for all tiers, and the
// crossing's step index is kept and its time read once at the end.  The
// loads and ballots of WINDOWS windows are issued together, ahead of their
// logic, so that their latencies overlap.
template <int R>
__device__ __forceinline__ void row_crossings(const float* fr,
                                              const float* ts, int T,
                                              float thresh, int lane,
                                              float* restore_t,
                                              uint8_t* below_seen) {
  bool seen = false, found = false;
  int cross_t = 0;
  for (int c0 = 0; c0 < T; c0 += 32 * WINDOWS) {
    // every lane loads (past the end, the last step again); the
    // predicate, not a branch, drops what it must not count
    float f[WINDOWS][R];
#pragma unroll
    for (int w = 0; w < WINDOWS; ++w) {
      const int t = min(c0 + 32 * w + lane, T - 1);
#pragma unroll
      for (int r = 0; r < R; ++r) f[w][r] = fr[(size_t)t * R + r];
    }
    unsigned below[WINDOWS];  // lane r: tier r's below lanes of window w
#pragma unroll
    for (int w = 0; w < WINDOWS; ++w) {
      const bool valid = c0 + 32 * w + lane < T;
      unsigned b[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        b[r] = r < R ? __ballot_sync(FULL_MASK,
                                      valid && f[w][r < R ? r : 0] < thresh)
                     : 0u;
      // lane r picks ballot r in three selections (lanes past R: unused)
      const unsigned b01 = lane & 1 ? b[1] : b[0];
      const unsigned b23 = lane & 1 ? b[3] : b[2];
      const unsigned b45 = lane & 1 ? b[5] : b[4];
      const unsigned b67 = lane & 1 ? b[7] : b[6];
      const unsigned b03 = lane & 2 ? b23 : b01;
      const unsigned b47 = lane & 2 ? b67 : b45;
      below[w] = lane & 4 ? b47 : b03;
    }
#pragma unroll
    for (int w = 0; w < WINDOWS; ++w) {
      const int t0 = c0 + 32 * w, left = T - t0;
      const unsigned valid_bits = left >= 32 ? FULL_MASK
                                  : left > 0 ? (1u << left) - 1u : 0u;
      // lanes after the window's first below lane (none when no lane is
      // below or the first is lane 31), or every lane once seen before
      const unsigned first = below[w] & (0u - below[w]);
      const unsigned after = seen ? FULL_MASK : ~((first << 1) - 1u);
      const unsigned cross = found ? 0u : ~below[w] & valid_bits & after;
      cross_t = cross ? t0 + __ffs(cross) - 1 : cross_t;
      found = found || cross != 0u;
      seen = seen || below[w] != 0u;
    }
  }
  if (lane < R) {
    restore_t[lane] = found ? ts[cross_t] : INFINITY;
    below_seen[lane] = seen ? 1 : 0;
  }
}

template <int R>
__global__ void __launch_bounds__(32 * ROWS_PER_BLOCK)
timeline_reduce_kernel(const float* __restrict__ avail,
                       const float* __restrict__ util,
                       const float* __restrict__ cloud,
                       const float* __restrict__ tier_frac,
                       const float* __restrict__ ts, int S, int T,
                       float thresh, float* __restrict__ stats,
                       float* __restrict__ restore_t,
                       uint8_t* __restrict__ below_seen) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= S) return;  // uniform across the warp
  const size_t r = (size_t)row;
  const int lane = threadIdx.x & 31;
  row_stats(avail + r * T, util + r * T, cloud + r * T, ts, T, lane,
            stats + r * 4);
  row_crossings<R>(tier_frac + r * T * R, ts, T, thresh, lane,
                   restore_t + r * R, below_seen + r * R);
}

// avail, util, cloud (S, T), tier_frac (S, T, R), ts (T,) contiguous
// float32, any alignment; stats (S, 4) and restore_t (S, R) float32,
// below_seen (S, R) bytes, stats 16-byte aligned.  Returns 0 or a
// cudaError_t.
extern "C" int timeline_reduce_launch(
    const float* avail, const float* util, const float* cloud,
    const float* tier_frac, const float* ts, int S, int T, int R,
    float thresh, float* stats, float* restore_t, uint8_t* below_seen,
    void* stream) {
  if (R < 1 || R > MAX_TIERS || T < 1 || S < 1 || (uintptr_t)stats % 16)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((S + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  cudaStream_t st = (cudaStream_t)stream;
#define TR_LAUNCH(N)                                                       \
  case N:                                                                  \
    timeline_reduce_kernel<N><<<blocks, 32 * ROWS_PER_BLOCK, 0, st>>>(     \
        avail, util, cloud, tier_frac, ts, S, T, thresh, stats, restore_t, \
        below_seen);                                                       \
    break
  switch (R) {
    TR_LAUNCH(1);
    TR_LAUNCH(2);
    TR_LAUNCH(3);
    TR_LAUNCH(4);
    TR_LAUNCH(5);
    TR_LAUNCH(6);
    TR_LAUNCH(7);
    TR_LAUNCH(8);
  }
#undef TR_LAUNCH
  return (int)cudaGetLastError();
}
