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
// What bounds it: memory.  Each scenario reads (3 + R) * T floats once and
// writes 4 + 2R values; there is about one arithmetic operation per byte,
// far below the card's balance point.  At the sweep engine's 4,096-wide
// chunk (T = 240, R = 7) that is 39 MB, about 12 us at 3.35 TB/s.
//
// Design: one warp per scenario row, eight rows per block, no shared
// memory.  The dot with dt and the min/max run as warp-strided passes over
// T (consecutive lanes on consecutive steps, so every load is coalesced)
// finished by __shfl_xor_sync butterflies.  The first-crossing search needs
// no sequential loop over t: per tier and 32-step window the warp takes one
// __ballot_sync of `below`; with the window's bits and a warp-uniform
// "seen" flag carried from earlier windows, the first crossing is the
// lowest set bit of (~below & valid & lanes after the first below), found
// with __ffs.  Every output is a selection except avail_int, which is a sum
// in another order than the sequential scan (float32-tight, not bitwise).
// The Pallas kernel's 128-row blocking is not carried over: a TPU block
// filled VMEM, here the unit is a warp and the grid fills 132 SMs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_TIERS 8
#define ROWS_PER_BLOCK 8
#define FULL_MASK 0xffffffffu

__global__ void __launch_bounds__(32 * ROWS_PER_BLOCK)
timeline_reduce_kernel(const float* __restrict__ avail,
                       const float* __restrict__ util,
                       const float* __restrict__ cloud,
                       const float* __restrict__ tier_frac,
                       const float* __restrict__ ts,
                       int S, int T, int R, float thresh,
                       float* __restrict__ avail_int,
                       float* __restrict__ avail_min,
                       float* __restrict__ util_peak,
                       float* __restrict__ cloud_peak,
                       float* __restrict__ restore_t,
                       uint8_t* __restrict__ below_seen) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= S) return;  // uniform across the warp

  const float* a = avail + (size_t)row * T;
  const float* u = util + (size_t)row * T;
  const float* c = cloud + (size_t)row * T;
  float acc = 0.0f, amin = INFINITY, umax = -INFINITY, cmax = -INFINITY;
  for (int t = lane; t < T; t += 32) {
    const float dt = t == 0 ? 0.0f : fmaxf(__fsub_rn(ts[t], ts[t - 1]), 0.0f);
    const float av = a[t];
    acc = __fadd_rn(acc, __fmul_rn(av, dt));
    amin = fminf(amin, av);
    umax = fmaxf(umax, u[t]);
    cmax = fmaxf(cmax, c[t]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc = __fadd_rn(acc, __shfl_xor_sync(FULL_MASK, acc, off));
    amin = fminf(amin, __shfl_xor_sync(FULL_MASK, amin, off));
    umax = fmaxf(umax, __shfl_xor_sync(FULL_MASK, umax, off));
    cmax = fmaxf(cmax, __shfl_xor_sync(FULL_MASK, cmax, off));
  }
  if (lane == 0) {
    avail_int[row] = acc;
    avail_min[row] = fminf(amin, 1.0f);
    util_peak[row] = fmaxf(umax, 0.0f);
    cloud_peak[row] = fmaxf(cmax, 0.0f);
  }

  // first crossings: warp-uniform state per tier, one ballot per window
  const float* fr = tier_frac + (size_t)row * T * R;
  bool seen[MAX_TIERS], found[MAX_TIERS];
  float rest[MAX_TIERS];
#pragma unroll
  for (int r = 0; r < MAX_TIERS; ++r) {
    seen[r] = false;
    found[r] = false;
    rest[r] = INFINITY;
  }
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int t = t0 + lane;
    const bool valid = t < T;
    const unsigned valid_bits = __ballot_sync(FULL_MASK, valid);
    const float t_now = valid ? ts[t] : 0.0f;
#pragma unroll
    for (int r = 0; r < MAX_TIERS; ++r) {
      if (r >= R) break;
      const bool below = valid && fr[(size_t)t * R + r] < thresh;
      const unsigned below_bits = __ballot_sync(FULL_MASK, below);
      if (!found[r]) {
        unsigned cross = ~below_bits & valid_bits;
        if (!seen[r]) {
          // only steps after the window's first below step can cross
          const int first = __ffs(below_bits) - 1;  // -1 when none
          cross = first < 0 ? 0u
                  : first == 31 ? 0u : cross & (FULL_MASK << (first + 1));
        }
        if (cross) {
          rest[r] = __shfl_sync(FULL_MASK, t_now, __ffs(cross) - 1);
          found[r] = true;
        }
      }
      seen[r] = seen[r] || below_bits != 0u;
    }
  }
#pragma unroll
  for (int r = 0; r < MAX_TIERS; ++r) {
    if (r < R && lane == r) {
      restore_t[(size_t)row * R + r] = rest[r];
      below_seen[(size_t)row * R + r] = seen[r] ? 1 : 0;
    }
  }
}

extern "C" int timeline_reduce_launch(
    const float* avail, const float* util, const float* cloud,
    const float* tier_frac, const float* ts, int S, int T, int R,
    float thresh, float* avail_int, float* avail_min, float* util_peak,
    float* cloud_peak, float* restore_t, uint8_t* below_seen,
    void* stream) {
  if (R > MAX_TIERS || T < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((S + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  timeline_reduce_kernel<<<blocks, 32 * ROWS_PER_BLOCK, 0,
                           (cudaStream_t)stream>>>(
      avail, util, cloud, tier_frac, ts, S, T, R, thresh, avail_int,
      avail_min, util_peak, cloud_peak, restore_t, below_seen);
  return (int)cudaGetLastError();
}
