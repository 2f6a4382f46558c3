// Outcome-code histogram of one telemetry chunk for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/ufa/ingest.py
// (ingest_hist / _hist_kernel): for every record i with
// 0 <= edge_id[i] < n_edges
//
//   counts[edge_id[i], 2 * callee_failed[i] + caller_errored[i]] += 1
//
// into an (n_edges, 4) int32 histogram.  Records with an id outside
// [0, n_edges) are dropped: that covers the reference's positive pad
// sentinel, and a negative id, which the reference would wrap, is
// dropped too.  Integer adds commute, so the counts are exact whatever
// the order in which the adds land.
//
// What bounds it: bytes.  A record is read once (4 B id, 1 B failed, 1 B
// errored) and nothing else is read; at 4M records a chunk is 24 MB, 7 us
// at 3.35 TB/s, plus the 1.9 MB histogram written once (120,827 edges x
// 4 x 4 B at paper scale).  What held the first design back was not
// bytes but one global atomicAdd a record onto ~483k random L2 addresses,
// serialised on one address when every record hits one edge.
//
// Two routes, picked by the wrapper from n_edges alone
// (kernels/ufa/ingest.py::ingest_hist_route):
//
// "buckets" (a sixteenth of the histogram, 16 * ceil(n_edges / 16)
// bytes, fits one CTA's shared memory: n_edges <= 232,448), three
// launches and no global atomic.  Edge e belongs to range e % 16, at row
// e / 16 of that range (interleaved, so neighbouring hot edges fall in
// different ranges and no division is needed); a record's key is its bin
// within its range, (e / 16) * 4 + code, under 2^16.
//   1. partition: a CTA takes a tile of 8,192 records (16-byte id loads,
//      8-byte flag loads; scalar where a view is not so aligned), drops
//      the out-of-range ids, and writes the tile's keys back into the
//      tile's own slots of a uint16 array, grouped by range: each warp
//      ranks its records per range by atomics on its own 16 counters in
//      shared memory (one a step when the step's records share a range),
//      a block scan turns the warps' counts into offsets,
//      the keys are grouped in shared memory and leave in 16-byte stores,
//      and the tile's 17 range offsets go to a small table.
//   2. count: CTA (s, j) zeroes range j's bins in its shared memory
//      (up to 227 KB) and its warps walk range j's segments of tiles s,
//      s + S, ..., eight keys a 16-byte load, adding into local shared
//      memory.  A lane merges a run of records on one edge in registers
//      (four counters) and adds each total once, so a chunk with every
//      record on one edge costs a few adds a lane instead of serialising
//      on one address.  A range's S counting CTAs (S = the SMs / 16, one
//      CTA an SM) are launched as clusters of Q (4 where the card holds
//      every such cluster at once): after a cluster barrier each CTA
//      sums its share of the rows over the cluster's bins through
//      distributed shared memory (DSMEM) and stores them, int4 stores,
//      as the cluster's partial histogram of range j.
//   3. sum: counts[e] = the sum of the S / Q partials of e's row: every
//      count written once, nothing zeroed by a memset.
// The design kept after tools/dsmem_microbench.cu showed random adds into
// a 16-CTA cluster's DSMEM running slower than global atomics on an H100
// (a one-pass histogram in a cluster's DSMEM lost to this one too): the
// buckets move the scatter onto plain stores and every atomic into the
// adding CTA's own shared memory, and DSMEM carries only the sequential
// merge of a cluster's bins.

// "global" (larger universes): the first design, one thread per record,
// grid-strided, one atomicAdd on the global histogram zeroed by a memset
// before the pass; the bin index is computed in 64 bits, so 4 * n_edges
// may exceed 2^31.
//
// The TPU kernel's sequential grid, which carried the histogram across
// record blocks (pl.when(r == 0) init), is not carried over: blocks here
// run in parallel and meet in the partials' sum or in the atomics.

#include "hopper.cuh"

// ---------------------------------------------------------------------------
// route "global"
// ---------------------------------------------------------------------------

#define THREADS 256
#define BLOCKS_PER_SM 8

__global__ void __launch_bounds__(THREADS)
ingest_hist_kernel(const int32_t* __restrict__ edge_id,
                   const uint8_t* __restrict__ callee_failed,
                   const uint8_t* __restrict__ caller_errored, long long n,
                   int n_edges, int* __restrict__ counts) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    const int e = __ldg(edge_id + i);
    if (e < 0 || e >= n_edges) continue;
    const int code = (__ldg(callee_failed + i) ? 2 : 0) |
                     (__ldg(caller_errored + i) ? 1 : 0);
    atomicAdd(counts + (long long)e * 4 + code, 1);
  }
}

extern "C" int ingest_hist_launch(const int32_t* edge_id,
                                  const uint8_t* callee_failed,
                                  const uint8_t* caller_errored, long long n,
                                  int n_edges, int* counts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n < 1 || n_edges < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaMemsetAsync(counts, 0, (size_t)n_edges * 4 * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long want = (n + THREADS - 1) / THREADS;
  const long long cap = (long long)sms * BLOCKS_PER_SM;
  const unsigned blocks = (unsigned)(want < cap ? want : cap);
  ingest_hist_kernel<<<blocks, THREADS, 0, s>>>(
      edge_id, callee_failed, caller_errored, n, n_edges, counts);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// route "buckets"
// ---------------------------------------------------------------------------

#define RANGES 16         // bin ranges: edge e in range e % 16
#define TILE 8192         // records a partition CTA
#define P_THREADS 1024    // partition threads: 8 records each
#define C_THREADS 1024    // count threads
#define SUM_THREADS 256

// 1. partition one tile of records into range-grouped uint16 keys
__global__ void __launch_bounds__(P_THREADS)
hist_partition_kernel(const int32_t* __restrict__ edge_id,
                      const uint8_t* __restrict__ callee_failed,
                      const uint8_t* __restrict__ caller_errored,
                      long long n, int n_edges, int vec,
                      uint16_t* __restrict__ keys,
                      int* __restrict__ offsets) {
  __shared__ int warp_count[P_THREADS / 32][RANGES];
  __shared__ int range_off[RANGES + 1];
  __shared__ __align__(16) uint16_t stage[TILE];
  const int warp = threadIdx.x >> 5;
  const long long tile0 = (long long)blockIdx.x * TILE;
  const long long first = tile0 + (long long)threadIdx.x * 8;
  int e[8];
  uint32_t f[2] = {0, 0}, r[2] = {0, 0};
  if (vec && first + 8 <= n) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(edge_id + first));
    const int4 b = __ldg(reinterpret_cast<const int4*>(edge_id + first + 4));
    e[0] = a.x; e[1] = a.y; e[2] = a.z; e[3] = a.w;
    e[4] = b.x; e[5] = b.y; e[6] = b.z; e[7] = b.w;
    const uint2 fv =
        __ldg(reinterpret_cast<const uint2*>(callee_failed + first));
    const uint2 rv =
        __ldg(reinterpret_cast<const uint2*>(caller_errored + first));
    f[0] = fv.x; f[1] = fv.y; r[0] = rv.x; r[1] = rv.y;
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const long long i = first + k;
      e[k] = i < n ? __ldg(edge_id + i) : -1;
      if (i < n) {
        const uint32_t byte = 8 * (k & 3);
        f[k >> 2] |= (uint32_t)(__ldg(callee_failed + i) != 0) << byte;
        r[k >> 2] |= (uint32_t)(__ldg(caller_errored + i) != 0) << byte;
      }
    }
  }
  // each record's key, range and rank among this warp's records of its
  // range (an add on the warp's own counters in shared memory, one for
  // the whole step when its records share a range), packed into one
  // word: key bits 0-15, range 16-19, rank 20-27, bit 31 dropped
  for (int i = threadIdx.x; i < (P_THREADS / 32) * RANGES; i += P_THREADS)
    (&warp_count[0][0])[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const uint32_t below = (1u << lane) - 1u;
  uint32_t rec[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const bool ok = e[k] >= 0 && e[k] < n_edges;
    const uint32_t byte = 8 * (k & 3);
    const uint32_t code = ((f[k >> 2] >> byte) & 0xff ? 2u : 0u) |
                          ((r[k >> 2] >> byte) & 0xff ? 1u : 0u);
    const uint32_t j = (uint32_t)e[k] & (RANGES - 1);
    // a step whose live records all fall in one range takes one add
    const uint32_t live = __ballot_sync(0xffffffffu, ok);
    const int lead = live ? __ffs(live) - 1 : 0;
    const uint32_t j0 = __shfl_sync(0xffffffffu, j, lead);
    int rank = 0;
    if (__all_sync(0xffffffffu, !ok || j == j0)) {
      if (live && lane == lead)
        rank = atomicAdd(&warp_count[warp][j0], __popc(live));
      rank = __shfl_sync(0xffffffffu, rank, lead) + __popc(live & below);
    } else if (ok) {
      rank = atomicAdd(&warp_count[warp][j], 1);
    }
    rec[k] = 0x80000000u;
    if (ok)
      rec[k] = ((uint32_t)e[k] >> 4) << 2 | code | j << 16 |
               (uint32_t)rank << 20;
  }
  __syncthreads();
  // offsets: range by range, then warp by warp within a range
  if (threadIdx.x < RANGES) {
    int acc = 0;
    for (int w = 0; w < P_THREADS / 32; ++w) {
      const int c = warp_count[w][threadIdx.x];
      warp_count[w][threadIdx.x] = acc;
      acc += c;
    }
    range_off[threadIdx.x + 1] = acc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    range_off[0] = 0;
    for (int j = 0; j < RANGES; ++j) range_off[j + 1] += range_off[j];
  }
  __syncthreads();
  if (threadIdx.x <= RANGES)
    offsets[(size_t)blockIdx.x * (RANGES + 1) + threadIdx.x] =
        range_off[threadIdx.x];
  // the tile's keys, grouped by range, through shared memory so that they
  // leave in 16-byte stores
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (!(rec[k] >> 31)) {
      const uint32_t j = (rec[k] >> 16) & (RANGES - 1);
      stage[range_off[j] + warp_count[warp][j] + (rec[k] >> 20)] =
          (uint16_t)rec[k];
    }
  __syncthreads();
  const int kept = range_off[RANGES];
  uint4* out = reinterpret_cast<uint4*>(keys + tile0);
  const uint4* in = reinterpret_cast<const uint4*>(stage);
  for (int q = threadIdx.x; q < (kept + 7) / 8; q += P_THREADS) out[q] = in[q];
}

// a lane's run of records on one row: four 16-bit code counters packed in
// one register, added into the bins once when the row changes (or before
// a counter could overflow)
struct Run {
  int row = -1;
  uint32_t len = 0;
  uint64_t c = 0;  // code v's count in bits 16 v .. 16 v + 15
  __device__ __forceinline__ void flush(int* bins) {
    if (row < 0) return;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int x = (int)((c >> (16 * v)) & 0xffffu);
      if (x) atomicAdd(bins + row * 4 + v, x);
    }
  }
  // eight keys of one 16-byte load: at once when they all continue the
  // run, else one by one
  __device__ __forceinline__ void add8(int* bins, const uint4& v) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    const uint32_t same = (uint32_t)row * 0x40004u;  // the row, twice
    if (row >= 0 && len <= 0xffffu - 8 && (w[0] & 0xfffcfffcu) == same &&
        (w[1] & 0xfffcfffcu) == same && (w[2] & 0xfffcfffcu) == same &&
        (w[3] & 0xfffcfffcu) == same) {
#pragma unroll
      for (int h = 0; h < 4; ++h)
        c += (1ull << (16 * (w[h] & 3))) + (1ull << (16 * ((w[h] >> 16) & 3)));
      len += 8;
      return;
    }
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      add(bins, w[h] & 0xffffu);
      add(bins, w[h] >> 16);
    }
  }
  __device__ __forceinline__ void add(int* bins, uint32_t key) {
    const int kr = (int)(key >> 2);
    if (kr != row || len == 0xffffu) {
      flush(bins);
      row = kr;
      len = 0;
      c = 0;
    }
    c += 1ull << (16 * (key & 3));
    ++len;
  }
};

// 2. count range blockIdx.y's keys of tiles blockIdx.x, + gridDim.x, ...
// (a warp a tile's segment, eight keys a 16-byte load, scalar at the
// segment's unaligned ends, four loads in flight a lane) into shared
// memory; the parts of a range are launched in clusters of Q CTAs, which
// merge their bins into one partial histogram a cluster
__global__ void __launch_bounds__(C_THREADS, 1)
hist_count_kernel(const uint16_t* __restrict__ keys,
                  const int* __restrict__ offsets, int tiles,
                  int rows_per_range, int4* __restrict__ partial) {
  extern __shared__ __align__(16) int bins[];  // rows_per_range x 4
  int4* bins4 = reinterpret_cast<int4*>(bins);
  for (int i = threadIdx.x; i < rows_per_range; i += C_THREADS)
    bins4[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
  const int j = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warps = C_THREADS / 32;
  Run run;
  for (int t = blockIdx.x * warps + (threadIdx.x >> 5); t < tiles;
       t += gridDim.x * warps) {
    const int* off = offsets + (size_t)t * (RANGES + 1) + j;
    const uint16_t* seg = keys + (size_t)t * TILE;
    const int start = __ldg(off), end = __ldg(off + 1);
    const int a = min(end, (start + 7) & ~7);    // first 8-aligned key
    const int b = max(a, end & ~7);              // last 8-aligned end
    if (start + lane < a) run.add(bins, __ldg(seg + start + lane));
    if (b + lane < end) run.add(bins, __ldg(seg + b + lane));
    const uint4* body = reinterpret_cast<const uint4*>(seg);
    for (int q0 = a / 8 + lane; q0 < b / 8; q0 += 4 * 32) {
      uint4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (q0 + u * 32 < b / 8) v[u] = __ldg(body + q0 + u * 32);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (q0 + u * 32 < b / 8) run.add8(bins, v[u]);
    }
  }
  run.flush(bins);
  // the Q CTAs of this cluster (neighbouring parts of the range) merge
  // their bins through DSMEM: CTA k of the cluster sums rows [k R / Q,
  // (k + 1) R / Q) of all Q and stores them as the cluster's partial
  cluster_sync();
  const int k = (int)cluster_ctarank(), Q = (int)cluster_nctarank();
  const int lo = (int)((long long)rows_per_range * k / Q);
  const int hi = (int)((long long)rows_per_range * (k + 1) / Q);
  int4* out = partial +
              ((size_t)(blockIdx.x / Q) * RANGES + j) * rows_per_range;
  for (int r = lo + threadIdx.x; r < hi; r += C_THREADS) {
    int x = 0, y = 0, z = 0, w = 0;
    for (int q = 0; q < Q; ++q) {
      const int4 v = dsmem_ld4(dsmem_map(bins4 + r, q));
      x += v.x; y += v.y; z += v.z; w += v.w;
    }
    out[r] = make_int4(x, y, z, w);
  }
  // no CTA leaves while a peer may still read its bins
  cluster_sync();
}

// 3. counts[e] = the sum over the parts' partials of edge e's row (range
// e % 16, row e / 16); a warp's 32 edges read 16 whole 32-byte sectors a
// partial
__global__ void __launch_bounds__(SUM_THREADS)
hist_sum_kernel(const int4* __restrict__ partial, int parts,
                int rows_per_range, int n_edges, int4* __restrict__ counts) {
  const int e = blockIdx.x * SUM_THREADS + threadIdx.x;
  if (e >= n_edges) return;
  const int4* p = partial + (size_t)(e & (RANGES - 1)) * rows_per_range +
                  (e >> 4);
  const size_t step = (size_t)RANGES * rows_per_range;
  int x = 0, y = 0, z = 0, w = 0;
  for (int q = 0; q < parts; ++q, p += step) {
    const int4 v = __ldg(p);
    x += v.x; y += v.y; z += v.z; w += v.w;
  }
  counts[e] = make_int4(x, y, z, w);
}

// keys: (ceil(N / 8192) * 8192,) uint16 scratch (a tile's keys leave in
// whole 16-byte stores); offsets: (ceil(N / 8192), 17) int32 scratch;
// partial: (parts, 16, ceil(n_edges / 16), 4) int32 scratch (the first
// parts / Q used); counts: (n_edges, 4) int32, 16-byte aligned.  Three
// launches.
extern "C" int ingest_hist_buckets_launch(
    const int32_t* edge_id, const uint8_t* callee_failed,
    const uint8_t* caller_errored, long long n, int n_edges, uint16_t* keys,
    int* offsets, int* partial, int parts, int* counts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int rows_per_range = (n_edges + RANGES - 1) / RANGES;
  const size_t smem = (size_t)rows_per_range * 16;
  const long long tiles = (n + TILE - 1) / TILE;
  if (n < 1 || n_edges < 1 || parts < 1 || smem > SMEM_OPTIN_BYTES ||
      tiles > 0x7fffffff || reinterpret_cast<uintptr_t>(counts) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int vec = reinterpret_cast<uintptr_t>(edge_id) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(callee_failed) % 8 == 0 &&
                  reinterpret_cast<uintptr_t>(caller_errored) % 8 == 0;
  hist_partition_kernel<<<(unsigned)tiles, P_THREADS, 0, s>>>(
      edge_id, callee_failed, caller_errored, n, n_edges, vec, keys,
      offsets);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the largest cluster of parts (4, 2 or 1, dividing parts) of which the
  // card holds all the launch's clusters at once
  int Q = 1;
  for (int q = 4; q > 1; q /= 2) {
    if (parts % q) continue;
    int fit = 0;
    const int rc = cluster_fit(hist_count_kernel, q, C_THREADS, smem, s, &fit);
    if (rc != 0) return rc;
    if (fit >= parts / q * RANGES) {
      Q = q;
      break;
    }
  }
  int4* part = reinterpret_cast<int4*>(partial);
  const int rc = launch_cluster(hist_count_kernel, dim3(parts, RANGES),
                                (unsigned)Q, C_THREADS, smem, s, keys,
                                offsets, (int)tiles, rows_per_range, part);
  if (rc != 0) return rc;
  hist_sum_kernel<<<(n_edges + SUM_THREADS - 1) / SUM_THREADS, SUM_THREADS,
                    0, s>>>(part, parts / Q, rows_per_range, n_edges,
                            reinterpret_cast<int4*>(counts));
  return (int)cudaGetLastError();
}
