// ELL failure propagation to its least fixed point for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/ufa/propagation.py
// (fixed_point_ell / _round_kernel): Jacobi rounds, for every dark-set
// row s and caller u,
//
//   hit[s, u] = any_k cur[s, ell_dst[u, k]] & ell_closed[u, k]
//   nxt[s, u] = cur[s, u] | hit[s, u]
//
// until a round changes nothing or n + 1 rounds ran, counting the final
// no-change round, as the reference's while_loop does.  Rounds are
// double-buffered (read cur, write nxt, swap): updating in place would
// let a hit travel several hops in one round and converge in fewer
// rounds than the reference, breaking the exact `rounds`.
//
// Two routes, picked by the wrapper from the shape alone
// (kernels/ufa/propagation.py::fixed_point_route):
//
// "cluster" (one CTA's share of the graph fits its shared memory, as at
// paper scale): ONE launch per fixed point, rounds on the device.  Rows
// are independent, so the slab is cut into groups of up to 32 rows and a
// service's state in a group is one uint32, bit r for row r: a round
// gathers one word a closed slot for 32 rows at once.  A group is run by
// a thread-block cluster of C CTAs (8, or 16 where 8 cannot hold the
// graph); as many clusters as the card holds at once take the groups in
// turn.  CTA r owns callers [r m, (r + 1) m), m = ceil(n / C), and keeps
// their words (two buffers) in shared memory.  At the start it reads its
// callers' ELL rows once, checks every id against [0, n) (a bad one sets
// the device error flag and is never read) and keeps, per caller, the
// DSMEM addresses of its closed slots' callee words, slot-major so that
// neighbouring threads read neighbouring words, for all its groups.  Per
// group it reads the group's dark bytes into words.  A round: each thread
// ORs its callers' callee words, read from their owner CTAs through
// DSMEM, writes nxt, and the CTA tells every CTA of the cluster whether
// any of its words changed (a flag per round parity in each CTA, so the
// reset of one round's flag never races the next round's writers); then
// barrier.cluster, and every CTA reads its own flag and goes on or stops
// with the others.  A group's rounds are capped at n + 1; the call's
// `rounds` is the maximum over groups (atomicMax into a device int): the
// slab stops changing when its last group does.  Clusters never wait on
// each other.  Each CTA finally writes its callers' bytes of the
// group's rows, coalesced, 4 bytes a store.
//
// What bounds the cluster route: the barrier and DSMEM latency of a
// round, not bytes.  The adjacency (n K 5 bytes, 1.76 MB at n 21,979,
// K 16) and the dark slab are read once, `broken` written once; between
// rounds the words and the closed slots stay on chip.
//
// "rounds" (larger graphs): the first design, one launch per round, one
// thread per (row, caller) walking its K slots through L1/L2, the host
// reading the device's `changed` flag after each round.

#include "hopper.cuh"

// ---------------------------------------------------------------------------
// route "rounds"
// ---------------------------------------------------------------------------

#define THREADS 256

__global__ void __launch_bounds__(THREADS)
ell_round_kernel(const uint8_t* __restrict__ cur, uint8_t* __restrict__ nxt,
                 const int32_t* __restrict__ ell_dst,
                 const uint8_t* __restrict__ ell_closed, int U, int n, int K,
                 int* __restrict__ changed) {
  const size_t idx = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (size_t)U * n) return;
  const size_t row = idx / (size_t)n;
  const size_t u = idx - row * (size_t)n;
  uint8_t b = cur[idx];
  if (!b) {
    const uint8_t* brow = cur + row * (size_t)n;
    const int32_t* dst = ell_dst + u * (size_t)K;
    const uint8_t* closed = ell_closed + u * (size_t)K;
    for (int k = 0; k < K; ++k) {
      if (closed[k] && brow[dst[k]]) {
        b = 1;
        break;
      }
    }
    if (b) *changed = 1;  // every writer stores the same value
  }
  nxt[idx] = b;
}

extern "C" int ell_round_launch(const uint8_t* cur, uint8_t* nxt,
                                const int32_t* ell_dst,
                                const uint8_t* ell_closed, int U, int n,
                                int K, int* changed, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (U < 1 || n < 1 || K < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(changed, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)U * n;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  ell_round_kernel<<<blocks, THREADS, 0, s>>>(cur, nxt, ell_dst, ell_closed,
                                              U, n, K, changed);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// route "cluster"
// ---------------------------------------------------------------------------

#define CL_THREADS 1024
#define ROWS 32  // dark-set rows a group: the bits of a word

// shared memory of a CTA owning m callers (the wrapper's route mirrors
// it): two int flags (and padding to 16 bytes), the words (2 x m uint32),
// the closed slots' callee addresses (K x m uint32, slot-major) and the
// closed-slot counts (m uint16)
static size_t cluster_smem(int m, int K) {
  return 16 + (size_t)m * (8 + 4 * (size_t)K + 2);
}

__global__ void __launch_bounds__(CL_THREADS, 1)
ell_cluster_kernel(const uint8_t* __restrict__ dark,
                   uint8_t* __restrict__ broken,
                   const int32_t* __restrict__ ell_dst,
                   const uint8_t* __restrict__ ell_closed, int U, int n,
                   int K, int m, int groups, int vec,
                   int* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  int* flag = reinterpret_cast<int*>(smem);  // [round parity]
  uint32_t* words = reinterpret_cast<uint32_t*>(smem + 16);  // [2][m]
  uint32_t* slots = words + 2 * (size_t)m;                   // [K][m]
  uint16_t* nslot = reinterpret_cast<uint16_t*>(slots + (size_t)K * m);

  const uint32_t rank = cluster_ctarank();
  const uint32_t C = cluster_nctarank();
  const int u0 = (int)rank * m;
  const int mine = max(0, min(m, n - u0));  // callers this CTA owns

  // each owned caller's ELL row, read once (16-byte id loads and 4-byte
  // flag loads where K % 4 == 0 and the rows are so aligned): every id is
  // checked against [0, n), and each closed slot's callee address goes to
  // the front of the caller's column.  Kept for every row group the
  // cluster takes.  The owner rank v / m comes from a float reciprocal
  // (exact after one correction: v < 2^24 on this route), not a divide.
  int bad = 0;
  const float inv_m = 1.0f / (float)m;
  for (int i = threadIdx.x; i < mine; i += CL_THREADS) {
    const int32_t* drow = ell_dst + (size_t)(u0 + i) * K;
    const uint8_t* crow = ell_closed + (size_t)(u0 + i) * K;
    int c = 0;
    auto put = [&](int v, uint32_t cl) {
      if (v < 0 || v >= n) {
        bad = 1;
      } else if (cl) {
        int r = __float2int_rz((float)v * inv_m);
        r -= r * m > v;
        r += (r + 1) * m <= v;
        slots[(size_t)(c++) * m + i] = dsmem_map(words + (v - r * m), r);
      }
    };
    if (vec) {
#pragma unroll 4
      for (int k = 0; k < K; k += 4) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(drow + k));
        const uint32_t f = __ldg(reinterpret_cast<const uint32_t*>(crow + k));
        put(v.x, f & 0xffu);
        put(v.y, f & 0xff00u);
        put(v.z, f & 0xff0000u);
        put(v.w, f & 0xff000000u);
      }
    } else {
      for (int k = 0; k < K; ++k) put(__ldg(drow + k), __ldg(crow + k));
    }
    nslot[i] = (uint16_t)c;
  }
  if (bad) atomicOr(out + 1, 1);

  // the cluster takes row groups blockIdx.y, + gridDim.y, ...: as many
  // clusters as the card holds at once, each reusing its slots
  const uint32_t step = (uint32_t)m * 4;  // bytes from words[0] to words[1]
  for (int group = blockIdx.y; group < groups; group += gridDim.y) {
    const int row0 = group * ROWS;
    const int rows = min(ROWS, U - row0);
    const uint32_t full = rows == ROWS ? 0xffffffffu : (1u << rows) - 1u;
    // the last group's reads of flags and words are done
    __syncthreads();
    if (threadIdx.x < 2) flag[threadIdx.x] = 0;
    // the group's dark bits of each owned caller: its bytes of the
    // group's rows, sixteen loads in flight, coalesced over the callers
    for (int i = threadIdx.x; i < mine; i += CL_THREADS) {
      const uint8_t* d = dark + (size_t)row0 * n + u0 + i;
      uint32_t w = 0;
      for (int b0 = 0; b0 < rows; b0 += 16) {
        uint32_t v[16];
#pragma unroll
        for (int q = 0; q < 16; ++q)
          v[q] = __ldg(d + (size_t)min(b0 + q, rows - 1) * n);
#pragma unroll
        for (int q = 0; q < 16; ++q)
          if (b0 + q < rows && v[q]) w |= 1u << (b0 + q);
      }
      words[i] = w;
    }
    // every CTA's words and flags are set before any peer reads them
    cluster_sync();

    uint32_t par = 0;
    int rounds = 0;
    bool go = true;
    while (go) {
      const uint32_t* cur = words + par * m;
      uint32_t* nxt = words + (par ^ 1) * m;
      const uint32_t off = par * step;
      int changed = 0;
      for (int i = threadIdx.x; i < mine; i += CL_THREADS) {
        const uint32_t w0 = cur[i];
        uint32_t w = w0;
        if (w != full) {
          const int c = nslot[i];
          const uint32_t* s = slots + i;
          int k = 0;
          for (; k + 4 <= c; k += 4) {  // four gathers in flight
            const uint32_t a = dsmem_ld(s[(size_t)k * m] + off);
            const uint32_t b = dsmem_ld(s[(size_t)(k + 1) * m] + off);
            const uint32_t d = dsmem_ld(s[(size_t)(k + 2) * m] + off);
            const uint32_t e = dsmem_ld(s[(size_t)(k + 3) * m] + off);
            w |= a | b | d | e;
          }
          for (; k < c; ++k) w |= dsmem_ld(s[(size_t)k * m] + off);
        }
        nxt[i] = w;
        changed |= w != w0;
      }
      // all of this CTA's threads have read last round's flag by now
      changed = __syncthreads_or(changed);
      if (threadIdx.x == 0) flag[par ^ 1] = 0;
      if (changed && threadIdx.x < C)
        dsmem_st(dsmem_map(flag + par, threadIdx.x), 1);
      cluster_sync();
      ++rounds;
      go = flag[par] != 0 && rounds < n + 1;
      par ^= 1;
    }
    // no peer reads this CTA's words or writes its flags after the last
    // round's cluster barrier until the next group's first one, so the
    // CTA may write its rows, and finish, on its own
    if (rank == 0 && threadIdx.x == 0) atomicMax(out, rounds);
    // each row's bytes, four callers a 4-byte store aligned to the row
    // (its first bytes and its last ones one at a time): thread t holds
    // the words of callers 4t .. 4t + 7 and, for each row, stores the
    // four bytes the row's alignment puts in its word t
    const uint32_t* fin = words + par * m;
    for (int t = threadIdx.x; 4 * t < mine + 3; t += CL_THREADS) {
      uint32_t w[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        w[k] = 4 * t + k < mine ? fin[4 * t + k] : 0u;
      for (int b = 0; b < rows; ++b) {
        uint8_t* o = broken + (size_t)(row0 + b) * n + u0;
        const int head = (int)((4 - (reinterpret_cast<uintptr_t>(o) & 3)) & 3);
        uint32_t bits = 0;  // row b's bits of callers 4t .. 4t + 7
#pragma unroll
        for (int k = 0; k < 8; ++k) bits |= ((w[k] >> b) & 1u) << k;
        const int first = head + 4 * t;  // the callers of word t
        if (first + 4 <= mine) {
          const uint32_t x = bits >> head;
          reinterpret_cast<uint32_t*>(o + head)[t] =
              (x & 1u) | (x & 2u) << 7 | (x & 4u) << 14 | (x & 8u) << 21;
        } else {  // the row's last callers, past its last whole word
          for (int k = max(first, 4 * t); k < min(first + 4, mine); ++k)
            o[k] = (bits >> (k - 4 * t)) & 1u;
        }
        if (t == 0)  // the row's first callers, before its first word
          for (int k = 0; k < min(head, mine); ++k) o[k] = (w[k] >> b) & 1u;
      }
    }
  }
}

// the cluster route's shared memory for n callers in clusters of C CTAs
static int cluster_shape(int n, int K, int C, int* m, size_t* smem) {
  if (n < 1 || K < 1 || (C != 8 && C != 16)) return (int)cudaErrorInvalidValue;
  *m = (n + C - 1) / C;
  *smem = cluster_smem(*m, K);
  return *smem <= SMEM_OPTIN_BYTES ? 0 : (int)cudaErrorInvalidValue;
}

// dark, broken: (U, n) bytes; out: 2 ints, set to {rounds, error}.  One
// launch of min(ceil(U / 32), clusters that fit at once) clusters of C
// CTAs, each taking row groups in turn.
extern "C" int ell_cluster_launch(const uint8_t* dark, uint8_t* broken,
                                  const int32_t* ell_dst,
                                  const uint8_t* ell_closed, int U, int n,
                                  int K, int C, int* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int m;
  size_t smem;
  int rc = cluster_shape(n, K, C, &m, &smem);
  if (rc != 0) return rc;
  const int groups = (U + ROWS - 1) / ROWS;
  if (U < 1 || groups > 65535) return (int)cudaErrorInvalidValue;
  int fit = 0;
  rc = cluster_fit(ell_cluster_kernel, C, CL_THREADS, smem, s, &fit);
  if (rc != 0) return rc;
  if (fit < 1) return (int)cudaErrorInvalidConfiguration;
  const cudaError_t err = cudaMemsetAsync(out, 0, 2 * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const int vec = K % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(ell_dst) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(ell_closed) % 4 == 0;
  return launch_cluster(ell_cluster_kernel,
                        dim3(C, groups < fit ? groups : fit), (unsigned)C,
                        CL_THREADS, smem, s, dark, broken, ell_dst,
                        ell_closed, U, n, K, m, groups, vec, out);
}
