// Decode attention (one query token per sequence) for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/decode_attention.py:103
// (decode_attention / _decode_kernel :27): q (B, H, d) against K/V caches
// in the model layout (B, K, KV, d), GQA group g = H / KV per KV head (any
// g); cache position p counts for sequence b when
//
//   p < length  and  (window <= 0 or length - 1 - p < window)
//
// softmax over those positions in float32 with the kernel's finite
// -1e30 mask and its max(l, 1e-30) denominator, so that length 0 gives
// zeros.  length and window are read from device memory when the caller
// passes 0-d int32 tensors (no host synchronisation, as the TPU kernel's
// scalar prefetch), or taken by value from Python ints.
//
// Head dims: any d >= 1 (the reference's kernel makes each block the full
// head dim, so it takes any d).  Each route is instantiated for a few
// widths DH, and the caller (kernels/backend.py padded_head_dim, the one
// width rule) passes the smallest DH >= d (fma: 8, 16, 32, 64, 128, 256;
// mma: 64, 128, 256) with the columns past d zero: loads past d are not
// issued (fma) or zero-filled by TMA (mma), and Q's columns past d are
// zero, so Q K^T is the sum over d alone, and the scale is 1 / sqrt(d) of
// the true d.  Output columns past d are never stored, and the partials'
// rows are d wide.  The padded columns cost their share of the work (d 80
// runs DH 128): a known cost, not optimised.  Above 256 the caller passes
// DH 256 and the fma kernel splits the output's d across ceil(d / 256)
// blocks (WIDE): each computes the whole q . k over d in 256-wide slices
// and accumulates p v for its own 256 columns, so the scores are computed
// ceil(d / 256) times.  Rows that TMA cannot read (a 16-bit d that is not
// a multiple of 8, rows off 16-byte alignment) take the fma kernel too,
// reading element by element: no padded copy of the cache is made.
//
// What bounds it: bytes.  Every valid K and V row is read once: at
// llama3.2-3b (B 8, KV 8, d 128, bf16, length 6,000) that is 197 MB,
// 0.059 ms at 3.35 TB/s, against 1.2 flops per byte.
//
// Splits (FlashDecoding).  The host (kernels/decode_attention.py,
// split_count) launches nsplit blocks per (KV head sub-group, sequence),
//
//   nsplit = max(1, min(ceil(K / BK), resident / (B * KV * n_sub)))
//
// with `resident` the SMs times the blocks an SM holds of this kernel
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), so that the grid runs
// as one wave where it can.  Each block reads length and window and finds
// its own share of the valid range (split_range below; split_tiles in the
// wrapper repeats it, and the CPU tests check that the shares cover the
// range once):
//
//   hi = min(length, K),  lo = window > 0 ? max(0, length - window) : 0
//   no tile when hi <= lo; else t0 = lo / BK, n = ceil(hi / BK) - t0,
//   split sp takes tiles [t0 + n sp / nsplit, t0 + n (sp + 1) / nsplit)
//
// Tiles are BK positions at absolute multiples of BK, so no tile is read
// by two blocks and the shares differ by at most one tile.  A block
// without a tile writes m = -1e30, l = 0 and a zero accumulator.  Each
// block writes one partial (m, l, acc) per query head, and a second
// kernel combines a head's nsplit partials by log-sum-exp, divides by
// max(l, 1e-30) and stores in q's dtype.
//
// bf16 and fp16 (route "mma": d a multiple of 8 up to 256, TMA-readable
// rows): FlashDecoding with the GQA group as the M dimension of the
// tensor-core tile, as FlashInfer runs GQA decode; one kernel for both
// 16-bit types (mma.sync m16n8k16 and TMA take either).
//  - A block takes a sub-group of at most 16 query heads of one KV head
//    (n_sub = ceil(g / 16) sub-groups, balanced), its rows zero-padded
//    to 16 in shared memory.
//  - One producer warp keeps a ring of K and V tiles full by TMA under
//    mbarriers: a BK x DH tile of one KV head comes in as DH / 64 boxes of
//    BK x 64 through a 4-D tensor map over the cache, dims (d, KV, K, B)
//    with the tensor's own byte strides (a multiple of 16 bytes: d % 8 ==
//    0), under the 128-byte swizzle; TMA zero-fills positions past K and
//    columns past d.  A box that lies wholly past d is not loaded: its
//    stages are zeroed once when the block starts.  STAGES x 2 tiles are
//    in flight a block (96 KB at d 128, two blocks an SM): the ring's
//    depth, not the register file, sets the bytes in flight.
//  - Four consumer warps take 16 positions each of every tile.  S = Q K^T
//    on mma.sync m16n8k16: Q's A fragments stay in registers for d <= 128
//    (re-read by ldmatrix from shared memory at d 256, where the 16 x 256
//    float32 accumulator takes 128 registers), K's B fragments come by
//    ldmatrix from the swizzled tile (the 16-byte chunk c of row r sits
//    at chunk c ^ (r % 8)).  The float32 scores are scaled by
//    scale * log2(e) after the product (a 16-bit q cannot carry the scale),
//    positions outside [lo, hi) are set to -1e30 and their weights forced
//    to 0, and the online softmax runs in base 2 in registers.  O += P V
//    takes P as two 16-bit terms, P_hi + P_lo (one bf16 P fails the bf16
//    limit, as for flash attention), against V's B fragments by
//    ldmatrix.trans.
//  - The four warps' (m, l, O) are merged through shared memory (the
//    consumed ring) at the end.
//
// float32, and the 16-bit inputs the mma route does not take (route
// "fma"): scalar IEEE float32 FMAs on the values widened to float32, whose
// 3e-5 tolerance rules out bf16 and TF32 products.  One block of four
// warps per (split, column block when WIDE,
// sub-group of at most 8 query heads, sequence).  A row of d elements is
// held by a lane group of LPR lanes, EPL elements a lane: for d >= 64 the
// whole warp (LPR 32, EPL d / 32); below, four elements a lane (one
// 16-byte load) and 32 / LPR groups a warp (d 32: 4 groups of 8 lanes,
// d 16: 8 of 4, d 8: 16 of 2).  Each lane group walks its own positions
// four at a time and requests the four K rows and the four V rows of a
// step before it uses any; the groups of a warp take neighbouring
// positions of one step, so the warp's loop stays uniform and its
// shuffles full.  The sub-group's query rows and accumulators stay in
// registers, sized by the sub-group rounded up to 1, 2, 4 or 8.  Scores
// are all-reduces over a lane group (__shfl_xor_sync at offsets below
// LPR), and every lane group's (m, l, acc) is merged through shared
// memory at the end of the block.  The caches are read through their
// strides on both routes, so the model layout is never transposed.

#include "hopper.cuh"

#define BK 64  // cache positions a tile: one split's unit of work

// the valid positions [lo, hi) and split sp's tiles [t_begin, t_end)
struct Range {
  int lo, hi, t_begin, t_end;
};

__device__ __forceinline__ Range split_range(int length, int window, int K,
                                             int sp, int nsplit) {
  Range r;
  r.hi = min(length, K);
  r.lo = window > 0 ? (int)max(0LL, (long long)length - window) : 0;
  r.t_begin = r.t_end = 0;
  if (r.hi > r.lo) {
    const int t0 = r.lo / BK;
    const long long n = (r.hi + BK - 1) / BK - t0;
    r.t_begin = t0 + (int)(n * sp / nsplit);
    r.t_end = t0 + (int)(n * (sp + 1) / nsplit);
  }
  return r;
}

// ---------------------------------------------------------------------------
// float32: scalar FMAs
// ---------------------------------------------------------------------------

#define NW 4     // warps a block
#define U 4      // positions a warp takes per step
#define FMA_G 8  // query heads a block, at most

// The float32 kernel's row layout for head size DH: elements a lane, lanes
// a row, rows (lane groups) a warp.
template <int DH>
struct Lanes {
  static constexpr int EPL = DH >= 64 ? DH / 32 : 4;
  static constexpr int LPR = DH / EPL;
  static constexpr int NG = 32 / LPR;
  static_assert(EPL * LPR == DH && NG * LPR == 32, "d in 8, 16, ..., 256");
};

// the sum of v over the LPR lanes of each aligned lane group (the whole
// warp for LPR 32), in every lane of the group
template <int LPR>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// EPL elements of a row from p (column c of d, c < d: the caller skips
// a lane whose columns are all past d) widened to float: one vector load
// when VEC (d a multiple of EPL, rows aligned), else one by one, zeros at
// or past d
template <int EPL, bool VEC, typename T>
__device__ __forceinline__ void load_row(const T* p, int c, int d,
                                         float* o) {
  if constexpr (VEC) {
    load_f<EPL>(p, o);
  } else {
#pragma unroll
    for (int t = 0; t < EPL; ++t) o[t] = c + t < d ? to_f(p[t]) : 0.f;
  }
}

// G: the block's sub-group size rounded up to 1, 2, 4 or 8 (gs <= G query
// heads are live; the registers are sized by G).  Blocks (sp, (n * n_sub +
// sub) ncb + cb, b): heads n g + sub gsz .. + gs - 1, output columns
// [cb DH, cb DH + DH) (ncb = ceil(d / DH) when WIDE, else 1).  T: the
// storage type of q and the caches; VEC: vector loads (d a multiple of
// EPL, rows aligned), else element loads.
template <typename T, int DH, int G, bool WIDE, bool VEC>
__global__ void __launch_bounds__(NW * 32)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                      const T* __restrict__ vc, long long kb, long long kp,
                      long long kn, long long vb, long long vp, long long vn,
                      int H, int K, int d, int g, int gsz, int n_sub,
                      int nsplit,
                      const int* len_dev, int len_host, const int* win_dev,
                      int win_host, float scale,
                      float* __restrict__ part_acc,
                      float* __restrict__ part_ml) {
  constexpr int EPL = Lanes<DH>::EPL, LPR = Lanes<DH>::LPR;
  constexpr int NG = Lanes<DH>::NG, NV = NW * NG;  // lane groups a block
  const int sp = blockIdx.x, b = blockIdx.z;
  const int ncb = WIDE ? (d + DH - 1) / DH : 1;
  const int cb = WIDE ? blockIdx.y % ncb : 0, c0 = cb * DH;
  const int ny = WIDE ? blockIdx.y / ncb : blockIdx.y;
  const int n = ny / n_sub, sub = ny % n_sub;
  const int h0 = n * g + sub * gsz, gs = min(gsz, g - sub * gsz);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / LPR, col = (lane % LPR) * EPL;
  const bool live = col < d;       // the lane's first column is below d
  const int vg = warp * NG + grp;  // the lane group's index in the block
  const Range r = split_range(len_dev ? *len_dev : len_host,
                              win_dev ? *win_dev : win_host, K, sp, nsplit);
  const int lo = max(r.lo, r.t_begin * BK), hi = min(r.hi, r.t_end * BK);

  float qf[G][EPL], acc[G][EPL], m[G], l[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    m[j] = NEG_INF;
    l[j] = 0.f;
#pragma unroll
    for (int t = 0; t < EPL; ++t) acc[j][t] = qf[j][t] = 0.f;
    if (!WIDE && j < gs && live) {
      load_row<EPL, VEC>(q + ((long long)b * H + h0 + j) * d + col, col, d,
                         qf[j]);
#pragma unroll
      for (int t = 0; t < EPL; ++t) qf[j][t] *= scale;
    }
  }

  const T* kbase = kc + b * kb + n * kn + col;
  const T* vbase = vc + b * vb + n * vn + col + c0;
  // the warp's step starts at pw, its lane group's at p0 = pw + grp U; the
  // loop runs while any group of the warp has a position
  for (int pw = lo + warp * NG * U; pw < hi; pw += NV * U) {
    const int p0 = pw + grp * U;
    // every K and V row of the step is requested before any is used
    float kr[U][EPL], vr[U][EPL];
    float s[U][G];
    if constexpr (WIDE) {
      // q . k over all of d, a DH-wide slice of q and k at a time, each
      // lane's share summed over the slices before the group's sum
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < G; ++j) s[u][j] = 0.f;
      for (int d0 = 0; d0 < d; d0 += DH) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (p0 + u < hi && col < d - d0) {
            load_row<EPL, VEC>(kbase + (long long)(p0 + u) * kp + d0, col,
                               d - d0, kr[u]);
          } else {
#pragma unroll
            for (int t = 0; t < EPL; ++t) kr[u][t] = 0.f;
          }
        }
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (j < gs && col < d - d0) {
            load_row<EPL, VEC>(
                q + ((long long)b * H + h0 + j) * d + d0 + col, col, d - d0,
                qf[j]);
#pragma unroll
            for (int t = 0; t < EPL; ++t) qf[j][t] *= scale;
          } else {
#pragma unroll
            for (int t = 0; t < EPL; ++t) qf[j][t] = 0.f;
          }
#pragma unroll
          for (int u = 0; u < U; ++u)
#pragma unroll
            for (int t = 0; t < EPL; ++t)
              s[u][j] = fmaf(qf[j][t], kr[u][t], s[u][j]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int j = 0; j < G; ++j) s[u][j] = group_sum<LPR>(s[u][j]);
        if (p0 + u < hi && col < d - c0) {
          load_row<EPL, VEC>(vbase + (long long)(p0 + u) * vp, col, d - c0,
                             vr[u]);
        } else {
#pragma unroll
          for (int t = 0; t < EPL; ++t) vr[u][t] = 0.f;
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (p0 + u < hi && live) {
          load_row<EPL, VEC>(kbase + (long long)(p0 + u) * kp, col, d, kr[u]);
          load_row<EPL, VEC>(vbase + (long long)(p0 + u) * vp, col, d, vr[u]);
        } else {
#pragma unroll
          for (int t = 0; t < EPL; ++t) kr[u][t] = vr[u][t] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < G; ++j) {
          float dot = 0.f;
#pragma unroll
          for (int t = 0; t < EPL; ++t) dot = fmaf(qf[j][t], kr[u][t], dot);
          s[u][j] = group_sum<LPR>(dot);
        }
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      // a group past hi has no valid position: m stays, alpha is 1
      float mt = NEG_INF;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (p0 + u < hi) mt = fmaxf(mt, s[u][j]);
      const float m_new = fmaxf(m[j], mt);
      const float alpha = expf(m[j] - m_new);
      m[j] = m_new;
      l[j] *= alpha;
#pragma unroll
      for (int t = 0; t < EPL; ++t) acc[j][t] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = p0 + u < hi ? expf(s[u][j] - m_new) : 0.f;
        l[j] += p;
#pragma unroll
        for (int t = 0; t < EPL; ++t) acc[j][t] = fmaf(p, vr[u][t], acc[j][t]);
      }
    }
  }

  // merge the block's lane groups' states, then one partial per query head
  __shared__ float sm_m[NV][G], sm_l[NV][G];
  __shared__ float sm_acc[NV][G][DH];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (lane % LPR == 0) {
      sm_m[vg][j] = m[j];
      sm_l[vg][j] = l[j];
    }
#pragma unroll
    for (int t = 0; t < EPL; ++t) sm_acc[vg][j][col + t] = acc[j][t];
  }
  __syncthreads();
  const int dw = WIDE ? min(DH, d - c0) : d;  // the block's columns
  for (int idx = threadIdx.x; idx < gs * dw; idx += NW * 32) {
    const int j = idx / dw, c = idx % dw;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NV; ++w) M = fmaxf(M, sm_m[w][j]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NV; ++w) {
      const float f = expf(sm_m[w][j] - M);
      L += sm_l[w][j] * f;
      A += sm_acc[w][j][c] * f;
    }
    const long long head = ((long long)b * H + h0 + j) * nsplit + sp;
    part_acc[head * d + c0 + c] = A;
    if (c == 0 && (!WIDE || cb == 0)) {
      part_ml[head * 2] = M;
      part_ml[head * 2 + 1] = L;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 and fp16: TMA ring, mma.sync
// ---------------------------------------------------------------------------

#define NCW 4                 // consumer warps, 16 positions of a tile each
#define NT (32 * (NCW + 1))   // and one producer warp
#define MMA_G 16              // query heads a block, at most (the mma's M)

template <int DH>
struct Cfg {
  static constexpr int NB = DH / 64;       // 64-wide boxes a row
  static constexpr int BOX = BK * 128;     // bytes of a box: BK swizzled rows
  static constexpr int TILE = NB * BOX;    // a K or a V tile
  static constexpr int STAGES = DH == 64 ? 4 : 3;
  static constexpr int MINB = DH == 64 ? 3 : DH == 128 ? 2 : 1;
  static constexpr int RING = STAGES * 2 * TILE;
  static constexpr int QP = DH + 8;        // Q row pitch: ldmatrix without
                                           // bank conflicts
  static constexpr int RP = DH + 4;        // merge row pitch (floats)
  // the ring (1024-byte aligned for the swizzle), Q, the barriers
  static constexpr int SMEM =
      1024 + RING + MMA_G * QP * 2 + 2 * STAGES * (int)sizeof(uint64_t);
  static_assert((NCW * MMA_G * RP + 2 * NCW * MMA_G) * 4 <= RING,
                "the merge must fit in the consumed ring");
};

// T: bf16 or fp16
template <typename T, int DH>
__global__ void __launch_bounds__(NT, Cfg<DH>::MINB)
decode_b16_kernel(__grid_constant__ const CUtensorMap tk,
                   __grid_constant__ const CUtensorMap tv,
                   const T* __restrict__ q, int H, int K, int d, int g,
                   int gsz, int n_sub, int nsplit, const int* len_dev,
                   int len_host,
                   const int* win_dev, int win_host, float scale_log2,
                   float* __restrict__ part_acc, float* __restrict__ part_ml) {
  using C = Cfg<DH>;
  constexpr int NO = DH / 8;          // n8 fragments of O
  constexpr bool Q_REG = DH <= 128;   // Q's A fragments held in registers
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  T(*qs)[C::QP] = reinterpret_cast<T(*)[C::QP]>(ring + C::RING);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + C::RING + MMA_G * C::QP * 2);
  uint64_t* empty = full + C::STAGES;

  const int sp = blockIdx.x, b = blockIdx.z;
  const int n = blockIdx.y / n_sub, sub = blockIdx.y % n_sub;
  const int h0 = n * g + sub * gsz, gs = min(gsz, g - sub * gsz);
  const Range r = split_range(len_dev ? *len_dev : len_host,
                              win_dev ? *win_dev : win_host, K, sp, nsplit);
  const int n_tiles = r.t_end - r.t_begin;
  // partial row of head h0 + j: row0 + j nsplit
  const long long row0 = ((long long)b * H + h0) * nsplit + sp;

  if (n_tiles <= 0) {  // no tile: an empty partial, the ring untouched
    for (int idx = threadIdx.x; idx < gs * d; idx += NT) {
      const int j = idx / d, c = idx % d;
      const long long row = row0 + (long long)j * nsplit;
      part_acc[row * d + c] = 0.f;
      if (c == 0) {
        part_ml[row * 2] = NEG_INF;
        part_ml[row * 2 + 1] = 0.f;
      }
    }
    return;
  }

  // the sub-group's query rows, zero-padded to 16 rows and to DH columns
  for (int idx = threadIdx.x; idx < MMA_G * DH / 8; idx += NT) {
    const int j = idx / (DH / 8), c = (idx % (DH / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (j < gs && c < d)
      v = *reinterpret_cast<const uint4*>(q + ((long long)b * H + h0 + j) *
                                                  d + c);
    *reinterpret_cast<uint4*>(&qs[j][c]) = v;
  }
  // the boxes that TMA loads (those holding a column below d); the rest of
  // every stage is zeroed here once (its K and V must be finite: 0 x NaN)
  const int nb_live = (d + 63) / 64;
  for (int idx = threadIdx.x; idx < C::STAGES * 2 * (C::NB - nb_live) *
                                        (C::BOX / 16); idx += NT) {
    const int per_tile = (C::NB - nb_live) * (C::BOX / 16);
    const int tile = idx / per_tile, off = idx % per_tile;
    *reinterpret_cast<uint4*>(ring + tile * C::TILE + nb_live * C::BOX +
                              off * 16) = make_uint4(0, 0, 0, 0);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);       // the producer's arrival (+ bytes)
      mbar_init(&empty[s], NCW);    // one a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // consumer state: rows grp and grp + 8 of O, columns 8 j + 2 tig (+1)
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;

  if (warp == NCW) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % C::STAGES;
        // the stage's previous round has been read (round 0 passes)
        mbar_wait(&empty[s], ((i / C::STAGES) & 1) ^ 1);
        uint8_t* kt = ring + s * 2 * C::TILE;
        uint8_t* vt = kt + C::TILE;
        mbar_arrive_expect_tx(&full[s], 2 * nb_live * C::BOX);
        const int p = (r.t_begin + i) * BK;
        for (int x = 0; x < nb_live; ++x) {
          tma_load_4d(kt + x * C::BOX, &tk, &full[s], 64 * x, n, p, b);
          tma_load_4d(vt + x * C::BOX, &tv, &full[s], 64 * x, n, p, b);
        }
      }
    }
    __syncwarp();
  } else {
    const int tig = lane % 4;
    // ldmatrix row addresses.  Q's A fragment: rows lane % 16, column
    // block lane / 16.  K's B fragments: positions lane % 8 + 8 (lane /
    // 16) of the warp's 16, 16-byte chunk (lane / 8) % 2 of each k16
    // step.  V's transposed B fragments: positions lane % 16, chunk
    // lane / 16 of each 16 columns.  Every row a lane addresses has
    // r % 8 == lane % 8, which the swizzle XORs into the chunk.
    const T* q_frag = &qs[lane % 16][(lane / 16) * 8];
    const int sw = lane & 7;
    const int k_row = (warp * 16 + lane % 8 + (lane / 16) * 8) * 128;
    const int k_ch = (lane / 8) % 2;
    const int v_row = (warp * 16 + lane % 16) * 128;
    const int v_ch = lane / 16;
    uint32_t qa[Q_REG ? DH / 16 : 1][4];
    if constexpr (Q_REG) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) ldmatrix_x4(qa[kk], q_frag + kk * 16);
    }

    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % C::STAGES;
      mbar_wait(&full[s], (i / C::STAGES) & 1);
      const uint8_t* kt = ring + s * 2 * C::TILE;
      const uint8_t* vt = kt + C::TILE;
      const int p0 = (r.t_begin + i) * BK + warp * 16;
      // a warp whose 16 positions are all masked changes nothing; one
      // that straddles lo or hi tests them one by one
      const bool none = p0 + 16 <= r.lo || p0 >= r.hi;
      const bool edge = p0 < r.lo || p0 + 16 > r.hi;
      if (!none) {
        // S = Q K^T: two n8 fragments, positions 0-7 and 8-15
        float sc[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          uint32_t a[4], bb[4];
          if constexpr (Q_REG) {
#pragma unroll
            for (int e = 0; e < 4; ++e) a[e] = qa[kk][e];
          } else {
            ldmatrix_x4(a, q_frag + kk * 16);
          }
          const int ch = ((kk & 3) * 2 + k_ch) ^ sw;
          ldmatrix_x4(bb, kt + (kk >> 2) * C::BOX + k_row + ch * 16);
          mma16<T>(sc[0], a, bb);
          mma16<T>(sc[1], a, bb + 2);
        }

        // scores in base-2 units; masked ones at -1e30, their weights 0
        uint32_t masked = 0;  // bit 4 j + e: sc[j][e] is masked
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sc[j][e] *= scale_log2;
            const int p = p0 + j * 8 + tig * 2 + (e & 1);
            if (edge && (p < r.lo || p >= r.hi)) {
              sc[j][e] = NEG_INF;
              masked |= 1u << (4 * j + e);
            }
          }
        float mx_lo = fmaxf(fmaxf(sc[0][0], sc[0][1]), fmaxf(sc[1][0], sc[1][1]));
        float mx_hi = fmaxf(fmaxf(sc[0][2], sc[0][3]), fmaxf(sc[1][2], sc[1][3]));
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
          mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
        }
        const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
        const float al_lo = exp2f(m_lo - mn_lo), al_hi = exp2f(m_hi - mn_hi);
        m_lo = mn_lo;
        m_hi = mn_hi;
        float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = (masked >> (4 * j + e)) & 1u
                                ? 0.f
                                : exp2f(sc[j][e] - (e < 2 ? mn_lo : mn_hi));
            sc[j][e] = p;
            if (e < 2) sum_lo += p; else sum_hi += p;
          }
        l_lo = l_lo * al_lo + sum_lo;
        l_hi = l_hi * al_hi + sum_hi;
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          acc[j][0] *= al_lo;
          acc[j][1] *= al_lo;
          acc[j][2] *= al_hi;
          acc[j][3] *= al_hi;
        }

        // O += P V with P = P_hi + P_lo, the A fragment straight from the
        // S fragments: rows g (positions 2t, 2t + 1, then 2t + 8, 2t + 9)
        // from sc[0][0..1] and sc[1][0..1], rows g + 8 from [2..3]
        uint32_t hi[4], lo[4];
        pack2_hi_lo<T>(sc[0][0], sc[0][1], hi[0], lo[0]);
        pack2_hi_lo<T>(sc[0][2], sc[0][3], hi[1], lo[1]);
        pack2_hi_lo<T>(sc[1][0], sc[1][1], hi[2], lo[2]);
        pack2_hi_lo<T>(sc[1][2], sc[1][3], hi[3], lo[3]);
#pragma unroll
        for (int dj = 0; dj < NO / 2; ++dj) {
          uint32_t bb[4];
          const int ch = ((dj & 3) * 2 + v_ch) ^ sw;
          ldmatrix_x4_trans(bb, vt + (dj >> 2) * C::BOX + v_row + ch * 16);
          mma16<T>(acc[2 * dj], hi, bb);
          mma16<T>(acc[2 * dj], lo, bb);
          mma16<T>(acc[2 * dj + 1], hi, bb + 2);
          mma16<T>(acc[2 * dj + 1], lo, bb + 2);
        }
      }
      __syncwarp();  // every lane has read the stage
      if (lane == 0) mbar_arrive(&empty[s]);
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
  }

  // merge the four consumer warps' (m, l, O) through the consumed ring
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);  // [NCW][16][RP]
  float* red_m = red + NCW * MMA_G * C::RP;     // [NCW][16]
  float* red_l = red_m + NCW * MMA_G;
  if (warp < NCW) {
    const int grp = lane / 4, tig = lane % 4;
    float* lo_row = red + (warp * MMA_G + grp) * C::RP;
    float* hi_row = lo_row + 8 * C::RP;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int c = j * 8 + tig * 2;
      *reinterpret_cast<float2*>(lo_row + c) = make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(hi_row + c) = make_float2(acc[j][2], acc[j][3]);
    }
    if (tig == 0) {
      red_m[warp * MMA_G + grp] = m_lo;
      red_m[warp * MMA_G + grp + 8] = m_hi;
      red_l[warp * MMA_G + grp] = l_lo;
      red_l[warp * MMA_G + grp + 8] = l_hi;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < gs * d; idx += NT) {
    const int j = idx / d, c = idx % d;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NCW; ++w) M = fmaxf(M, red_m[w * MMA_G + j]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NCW; ++w) {
      const float f = exp2f(red_m[w * MMA_G + j] - M);
      L += red_l[w * MMA_G + j] * f;
      A += red[(w * MMA_G + j) * C::RP + c] * f;
    }
    const long long row = row0 + (long long)j * nsplit;
    part_acc[row * d + c] = A;
    if (c == 0) {
      part_ml[row * 2] = M;  // base-2 units
      part_ml[row * 2 + 1] = L;
    }
  }
}

// ---------------------------------------------------------------------------
// combine, launch
// ---------------------------------------------------------------------------

// a thread per output column: blocks (sequence x query head, a block of
// at most 1,024 columns); m in base-2 units from the mma kernel (BASE2),
// natural units from the fma one
template <typename T, bool BASE2>
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_ml,
                                      T* __restrict__ out, int nsplit,
                                      int dh) {
  const long long bh = blockIdx.x;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= dh) return;
  const float* ml = part_ml + bh * nsplit * 2;
  const float* pa = part_acc + bh * nsplit * dh + c;
  float M = NEG_INF;
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, ml[2 * s]);
  float L = 0.f, A = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const float f = BASE2 ? exp2f(ml[2 * s] - M) : expf(ml[2 * s] - M);
    L += ml[2 * s + 1] * f;
    A += pa[(long long)s * dh] * f;
  }
  out[bh * dh + c] = from_f<T>(A / fmaxf(L, 1e-30f));
}

// a group of g query heads as n_sub sub-groups of at most `most`, the
// first ones of gsz heads
static void sub_groups(int g, int most, int* n_sub, int* gsz) {
  *n_sub = (g + most - 1) / most;
  *gsz = (g + *n_sub - 1) / *n_sub;
}

template <typename T, int DH, int G, bool WIDE, bool VEC>
static cudaError_t launch_fma(const void* q, const void* k, const void* v,
                              const long long* ks, const long long* vs,
                              int B, int H, int KV, int K, int nsplit,
                              const int* len_dev, int len_host,
                              const int* win_dev, int win_host, float scale,
                              float* part_acc, float* part_ml, void* out,
                              int d, cudaStream_t st) {
  const int g = H / KV;
  int n_sub, gsz;
  sub_groups(g, FMA_G, &n_sub, &gsz);
  const long long ncb = WIDE ? (d + DH - 1) / DH : 1;
  if ((long long)KV * n_sub * ncb > 65535) return cudaErrorInvalidValue;
  const dim3 grid(nsplit, (unsigned)(KV * n_sub * ncb), B);
  decode_partial_kernel<T, DH, G, WIDE, VEC><<<grid, NW * 32, 0, st>>>(
      (const T*)q, (const T*)k, (const T*)v, ks[0], ks[1], ks[2], vs[0],
      vs[1], vs[2], H, K, d, g, gsz, n_sub, nsplit, len_dev, len_host,
      win_dev, win_host, scale, part_acc, part_ml);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 cgrid(B * H, (d + 1023) / 1024);
  decode_combine_kernel<T, false><<<cgrid, d < 1024 ? d : 1024, 0, st>>>(
      part_acc, part_ml, (T*)out, nsplit, d);
  return cudaGetLastError();
}

// a cache (B, K, KV, d) of 16-bit elements (fp16 when f16) with element
// strides {batch, position, head} as the 4-D map (d, KV, K, B), read in
// boxes of 64 x 1 x BK x 1 (zero-filled past d and K)
static int encode_cache(CUtensorMap* map, const void* base, int B, int K,
                        int KV, int d, const long long* strides, bool f16) {
  if (strides[0] < 0 || strides[1] < 0 || strides[2] < 0)
    return (int)cudaErrorInvalidValue;
  const uint64_t dims[4] = {(uint64_t)d, (uint64_t)KV, (uint64_t)K,
                            (uint64_t)B};
  const uint64_t bytes[3] = {(uint64_t)strides[2] * 2,
                             (uint64_t)strides[1] * 2,
                             (uint64_t)strides[0] * 2};
  const uint32_t box[4] = {64, 1, BK, 1};
  return encode_b16<4>(map, base, dims, bytes, box, f16);
}

template <typename T, int DH>
static cudaError_t set_smem_mma() {
  return cudaFuncSetAttribute(decode_b16_kernel<T, DH>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Cfg<DH>::SMEM);
}

template <typename T, int DH>
static cudaError_t launch_mma(const void* q, const void* k, const void* v,
                              const long long* ks, const long long* vs,
                              int B, int H, int KV, int K, int nsplit,
                              const int* len_dev, int len_host,
                              const int* win_dev, int win_host, float scale,
                              float* part_acc, float* part_ml, void* out,
                              int d, cudaStream_t st) {
  if (d % 8 != 0 || d > DH) return cudaErrorInvalidValue;
  const int g = H / KV;
  int n_sub, gsz;
  sub_groups(g, MMA_G, &n_sub, &gsz);
  const bool half = std::is_same<T, f16>::value;
  CUtensorMap tk, tv;
  int rc = encode_cache(&tk, k, B, K, KV, d, ks, half);
  if (rc == 0) rc = encode_cache(&tv, v, B, K, KV, d, vs, half);
  if (rc != 0) return (cudaError_t)rc;
  cudaError_t err = set_smem_mma<T, DH>();
  if (err != cudaSuccess) return err;
  const dim3 grid(nsplit, KV * n_sub, B);
  decode_b16_kernel<T, DH><<<grid, NT, Cfg<DH>::SMEM, st>>>(
      tk, tv, (const T*)q, H, K, d, g, gsz, n_sub, nsplit, len_dev,
      len_host, win_dev, win_host, (float)(scale * 1.4426950408889634),
      part_acc, part_ml);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T, true><<<B * H, d, 0, st>>>(
      part_acc, part_ml, (T*)out, nsplit, d);
  return cudaGetLastError();
}

// the float32 kernel's register tier for a group of g: its sub-groups'
// size rounded up to 1, 2, 4 or 8
static int f32_tier(int g) {
  int n_sub, gsz;
  sub_groups(g, FMA_G, &n_sub, &gsz);
  return gsz <= 1 ? 1 : gsz <= 2 ? 2 : gsz <= 4 ? 4 : 8;
}

// route codes, as kernels/decode_attention.py passes them
#define ROUTE_FMA 0
#define ROUTE_MMA 1

// CALL(T, DH, G, WIDE, VEC) for the fma route's (dh, DH, g, vec): DH one
// of 8, 16, 32, 64, 128, 256 (dh <= DH), or 256 with dh > 256 (WIDE); G
// the tier of g; VEC where vec allows it and dh is a multiple of the
// lanes' EPL (float32 only: the 16-bit types take this route where their
// rows are not TMA-readable, and read them element by element).
// Evaluates to `return CALL(...)`, or falls through.
#define FMA_DISPATCH(T, CALL)                                               \
  {                                                                         \
    const int tier = f32_tier(g);                                           \
    if (dh > DH) {                                                          \
      if (DH == 256) {                                                      \
        if constexpr (std::is_same<T, float>::value) {                      \
          if (vec && dh % 8 == 0) FMA_TIERS(T, 256, true, true, CALL);      \
        }                                                                   \
        FMA_TIERS(T, 256, true, false, CALL);                               \
      }                                                                     \
    } else {                                                                \
      switch (DH) {                                                         \
        case 8: FMA_VEC(T, 8, CALL);                                        \
        case 16: FMA_VEC(T, 16, CALL);                                      \
        case 32: FMA_VEC(T, 32, CALL);                                      \
        case 64: FMA_VEC(T, 64, CALL);                                      \
        case 128: FMA_VEC(T, 128, CALL);                                    \
        case 256: FMA_VEC(T, 256, CALL);                                    \
      }                                                                     \
    }                                                                       \
  }
#define FMA_VEC(T, D, CALL)                                                 \
  if constexpr (std::is_same<T, float>::value) {                            \
    if (vec && dh % Lanes<D>::EPL == 0) FMA_TIERS(T, D, false, true, CALL); \
  }                                                                         \
  FMA_TIERS(T, D, false, false, CALL)
#define FMA_TIERS(T, D, W, V, CALL)                                         \
  {                                                                         \
    if (tier == 1) CALL(T, D, 1, W, V);                                     \
    if (tier == 2) CALL(T, D, 2, W, V);                                     \
    if (tier == 4) CALL(T, D, 4, W, V);                                     \
    CALL(T, D, 8, W, V);                                                    \
  }

// How many blocks of the kernel a call with head size dh run at width DH,
// group g, dtype dt and route launches fit on one SM at once (the host's
// `resident` is this times the SM count).  0 or a cudaError_t.
extern "C" int decode_attention_blocks_per_sm(int dh, int DH, int g, int dt,
                                              int route, int vec,
                                              int* blocks) {
  *blocks = 0;
  if (g < 1 || dh < 1) return (int)cudaErrorInvalidValue;
  if (route == ROUTE_MMA && (dt == DT_BF16 || dt == DT_F16) && dh <= DH) {
#define DEC_OCC(T, D)                                                       \
  {                                                                         \
    const cudaError_t err = set_smem_mma<T, D>();                           \
    if (err != cudaSuccess) return (int)err;                                \
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(              \
        blocks, decode_b16_kernel<T, D>, NT, Cfg<D>::SMEM);                 \
  }
#define DEC_OCC_T(T)                  \
  switch (DH) {                       \
    case 64: DEC_OCC(T, 64);          \
    case 128: DEC_OCC(T, 128);        \
    case 256: DEC_OCC(T, 256);        \
  }
    if (dt == DT_BF16) DEC_OCC_T(bf16) else DEC_OCC_T(f16)
#undef DEC_OCC_T
#undef DEC_OCC
  } else if (route == ROUTE_FMA) {
#define DEC_OCC(T, D, GG, W, V)                                             \
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(                \
      blocks, decode_partial_kernel<T, D, GG, W, V>, NW * 32, 0)
    if (dt == DT_F32) FMA_DISPATCH(float, DEC_OCC)
    else if (dt == DT_BF16) FMA_DISPATCH(bf16, DEC_OCC)
    else if (dt == DT_F16) FMA_DISPATCH(f16, DEC_OCC)
#undef DEC_OCC
  }
  return (int)cudaErrorInvalidValue;
}

// q (B, H, dh) contiguous; k, v (B, K, KV, dh) with unit stride on dh and
// element strides {kb, kp, kn} / {vb, vp, vn} = {batch, position, head};
// out (B, H, dh).  part_acc: B * H * nsplit * dh floats, part_ml:
// B * H * nsplit * 2.  len_dev / win_dev: device int32 or NULL (then
// len_host / win_host).  Any group H / KV.  Any dh >= 1, run at width DH
// (the caller's padded_head_dim: the route's smallest width >= dh, or 256
// for a wider dh on the fma route).  route: ROUTE_MMA (DT_BF16 or DT_F16;
// dh % 8 == 0, the TMA ring on mma.sync: vec, i.e. 16-byte aligned q and
// caches with byte strides that are multiples of 16) or ROUTE_FMA (any
// dt: scalar FMAs, vector loads where vec allows, else element loads).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, long long kb, long long kp,
    long long kn, long long vb, long long vp, long long vn, int B, int H,
    int KV, int K, int dh, int DH, int nsplit, const int* len_dev,
    int len_host, const int* win_dev, int win_host, float scale,
    float* part_acc, float* part_ml, void* out, int dt, int route, int vec,
    void* stream) {
  // the float32 route's sub-groups are the smaller: its grid is the taller
  if (B < 1 || KV < 1 || H < 1 || K < 1 || nsplit < 1 || H % KV != 0 ||
      dh < 1 || B > 65535 ||
      (long long)KV * ((H / KV + FMA_G - 1) / FMA_G) > 65535)
    return (int)cudaErrorInvalidValue;
  const long long ks[3] = {kb, kp, kn}, vs[3] = {vb, vp, vn};
  cudaStream_t st = (cudaStream_t)stream;
  const int g = H / KV;
#define DEC_ARGS                                                            \
  q, k, v, ks, vs, B, H, KV, K, nsplit, len_dev, len_host, win_dev,         \
      win_host, scale, part_acc, part_ml, out, dh, st
  if (route == ROUTE_MMA && vec) {
#define DEC_MMA(T)                                                          \
  switch (DH) {                                                             \
    case 64: return (int)launch_mma<T, 64>(DEC_ARGS);                       \
    case 128: return (int)launch_mma<T, 128>(DEC_ARGS);                     \
    case 256: return (int)launch_mma<T, 256>(DEC_ARGS);                     \
  }
    if (dt == DT_BF16) DEC_MMA(bf16)
    else if (dt == DT_F16) DEC_MMA(f16)
#undef DEC_MMA
  } else if (route == ROUTE_FMA) {
#define DEC_FMA(T, D, GG, W, V)                                             \
  return (int)launch_fma<T, D, GG, W, V>(DEC_ARGS)
    if (dt == DT_F32) FMA_DISPATCH(float, DEC_FMA)
    else if (dt == DT_BF16) FMA_DISPATCH(bf16, DEC_FMA)
    else if (dt == DT_F16) FMA_DISPATCH(f16, DEC_FMA)
#undef DEC_FMA
  }
#undef DEC_ARGS
  return (int)cudaErrorInvalidValue;
}
