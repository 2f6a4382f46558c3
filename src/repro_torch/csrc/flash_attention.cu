// Flash attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py:102
// (flash_attention / _flash_kernel :26): q, k, v (B, S, H, d), KV already
// repeated to H heads; for each query row, softmax over the keys the mask
// allows, in float32 with running max / sum / accumulator, the kernel's
// finite -1e30 mask and max(l, 1e-30) denominator:
//
//   allowed(qp, kp) = (!causal or kp <= qp) and (window <= 0 or qp - kp < window)
//
// out in q's dtype (round to nearest even for bf16 and fp16).  The inputs
// are read through their strides, so the model layout (B, S, H, d) is
// never transposed.  Any head dim d >= 1 (the reference's kernel makes
// each block the full head dim, so it takes any d): each route is
// instantiated for a few widths DH, and the caller (kernels/backend.py
// padded_head_dim, the one width rule) passes the smallest DH >= d, with
// the columns past d zero in shared memory (loads past d are not issued,
// or are zero-filled), so Q K^T is the sum over d alone; the output
// columns past d are computed as zeros and never stored, and the scale is
// the caller's 1 / sqrt(d) of the true d.  The padded columns cost their
// share of the work (d 80 runs DH 128): a known cost, not optimised.
// Above 256 the caller passes DH 256 and the float32-FMA kernel splits
// the output's d across ceil(d / 256) blocks (WIDE): each computes the
// whole Q K^T over d in 256-wide slices (Q and K slices re-read for each
// key tile) and accumulates P V for its own 256 columns only, so the
// scores are computed ceil(d / 256) times.  Rows that are not 16-byte
// aligned (a 16-bit d that is not a multiple of 8, a float32 d that is
// not a multiple of 4, a view) are read element by element on the same
// kernel.  Key tiles that the causal or window mask covers wholly are
// not visited, as _flash_kernel skips them (:41-47).
//
// What bounds it: operations.  At llama3.2-3b's prefill (B 2, S 4,096,
// H 24, d 128, causal) the unmasked half of Q K^T and P V is 2.06e11
// flops against 0.2 GB moved: 0.208 ms at 989 TFLOP/s (bf16).  So the
// products belong on the tensor cores, and the softmax between them must
// not go through shared memory.
//
// bf16 and fp16 (16-byte aligned rows, d a multiple of 8 up to 256):
// FlashAttention-2's layout on mma.sync, the same kernel on either
// 16-bit type (m16n8k16 takes both).  One block of four warps
// per (64-row query tile, head, sequence), heaviest causal tiles first;
// each warp owns 16 query rows and walks the key tiles (64 keys for
// d <= 128, 32 for d = 256).
//  - K and V tiles arrive by cp.async (16 bytes a thread, zero-filled past
//    S) into a two-stage ring, so the next tile is in flight while this
//    one computes.  Rows are padded by 8 bf16 so that ldmatrix is free of
//    bank conflicts.  The query tile stays in shared memory and is re-read
//    by ldmatrix at each k-step, which leaves the registers to d = 256's
//    16 x 256 float32 accumulator (128 a thread).
//  - S = Q K^T on mma.sync m16n8k16 (bf16 or fp16 in, float32
//    accumulate; each product of two is exact in float32, as the Pallas
//    kernel's widening).  The scores are scaled by scale * log2(e) in float32 after
//    the product (bf16 q cannot be pre-scaled exactly) and the softmax runs
//    in base 2.  Only warps whose tile crosses the diagonal, the window
//    edge or S test the mask element by element; masked weights are forced
//    to 0 (a row masked so far has m = -1e30 and would give exp(0) = 1).
//  - The online softmax stays in registers: a thread holds rows g and
//    g + 8 of each C fragment, the row max takes two shuffles inside the
//    quad, and l sums the float32 P before it is split.
//  - O += P V with P in registers: two adjacent n8 C fragments of S are
//    one k16 A fragment of P.  P is fed as two 16-bit terms, P_hi = T(P)
//    and P_lo = T(P - P_hi), one mma each against V's B fragment
//    (ldmatrix.trans).  The plain version and the Pallas kernel form P V in
//    float32; emulated on the CPU (seed 15, random normal bf16 q, k, v),
//    a single bf16 P changes ~40% of the bf16 outputs and puts thousands
//    beyond one rounding step (llama shape: 41%, 2,380; gemma3-4b window:
//    40%, 5,050; S 1,000 window 100: 38%, 16,734), fp16 still 10%; the two
//    terms change 0.21-0.25% and none beyond the step.  The second term
//    costs half again the tensor-core work (3.1e11 flops at llama's shape).
//  - The epilogue divides by max(l, 1e-30), rounds to bf16 and stages the
//    warp's 16 rows through its own rows of the query tile for 16-byte
//    stores.
//
// float32, and the 16-bit inputs that the mma kernel does not take
// (unaligned rows, d above 256): scalar IEEE float32 FMAs on the values
// widened to float32, as the Pallas kernel computes.  Its tolerance (the
// reference's rtol = atol = 2e-5) rules out both bf16 and TF32 products.
// One block of 256 threads per (64-row query tile, head, sequence, and
// column block when WIDE); Q (pre-scaled),
// K and V tiles widened to float32 in shared memory; per key tile
// S = Q K^T with 4 x 4 scores a thread, the online softmax with four
// threads a row, then acc += P V with 4 rows x d/16 columns a thread.
// Below d 16 (the reduced configs' d 8) sixteen threads of a row group
// cannot each own a column: 16 / d threads share one, each summing every
// (16 / d)-th key of the tile into its own accumulator (all rescaled by
// the same alpha), and the epilogue adds the slices with __shfl_xor_sync
// inside the warp before one of them stores the row.  Widths DH 8, 16,
// 32, 64, 128 and 256.  The 16-bit kernel's k16 fragments and its tiling
// need DH >= 32, so there d 8-24 run at DH 32.
//
// Next (a later B6 step): wgmma on a warpgroup with K and V brought by
// TMA into an mbarrier ring, P fed to wgmma from registers, a producer
// warp and persistent blocks, to close the gap to the tensor cores' rate.

#include "common.cuh"

#define BQ 64
#define NT 256

// {batch, seq, head} element strides of q, k, v and o, in that order
struct Strides {
  long long v[12];
};

template <int DH, int BKT>
struct Smem {
  float q[BQ][DH + 1];  // +1: conflict-free column reads in Q K^T
  float k[BKT][DH + 1];
  float v[BKT][DH];
  float s[BQ][BKT + 1];
  float m[BQ], l[BQ], a[BQ];
};

__device__ __forceinline__ bool allowed(int qp, int kp, int S, int causal,
                                        int window) {
  return qp < S && kp < S && (!causal || kp <= qp) &&
         (window <= 0 || qp - kp < window);
}

// rows [r0, r0 + R) of a (B, S, H, d) tensor at (b, h) into dst[R][P],
// widened to float and multiplied by mul; rows past S and columns past d
// are zeros.  VEC: four elements a load (d a multiple of 4, rows 16-byte
// aligned); else one element a load.
template <typename T, int DH, int R, int P, bool VEC>
__device__ __forceinline__ void load_tile(float (*dst)[P], const T* src,
                                          long long ss, int r0, int S, int d,
                                          float mul) {
  for (int idx = threadIdx.x; idx < R * DH / 4; idx += NT) {
    const int r = idx / (DH / 4), c = (idx % (DH / 4)) * 4;
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (VEC) {
      if (r0 + r < S && c < d)
        load_f<4>(src + (long long)(r0 + r) * ss + c, t);
    } else if (r0 + r < S) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (c + i < d) t[i] = to_f(src[(long long)(r0 + r) * ss + c + i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[r][c + i] = t[i] * mul;
  }
}

// s[i][j] += sum over the DH columns of q[ty + 16 i][c] k[tx + 16 j][c]
template <int DH, int KJ>
__device__ __forceinline__ void qk_tile(float (*q)[DH + 1],
                                        float (*k)[DH + 1], int ty, int tx,
                                        float (&s)[4][KJ]) {
#pragma unroll 8
  for (int c = 0; c < DH; ++c) {
    float a[4], kk[KJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = q[ty + 16 * i][c];
#pragma unroll
    for (int j = 0; j < KJ; ++j) kk[j] = k[tx + 16 * j][c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
  }
}

// WIDE (d > DH): block (., h ncb + cb, .) computes output columns
// [cb DH, cb DH + DH) of head h, ncb = ceil(d / DH).  VEC: q, k, v read
// four elements a load (load_tile).
template <typename T, int DH, int BKT, bool WIDE, bool VEC>
__global__ void __launch_bounds__(NT)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, const Strides st,
             int S, int d, int causal, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<DH, BKT>& sm = *reinterpret_cast<Smem<DH, BKT>*>(smem_raw);
  // heaviest causal tiles first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int ncb = WIDE ? (d + DH - 1) / DH : 1;
  const int h = WIDE ? blockIdx.y / ncb : blockIdx.y, b = blockIdx.z;
  const int c0 = WIDE ? (blockIdx.y % ncb) * DH : 0;  // output columns
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* qp = q + b * st.v[0] + h * st.v[2];
  const T* kp = k + b * st.v[3] + h * st.v[5];
  const T* vp = v + b * st.v[6] + h * st.v[8] + c0;
  T* op = o + b * st.v[9] + h * st.v[11] + c0;

  if constexpr (!WIDE)
    load_tile<T, DH, BQ, DH + 1, VEC>(sm.q, qp, st.v[1], q0, S, d, scale);
  if (tid < BQ) {
    sm.m[tid] = NEG_INF;
    sm.l[tid] = 0.f;
  }
  // accumulator columns a thread, and key slices a column (d < 16)
  constexpr int CW = DH >= 16 ? DH / 16 : 1;
  constexpr int KS = DH >= 16 ? 1 : 16 / DH;
  const int col = DH >= 16 ? tx : tx % DH;  // column of acc[.][0]
  const int slice = DH >= 16 ? 0 : tx / DH;
  float acc[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CW; ++j) acc[i][j] = 0.f;

  // the key tiles that hold at least one allowed key for this query tile
  const int q_last = min(q0 + BQ, S) - 1;
  const int k_end = causal ? q_last + 1 : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = (k_begin / BKT) * BKT; k0 < k_end; k0 += BKT) {
    __syncthreads();  // the previous tile's K, V, P are consumed
    // S = Q K^T: rows ty + 16 i, keys tx + 16 j
    constexpr int KJ = BKT / 16;
    float s[4][KJ];
    if constexpr (WIDE) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
      // over all of d, a DH-wide slice of Q and K at a time
      for (int d0 = 0; d0 < d; d0 += DH) {
        if (d0 > 0) __syncthreads();  // the previous slice is consumed
        load_tile<T, DH, BQ, DH + 1, VEC>(sm.q, qp + d0, st.v[1], q0, S,
                                          d - d0, scale);
        load_tile<T, DH, BKT, DH + 1, VEC>(sm.k, kp + d0, st.v[4], k0, S,
                                           d - d0, 1.f);
        __syncthreads();
        qk_tile<DH, KJ>(sm.q, sm.k, ty, tx, s);
      }
      load_tile<T, DH, BKT, DH, VEC>(sm.v, vp, st.v[7], k0, S, d - c0, 1.f);
    } else {
      load_tile<T, DH, BKT, DH + 1, VEC>(sm.k, kp, st.v[4], k0, S, d, 1.f);
      load_tile<T, DH, BKT, DH, VEC>(sm.v, vp, st.v[7], k0, S, d, 1.f);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
      qk_tile<DH, KJ>(sm.q, sm.k, ty, tx, s);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        sm.s[r][c] = allowed(q0 + r, k0 + c, S, causal, window) ? s[i][j]
                                                                 : NEG_INF;
      }
    __syncthreads();

    // online softmax: row tid / 4, keys (tid % 4) + 4 t
    {
      const int r = tid / 4, part = tid % 4;
      const float m_prev = sm.m[r];
      float mt = NEG_INF;
      for (int c = part; c < BKT; c += 4) mt = fmaxf(mt, sm.s[r][c]);
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m_prev, mt);
      float sum = 0.f;
      for (int c = part; c < BKT; c += 4) {
        const float p = allowed(q0 + r, k0 + c, S, causal, window)
                            ? expf(sm.s[r][c] - m_new)
                            : 0.f;
        sm.s[r][c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        sm.a[r] = alpha;
        sm.l[r] = sm.l[r] * alpha + sum;
        sm.m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: rows ty + 16 i, columns col + 16 j, keys
    // slice + KS t
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = sm.a[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < CW; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int c = slice; c < BKT; c += KS) {
      float p[4], vv[CW];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sm.s[ty + 16 * i][c];
#pragma unroll
      for (int j = 0; j < CW; ++j) vv[j] = sm.v[c][col + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CW; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();
  // the key slices of a column sit on lanes col + d s of one half-warp
  if constexpr (KS > 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int off = DH; off < 16; off <<= 1)
        acc[i][0] += __shfl_xor_sync(0xffffffffu, acc[i][0], off);
  }
  if (slice != 0) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= S) continue;
    const float denom = fmaxf(sm.l[r], 1e-30f);
    T* orow = op + (long long)(q0 + r) * st.v[10];
#pragma unroll
    for (int j = 0; j < CW; ++j)
      if (col + 16 * j < d - c0)
        orow[col + 16 * j] = from_f<T>(acc[i][j] / denom);
  }
}

// ---------------------------------------------------------------------------
// bf16 and fp16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int TW = 4;        // warps a block, 16 query rows each
constexpr int TQ = 16 * TW;  // query rows a block
constexpr int TB = 32 * TW;  // threads a block

template <typename T, int DH, int BKT>
struct SmemT {
  static constexpr int P = DH + 8;  // row pitch: +16 bytes, so the eight
                                    // rows of an ldmatrix hit distinct banks
  T q[TQ][P];
  T k[2][BKT][P];
  T v[2][BKT][P];
};

// rows [r0, r0 + R) of a (B, S, H, d) 16-bit tensor at (b, h) into
// dst[R][P] by cp.async (not yet committed); rows past S and 16-byte
// chunks past d (a multiple of 8, at most DH) are zero-filled
template <typename T, int DH, int R, int P>
__device__ __forceinline__ void copy_tile(T (*dst)[P], const T* src,
                                          long long ss, int r0, int S,
                                          int d) {
  constexpr int CH = DH / 8;  // 16-byte chunks a row
  static_assert(R * CH % TB == 0, "tile must split evenly over the block");
#pragma unroll
  for (int i = 0; i < R * CH / TB; ++i) {
    const int idx = threadIdx.x + i * TB;
    const int r = idx / CH, c = (idx % CH) * 8;
    const bool in = r0 + r < S && c < d;
    cp_async_16(&dst[r][c], in ? src + (long long)(r0 + r) * ss + c : src,
                in);
  }
}

template <typename T, int DH, int BKT>
__global__ void __launch_bounds__(TB)
flash_b16_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 const Strides st, int S, int d, int causal, int window,
                 float scale_log2) {
  using Sm = SmemT<T, DH, BKT>;
  constexpr int P = Sm::P;
  constexpr int NS = BKT / 8;  // n8 fragments of S a warp
  constexpr int NO = DH / 8;   // n8 fragments of O a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw);
  // heaviest causal tiles first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int grp = lane / 4, tig = lane % 4;
  const T* qp = q + b * st.v[0] + h * st.v[2];
  const T* kp = k + b * st.v[3] + h * st.v[5];
  const T* vp = v + b * st.v[6] + h * st.v[8];
  T* op = o + b * st.v[9] + h * st.v[11];

  // the key tiles that hold at least one allowed key for this query tile
  const int q_last = min(q0 + TQ, S) - 1;
  const int k_end = causal ? q_last + 1 : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt0 = (k_begin / BKT) * BKT;
  const int n_tiles = (k_end - kt0 + BKT - 1) / BKT;

  copy_tile<T, DH, TQ, P>(sm.q, qp, st.v[1], q0, S, d);
  copy_tile<T, DH, BKT, P>(sm.k[0], kp, st.v[4], kt0, S, d);
  copy_tile<T, DH, BKT, P>(sm.v[0], vp, st.v[7], kt0, S, d);
  cp_async_commit();

  // this warp's rows: wq0 .. wq0 + 15; this thread's rows r_lo, r_lo + 8
  const int wq0 = q0 + warp * 16;
  const int r_lo = wq0 + grp, r_hi = r_lo + 8;
  // ldmatrix row addresses: Q's A fragment (rows lane % 16, column block
  // lane / 16), K's B fragments (keys lane % 8 + 8 (lane / 16), column
  // block (lane / 8) % 2), V's transposed B fragments (keys lane % 16,
  // column block lane / 16)
  const T* q_frag = &sm.q[warp * 16 + lane % 16][(lane / 16) * 8];
  const int k_row = lane % 8 + (lane / 16) * 8, k_col = ((lane / 8) % 2) * 8;
  const int v_row = lane % 16, v_col = (lane / 16) * 8;

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // running max (base-2 units) and this thread's share of the row sums
  float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = kt0 + t * BKT, stage = t & 1;
    if (t + 1 < n_tiles) {
      copy_tile<T, DH, BKT, P>(sm.k[stage ^ 1], kp, st.v[4], k0 + BKT, S,
                               d);
      copy_tile<T, DH, BKT, P>(sm.v[stage ^ 1], vp, st.v[7], k0 + BKT, S,
                               d);
    }
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: tile t has landed
    __syncthreads();

    // a tile that masks all of this warp's rows changes nothing (p = 0,
    // alpha = 1); one that masks some is tested element by element
    const bool none = wq0 >= S || (causal && k0 > wq0 + 15) ||
                      (window > 0 && wq0 - (k0 + BKT - 1) >= window);
    const bool edge = k0 + BKT > S || wq0 + 16 > S ||
                      (causal && k0 + BKT - 1 > wq0) ||
                      (window > 0 && wq0 + 15 - k0 >= window);
    if (!none) {
      // S = Q K^T
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, q_frag + kk * 16);
#pragma unroll
        for (int jj = 0; jj < NS / 2; ++jj) {
          uint32_t bb[4];
          ldmatrix_x4(bb, &sm.k[stage][jj * 16 + k_row][kk * 16 + k_col]);
          mma16<T>(s[2 * jj], a, bb);
          mma16<T>(s[2 * jj + 1], a, bb + 2);
        }
      }

      // scores in base-2 units; masked ones at -1e30, their weights 0
      uint32_t masked = 0;  // bit 4 j + e: s[j][e] is masked
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] *= scale_log2;
          if (edge && !allowed(e < 2 ? r_lo : r_hi,
                               k0 + j * 8 + tig * 2 + (e & 1), S, causal,
                               window)) {
            s[j][e] = NEG_INF;
            masked |= 1u << (4 * j + e);
          }
        }
      float mx_lo = NEG_INF, mx_hi = NEG_INF;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
      }
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
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = (masked >> (4 * j + e)) & 1u
                              ? 0.f
                              : exp2f(s[j][e] - (e < 2 ? mn_lo : mn_hi));
          s[j][e] = p;
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

      // O += P V, P as 16-bit P_hi + P_lo straight from the S fragments
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        // A fragment: rows g (keys 2t, 2t + 1, then 2t + 8, 2t + 9) from
        // s[2 kk][0..1] and s[2 kk + 1][0..1], rows g + 8 from [2..3]
        const float x[8] = {s[2 * kk][0],     s[2 * kk][1],
                            s[2 * kk][2],     s[2 * kk][3],
                            s[2 * kk + 1][0], s[2 * kk + 1][1],
                            s[2 * kk + 1][2], s[2 * kk + 1][3]};
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pack2_hi_lo<T>(x[2 * i], x[2 * i + 1], hi[i], lo[i]);
#pragma unroll
        for (int dj = 0; dj < NO / 2; ++dj) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb,
                            &sm.v[stage][kk * 16 + v_row][dj * 16 + v_col]);
          mma16<T>(acc[2 * dj], hi, bb);
          mma16<T>(acc[2 * dj], lo, bb);
          mma16<T>(acc[2 * dj + 1], hi, bb + 2);
          mma16<T>(acc[2 * dj + 1], lo, bb + 2);
        }
      }
    }
    __syncthreads();  // the ring stage is consumed before it is refilled
  }
  cp_async_wait<0>();

  // out = acc / max(l, 1e-30), staged through this warp's own Q rows
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float d_lo = fmaxf(l_lo, 1e-30f), d_hi = fmaxf(l_hi, 1e-30f);
  T (*stage_o)[P] = sm.q + warp * 16;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int c = j * 8 + tig * 2;
    *reinterpret_cast<uint32_t*>(&stage_o[grp][c]) =
        pack2<T>(acc[j][0] / d_lo, acc[j][1] / d_lo);
    *reinterpret_cast<uint32_t*>(&stage_o[grp + 8][c]) =
        pack2<T>(acc[j][2] / d_hi, acc[j][3] / d_hi);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * (DH / 8) / 32; ++i) {
    const int idx = lane + 32 * i;
    const int r = idx / (DH / 8), c = (idx % (DH / 8)) * 8;
    if (wq0 + r < S && c < d)
      *reinterpret_cast<uint4*>(op + (long long)(wq0 + r) * st.v[10] + c) =
          *reinterpret_cast<const uint4*>(&stage_o[r][c]);
  }
}

template <typename T, int DH, int BKT>
static cudaError_t launch_b16(const void* q, const void* k, const void* v,
                              void* o, const Strides& strides, int B, int S,
                              int H, int d, int causal, int window,
                              float scale, cudaStream_t st) {
  const size_t bytes = sizeof(SmemT<T, DH, BKT>);
  cudaError_t err = cudaFuncSetAttribute(
      flash_b16_kernel<T, DH, BKT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + TQ - 1) / TQ, H, B);
  flash_b16_kernel<T, DH, BKT><<<grid, TB, bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, strides, S, d, causal,
      window, (float)(scale * 1.4426950408889634));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, int DH, int BKT, bool WIDE, bool VEC>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          void* o, const Strides& strides, int B, int S,
                          int H, int d, int causal, int window, float scale,
                          cudaStream_t st) {
  const size_t bytes = sizeof(Smem<DH, BKT>);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DH, BKT, WIDE, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const long long ncb = (d + DH - 1) / DH;
  if ((long long)H * ncb > 65535) return cudaErrorInvalidValue;
  const dim3 grid((S + BQ - 1) / BQ, (unsigned)(H * ncb), B);
  flash_kernel<T, DH, BKT, WIDE, VEC><<<grid, NT, bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, strides, S, d, causal,
      window, scale);
  return cudaGetLastError();
}

// the FMA kernel on storage type T at width DH (d > DH: the WIDE split,
// DH 256 only), reading four elements a load where VEC
template <typename T, bool VEC>
static cudaError_t launch_fma(const void* q, const void* k, const void* v,
                              void* o, const Strides& sv, int B, int S,
                              int H, int d, int DH, int causal, int window,
                              float scale, cudaStream_t st) {
#define FA_CASE(D, BKT)                                                     \
  return launch<T, D, BKT, false, VEC>(q, k, v, o, sv, B, S, H, d, causal,   \
                                       window, scale, st)
  if (d > DH) {
    if (DH != 256) return cudaErrorInvalidValue;
    return launch<T, 256, 32, true, VEC>(q, k, v, o, sv, B, S, H, d, causal,
                                         window, scale, st);
  }
  switch (DH) {
    case 8: FA_CASE(8, 64);
    case 16: FA_CASE(16, 64);
    case 32: FA_CASE(32, 64);
    case 64: FA_CASE(64, 64);
    case 128: FA_CASE(128, 64);
    case 256: FA_CASE(256, 32);
  }
#undef FA_CASE
  return cudaErrorInvalidValue;
}

// the mma.sync kernel on 16-bit type T at width DH (d <= DH)
template <typename T>
static cudaError_t launch_mma(const void* q, const void* k, const void* v,
                              void* o, const Strides& sv, int B, int S,
                              int H, int d, int DH, int causal, int window,
                              float scale, cudaStream_t st) {
#define FA_B16(D, BKT)                                                      \
  return launch_b16<T, D, BKT>(q, k, v, o, sv, B, S, H, d, causal, window,   \
                               scale, st)
  if (d > DH || d % 8 != 0) return cudaErrorInvalidValue;
  switch (DH) {
    case 32: FA_B16(32, 64);
    case 64: FA_B16(64, 64);
    case 128: FA_B16(128, 64);
    case 256: FA_B16(256, 32);
  }
#undef FA_B16
  return cudaErrorInvalidValue;
}

// route codes, as kernels/flash_attention.py passes them
#define ROUTE_FMA 0
#define ROUTE_MMA 1

// q, k, v, o: (B, S, H, dh) with unit stride on dh; strides: a host
// array of 12 int64, the {batch, seq, head} element strides of q, k, v and
// o in that order.  Any dh >= 1.  DH: the width the call runs at, from
// the caller's one rule (kernels/backend.py padded_head_dim): the
// smallest instantiated width >= dh (ROUTE_FMA 8, 16, 32, 64, 128, 256;
// ROUTE_MMA 32, 64, 128, 256), or 256 for a wider dh (ROUTE_FMA only).
// dt: DT_F32 (ROUTE_FMA only), DT_BF16 or DT_F16.  vec: every row of q,
// k, v and o is 16-byte aligned (ROUTE_MMA needs it; ROUTE_FMA reads
// float32 four elements a load with it where dh % 4 == 0, and the 16-bit
// types, which take it only where the mma kernel cannot, element by
// element).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const long long* strides, int B, int S,
                                      int H, int dh, int DH, int causal,
                                      int window, float scale, int dt,
                                      int route, int vec, void* stream) {
  if (B < 1 || S < 1 || H < 1 || B > 65535 || H > 65535 || dh < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Strides sv;
  for (int i = 0; i < 12; ++i) sv.v[i] = strides[i];
  if (route == ROUTE_FMA) {
    if (dt == DT_F32 && vec && dh % 4 == 0)
      return (int)launch_fma<float, true>(q, k, v, o, sv, B, S, H, dh, DH,
                                          causal, window, scale, st);
    if (dt == DT_F32)
      return (int)launch_fma<float, false>(q, k, v, o, sv, B, S, H, dh, DH,
                                           causal, window, scale, st);
    if (dt == DT_BF16)
      return (int)launch_fma<bf16, false>(q, k, v, o, sv, B, S, H, dh, DH,
                                          causal, window, scale, st);
    if (dt == DT_F16)
      return (int)launch_fma<f16, false>(q, k, v, o, sv, B, S, H, dh, DH,
                                         causal, window, scale, st);
  } else if (route == ROUTE_MMA && vec) {
    if (dt == DT_BF16)
      return (int)launch_mma<bf16>(q, k, v, o, sv, B, S, H, dh, DH, causal,
                                   window, scale, st);
    if (dt == DT_F16)
      return (int)launch_mma<f16>(q, k, v, o, sv, B, S, H, dh, DH, causal,
                                  window, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}
