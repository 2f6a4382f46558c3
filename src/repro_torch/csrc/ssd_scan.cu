// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan.py:81 (ssd_scan /
// _ssd_kernel :26).  For each sequence b, head h and chunk of c positions,
// with xw = dt * x and cs = cumsum(dt * a) over the chunk:
//
//   y     = (C B^T ⊙ tril(exp(cs_i - cs_j))) xw + (C state^T) ⊙ exp(cs)
//   state = state * exp(cs_last) + xw^T (B ⊙ exp(cs_last - cs))
//
// all float32-accurate from float32, bf16 or fp16 inputs; y is stored in
// x's dtype, the final state in float32.  b and c carry G groups; head h
// reads group h / (H / G), so the GQA expansion is an index, not a copy.
//
// Domain: any P, N and chunk dividing S, as the Pallas kernel takes them.
// The tiles hold P <= 64 columns of x, y and the state and N <= 128 of
// B, C and the state; a wider P runs ceil(P / 64) blocks of 64 columns
// per (chunk, head) in the chunk and carry kernels (given C B^T, y's and
// the state's columns are independent; cs is recomputed per block), and a
// wider N accumulates C B^T, the carry-in C state^T and the state update
// over 128-wide slices.  The chunk-long arrays (cs, dt, the decay) sit in
// shared memory while they fit there (chunk to 10,240 beside the tiles),
// else in a global scratch buffer, one slice a block.
//
// What bounds it: operations.  Per (b, chunk) at mamba2-780m's c 256,
// P 64, N 128 the causal half of C B^T is 8.42 MFLOP for each group (the
// heads of a group share it), and per head the product with xw is 4.21
// M, the carry-in C state^T 4.19 M and the state update 4.19 M: 19.2
// GFLOP a call at B 2, S 4,096, H 48, G 1.  Every product runs on the
// tensor cores in split TF32 (below): three TF32 products for each
// float32 one, 57.7 GFLOP, 0.117 ms at 494.5 TFLOP/s of dense TF32,
// against 215 MB (0.064 ms at 3.35 TB/s) of inputs and outputs.
//
// Design.  The TPU runs the chunk axis in sequence and carries the (P, N)
// state in VMEM.  Here a CUDA grid dimension never carries state; the
// chunks run in parallel and the recurrence between them is a separate,
// cheap pass.  Four launches a call:
//  1. ssd_cb_kernel, one block per (causal 64 x 64 tile pair, chunk,
//     group, sequence): the tile of C B^T over N, once per group rather
//     than once per head, into a float32 scratch buffer (B, nc, G, tile
//     pairs, 64 x 64), which the heads' blocks then read from L2 (8.4 MB
//     at mamba2-780m's prefill; L2 is 50 MB).  Each tile is stored in the
//     order of the A fragment that reads it (below), one float4 a lane.
//  2. ssd_chunk_kernel, one block per (chunk, head, sequence): cs by a
//     warp scan; the intra-chunk y over 128-row query bands (each of the
//     eight warps 16 rows of one 64-row tile, all of P) against 64-row
//     key tiles j <= i: the C B^T tile times the head's own decay, masked
//     before exp on the diagonal tile (cs_i - cs_j > 0 above it, and exp
//     could reach inf, inf * 0 being NaN), times xw, with y's running
//     sums in shared memory; then, in a pass of its own over the key
//     tiles, the chunk's own state, xw^T (B ⊙ exp(cs_last - cs)).  y goes
//     to a float32 buffer, the chunk state to a (B, nc, H, P, N) buffer,
//     cs to a (B, H, S) buffer.
//  3. ssd_state_kernel, one thread per (sequence, head, p, n): the scan
//     over chunks, carry = carry * exp(cs_last) + chunk state, in place:
//     each chunk's slot is overwritten by the state entering it; the
//     final carry is the output state.
//  4. ssd_carry_kernel, one block per (chunk, head, sequence): y += (C
//     state_in^T) ⊙ exp(cs), and y stored in x's dtype (chunk 0 enters
//     with a zero state and is only stored).
// cs is summed and differenced in float64 (c adds a chunk): exp(cs_i -
// cs_j) from float32 cumsums loses |cs| * 2^-24 in the exponent, which at
// a strong decay (|cs| in the thousands) is an error of 1e-3 or more in
// y, as the Pallas kernel and the plain version have it; the differences
// are then rounded once to float32 for exp.
//
// Products: mma.sync m16n8k8 in TF32 with float32 accumulators.  One
// TF32 product keeps 11 bits of each factor, far too few for phase 6's
// float64 check, so every float32 operand v goes in as hi = tf32(v) and
// lo = tf32(v - hi), and a product as lo*hi + hi*lo, then hi*hi
// (common.cuh mma_tf32x3).  A bf16 or fp16 input is exact in TF32 (11
// significant bits and an 8-bit exponent hold fp16's 11 and 5, subnormals
// included; lo = 0): for 16-bit b and c, C B^T takes one product.  xw, the masked scores, B ⊙
// decay and the state are float32 whatever the inputs, so they always
// carry their lo.  Every long sum (over N for C B^T and the carry-in,
// over the chunk's positions for y and the state) accumulates KS k-steps
// of 8 (32 terms) into a fresh fragment and then adds it into its
// running fragment, which about halves the rounding error of one
// running sum where the decay is weak and the state grows over the whole
// sequence.
//
// Fragment layouts.  In m16n8k8 TF32 thread (g = lane / 4, t = lane % 4)
// holds A at columns t and t + 4 but the accumulator at columns 2t and
// 2t + 1, so a product's output cannot be the next one's A as it is.
// The product with xw and the state update therefore permute k: A's
// k-slot t carries position 2t of the 8-step and slot t + 4 position
// 2t + 1, and B's rows 2t and 2t + 1 are loaded to match (a sum does not
// care about k's order).  ssd_cb_kernel stores its accumulator (c0, c2,
// c1, c3) as one float4 a lane, which is just that permuted A fragment,
// so the chunk kernel reads its scores with one coalesced 16-byte load.
// C B^T and the carry-in keep k in order.  Shared tiles: C, B and the
// state as [row][n] at a pitch of 132 floats (4 mod 32: rows g, columns
// t hit 32 banks; rows 2t, 2t + 1, columns g too); xw as [j][p] at 68
// (2 * 68 = 8 mod 32: rows 2t, 2t + 1, columns g), pre-split into hi and
// lo planes since all eight warps read all of it.  No bank conflicts on
// any fragment load.  ssd_chunk_kernel is held to 80 registers a thread
// and 72.7 KB of shared memory at c 256, so that three blocks (24 warps)
// share an SM: its phases wait on loads, and at two blocks an SM (y's
// sums in registers) it ran slower.  Tiles are read from global memory four columns a
// load with several loads in flight (batched): a load at a time, or an
// index divided by a runtime width, left these kernels waiting or issuing
// more than computing.

#include <type_traits>

#include "common.cuh"

#define TILE 64
#define PK 132           // pitch of a [row][n] tile (C, B, state)
#define PX 68            // pitch of a [j][p] tile (xw)
#define THREADS 256      // eight warps
#define MAX_P 64         // columns of x, y and the state a block holds
#define MAX_N 128        // columns of B, C and the state a slice holds
#define SMEM_OPTIN 232448
#define KS 4             // k-steps of 8 per partial sum: 32 terms

struct Strides {         // element strides of (batch, seq, head-or-group)
  long long b, s, h;
};

template <typename T>
__device__ __forceinline__ float ld(const T* p) { return to_f(*p); }

template <int R, int Q>
__device__ __forceinline__ void zero(float (&t)[R][Q]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int q = 0; q < Q; ++q) t[r][q] = 0.f;
}

template <int R, int Q>
__device__ __forceinline__ void add_into(float (&acc)[R][Q],
                                         const float (&t)[R][Q]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[r][q] += t[r][q];
}

// v as TF32 terms; a value exact in TF32 (from bf16) has no lo
template <bool EXACT>
__device__ __forceinline__ void to_tf32(float v, uint32_t& hi,
                                        uint32_t& lo) {
  if constexpr (EXACT) {
    hi = __float_as_uint(v);
    lo = 0u;
  } else {
    split_tf32(v, hi, lo);
  }
}

// store(idx, load(idx)) for idx < total, the block's threads striding
// over idx with U loads in flight each: the tiles come from L2 or device
// memory, and one load at a time would leave a thread waiting out every
// load's latency in turn
template <int U, typename V, typename Load, typename Store>
__device__ __forceinline__ void batched(int total, Load load, Store store) {
  for (int base = threadIdx.x; base < total; base += U * THREADS) {
    V v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * THREADS;
      if (idx < total) v[u] = load(idx);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * THREADS;
      if (idx < total) store(idx, v[u]);
    }
  }
}

// four consecutive elements as floats, zero where `ok` is false; p must
// be aligned to four elements when `vec`, else elements are read one by
// one and those at or past `n` are zero
template <typename T>
__device__ __forceinline__ float4 ld4(const T* p, bool ok, bool vec, int n) {
  float o[4] = {0.f, 0.f, 0.f, 0.f};
  if (ok) {
    if (vec) {
      load_f<4>(p, o);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (e < n) o[e] = ld(p + e);
    }
  }
  return make_float4(o[0], o[1], o[2], o[3]);
}

// whether rows of 4-element runs from src (rows row_stride apart, K
// columns) may be read as aligned vectors
template <typename T>
__device__ __forceinline__ bool vec_ok(const T* src, long long row_stride,
                                       int K) {
  return K % 4 == 0 && row_stride % 4 == 0 &&
         reinterpret_cast<uintptr_t>(src) % (4 * sizeof(T)) == 0;
}

// dst[r * PK + k] = src row (r0 + r), column k (times rs[r] when rs is
// given), for r < 64 and k < K8 (K rounded up to 8); zero for rows at or
// past `rows` and columns at or past K.  src rows are `row_stride` apart.
// Four columns a load, U loads in flight: idx runs over (row, 4-column
// run) pairs, 32 runs a row (K8 <= 128), so no index needs a division.
template <int U, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long row_stride, int r0,
                                          int rows, int K, int K8,
                                          const float* rs) {
  const bool vec = vec_ok(src, row_stride, K);
  batched<U, float4>(
      TILE * 32,
      [&](int idx) {
        const int r = idx >> 5, k = 4 * (idx & 31);
        return ld4(src + (r0 + r) * row_stride + k, r0 + r < rows && k < K,
                   vec, K - k);
      },
      [&](int idx, float4 v) {
        const int r = idx >> 5, k = 4 * (idx & 31);
        if (k >= K8) return;
        if (rs != nullptr) {
          const float w = rs[r];
          v = make_float4(v.x * w, v.y * w, v.z * w, v.w * w);
        }
        *reinterpret_cast<float4*>(dst + r * PK + k) = v;
      });
}

// xh/xl[j * PX + p] = the TF32 terms of dt[j0 + j] * x[j0 + j][p] (xw),
// zero past the chunk or P; four p a load
template <typename T>
__device__ __forceinline__ void load_xw(uint32_t* xh, uint32_t* xl,
                                        const T* xb, long long row_stride,
                                        const float* dts, int j0, int chunk,
                                        int P) {
  const bool vec = vec_ok(xb, row_stride, P);
  batched<1, float4>(
      TILE * 16,
      [&](int idx) {
        const int j = idx >> 4, p = 4 * (idx & 15);
        return ld4(xb + (j0 + j) * row_stride + p, j0 + j < chunk && p < P,
                   vec, P - p);
      },
      [&](int idx, float4 v) {
        const int j = idx >> 4, p = 4 * (idx & 15);
        const float d = dts[j0 + j];
        uint4 h, l;
        split_tf32(v.x * d, h.x, l.x);
        split_tf32(v.y * d, h.y, l.y);
        split_tf32(v.z * d, h.z, l.z);
        split_tf32(v.w * d, h.w, l.w);
        *reinterpret_cast<uint4*>(xh + j * PX + p) = h;
        *reinterpret_cast<uint4*>(xl + j * PX + p) = l;
      });
}

// acc[q] += sum over k < K8 of A[r][k] Bm[c][k] for the warp's rows
// r = m0 + g, m0 + g + 8 and columns c = c0 + 8q + 2t, + 1 (q < 4;
// column blocks at or past ncols are skipped), A and Bm [row][k] tiles
// at pitch PK, in partial sums of KS k-steps
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void nt_product(const float* As, const float* Bs,
                                           int m0, int c0, int ncols, int K8,
                                           float (&acc)[4][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* a0 = As + (m0 + g) * PK + t;
  const float* a1 = a0 + 8 * PK;
  for (int kp = 0; kp < K8; kp += 8 * KS) {
    float part[4][4];
    zero(part);
    for (int k = kp; k < min(kp + 8 * KS, K8); k += 8) {
      uint32_t ah[4], al[4];
      to_tf32<A_EXACT>(a0[k], ah[0], al[0]);
      to_tf32<A_EXACT>(a1[k], ah[1], al[1]);
      to_tf32<A_EXACT>(a0[k + 4], ah[2], al[2]);
      to_tf32<A_EXACT>(a1[k + 4], ah[3], al[3]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (c0 + 8 * q < ncols) {
          const float* bp = Bs + (c0 + 8 * q + g) * PK + k + t;
          uint32_t bh[2], bl[2];
          to_tf32<B_EXACT>(bp[0], bh[0], bl[0]);
          to_tf32<B_EXACT>(bp[4], bh[1], bl[1]);
          mma_tf32x3<A_EXACT, B_EXACT>(part[q], ah, al, bh, bl);
        }
      }
    }
    add_into(acc, part);
  }
}

__host__ __device__ __forceinline__ int tiles_of(int chunk) {
  return (chunk + TILE - 1) / TILE;
}

// C B^T tiles (i, j) with j <= i, numbered i (i + 1) / 2 + j
__host__ __device__ __forceinline__ int pairs_of(int nt) {
  return nt * (nt + 1) / 2;
}

// one 64 x 64 tile of C B^T: warp w computes rows 16 (w % 4) .. + 15 and
// columns 32 (w / 4) .. + 31, and stores each 8-column block as the A
// fragment of ssd_chunk_kernel's product: tile[mb][ks][lane] = float4
// (c0, c2, c1, c3)
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
ssd_cb_kernel(const T* __restrict__ bm, const T* __restrict__ cm,
              Strides bs, Strides cst, int S, int G, int N, int chunk,
              float* __restrict__ cbuf) {
  const int nt = tiles_of(chunk), npairs = pairs_of(nt);
  const int pair = blockIdx.x % npairs, z = blockIdx.x / npairs;
  const int g = blockIdx.y, bi = blockIdx.z;
  int it = 0;
  while (pairs_of(it + 1) <= pair) ++it;
  const int jt = pair - pairs_of(it);
  extern __shared__ float sm[];
  float* Cs = sm;                    // (64, PK): C rows of tile i
  float* Bs = Cs + TILE * PK;        // (64, PK): B rows of tile j
  const long long s0 = (long long)z * chunk;
  const T* cbase = cm + bi * cst.b + s0 * cst.s + (long long)g * cst.h;
  const T* bbase = bm + bi * bs.b + s0 * bs.s + (long long)g * bs.h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mb = warp & 3, jh = warp >> 2;
  constexpr bool EXACT = is_b16<T>;
  float acc[4][4];
  zero(acc);
  // over N in slices of MAX_N columns (one slice for N <= 128)
  for (int n0 = 0; n0 < N; n0 += MAX_N) {
    const int Ns = min(MAX_N, N - n0), K8 = (Ns + 7) & ~7;
    if (n0 > 0) __syncthreads();     // the previous slice is consumed
    load_rows<8>(Cs, cbase + n0, cst.s, it * TILE, chunk, Ns, K8,
                 (const float*)nullptr);
    load_rows<8>(Bs, bbase + n0, bs.s, jt * TILE, chunk, Ns, K8,
                 (const float*)nullptr);
    __syncthreads();
    nt_product<EXACT, EXACT>(Cs, Bs, mb * 16, jh * 32, TILE, K8, acc);
  }
  const int nc = S / chunk;
  float* out = cbuf +
               ((((long long)bi * nc + z) * G + g) * npairs + pair) *
                   (TILE * TILE) +
               mb * 1024;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    *reinterpret_cast<float4*>(out + ((jh * 4 + q) * 32 + lane) * 4) =
        make_float4(acc[q][0], acc[q][2], acc[q][1], acc[q][3]);
}

template <typename T>
struct BlockPtrs {          // ssd_chunk_kernel's per-block bases
  const T* x;
  const T* b;
  const float* cb;
  float* y;
  float* st;                // the chunk state's first row
  long long xs, bs;         // row strides of x and b
};

// one block per (chunk z and column block pb of P, head, sequence):
// blockIdx.x = z npb + pb.  A launch covers the npb column blocks of Pl
// columns each from p_base on (Pl 64, and a second launch for a ragged
// rest; one launch of Pl = P for P <= 64), so that Pl is a parameter and
// not a register held through the kernel.  BIG: the chunk-long arrays
// live in `big`, a global buffer of 4 ntp floats a block (where shared
// memory cannot hold them), else in shared memory beside the tiles.
// (BIG's global pointers cost registers; its chunks are too long for
// occupancy to matter, so it runs at two blocks an SM)
template <typename T, typename TD, bool BIG>
__global__ void __launch_bounds__(THREADS, BIG ? 2 : 3)
ssd_chunk_kernel(const T* __restrict__ x, const TD* __restrict__ dt,
                 const float* __restrict__ a, const T* __restrict__ bm,
                 const float* __restrict__ cbuf, Strides xs, Strides ds,
                 Strides bs, int S, int H, int G, int P, int N, int chunk,
                 int Pl, int p_base, int npb,
                 float* __restrict__ yf, float* __restrict__ cs_out,
                 float* __restrict__ st_out, float* __restrict__ big) {
  const int z = blockIdx.x / npb;
  const int h = blockIdx.y, bi = blockIdx.z;
  const int nc = S / chunk;
  const int g = h / (H / G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int nt = tiles_of(chunk), ntp = nt * TILE;
  // the tiles first, at fixed offsets, then the chunk-long arrays
  extern __shared__ float4 smv[];
  uint32_t* Xh = reinterpret_cast<uint32_t*>(smv);        // (64, PX): xw
  uint32_t* Xl = Xh + TILE * PX;                          // its lo terms
  // (64, PK): B ⊙ dec for the state, and before it y's running sums
  float* Bs = reinterpret_cast<float*>(Xl + TILE * PX);
  float* arrays = BIG ? big + (((long long)bi * gridDim.y + h) * nc * npb +
                               blockIdx.x) * 4 * ntp
                      : Bs + TILE * PK;
  double* cs = reinterpret_cast<double*>(arrays);    // (ntp): cumsum
  float* dts = reinterpret_cast<float*>(cs + ntp);   // (ntp): dt
  float* dec = dts + ntp;                            // exp(cs_last - cs)

  const long long s0 = (long long)z * chunk;
  // the block's base pointers, read from shared memory where they are
  // used rather than held in registers through the whole kernel
  __shared__ BlockPtrs<T> ptr;
  if (tid == 0) {
    const int p0 = p_base + (blockIdx.x % npb) * MAX_P;
    ptr.x = x + bi * xs.b + s0 * xs.s + (long long)h * xs.h + p0;
    ptr.b = bm + bi * bs.b + s0 * bs.s + (long long)g * bs.h;
    ptr.cb = cbuf + (((long long)bi * nc + z) * G + g) * pairs_of(nt) *
                        (TILE * TILE);
    ptr.y = yf + ((long long)bi * S + s0) * H * P + (long long)h * P + p0;
    ptr.st = st_out + ((((long long)bi * nc + z) * H + h) * P + p0) * N;
    ptr.xs = xs.s;
    ptr.bs = bs.s;
  }
  const TD* db = dt + bi * ds.b + s0 * ds.s + (long long)h * ds.h;
  const float ah = a[h];
  for (int i = tid; i < ntp; i += THREADS) {
    const float d = i < chunk ? ld(db + i * ds.s) : 0.f;
    dts[i] = d;
    cs[i] = (double)(d * ah);
  }
  __syncthreads();
  if (tid < 32) {            // inclusive scan: a run per lane, then lanes
    const int per = (chunk + 31) / 32;
    const int lo = min(tid * per, chunk), hi = min(lo + per, chunk);
    double run = 0.0;
    for (int k = lo; k < hi; ++k) { run += cs[k]; cs[k] = run; }
    double incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double v = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += v;
    }
    double excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (tid == 0) excl = 0.0;
    for (int k = lo; k < hi; ++k) cs[k] += excl;
  }
  __syncthreads();
  const double cs_last = cs[chunk - 1];
  float* cso = cs_out + ((long long)bi * H + h) * S + s0;
  for (int i = tid; i < ntp; i += THREADS) {
    if (i < chunk && blockIdx.x % npb == 0 && p_base == 0)
      cso[i] = (float)cs[i];
    dec[i] = i < chunk ? expf((float)(cs_last - cs[i])) : 0.f;
  }

  // y: query band `band` holds tiles 2 band and 2 band + 1; warp w takes
  // rows 16 (w % 4) .. + 15 of tile 2 band + w / 4, all of the block's P.
  // Its running sums live in shared memory in the order of its accumulator
  // fragments (a float4 a lane and column block), and only the partial
  // sum of KS k-steps in registers.  That, the state's partial sums of
  // 16 n, the base pointers in shared memory and the fixed tile offsets
  // keep a thread at 80 registers, so that three blocks share an SM
  // (with y's sums in registers, even two blocks an SM spilled)
  const int mb = warp & 3;
  float4* run = reinterpret_cast<float4*>(Bs) + warp * 256 + lane;
  for (int band = 0; 2 * band < nt; ++band) {
    const int it = 2 * band + (warp >> 2);
    const int ia = it * TILE + mb * 16 + gq, ib = ia + 8;
    const bool live = it < nt && it * TILE + mb * 16 < chunk;
    const int jt_end = min(2 * band + 1, nt - 1);
    for (int jt = 0; jt <= jt_end; ++jt) {
      const int j0 = jt * TILE;
      __syncthreads();
      load_xw(Xh, Xl, ptr.x, ptr.xs, dts, j0, chunk, Pl);
      __syncthreads();
      if (!live || jt > it) continue;
      const float4* tile = reinterpret_cast<const float4*>(
          ptr.cb + (pairs_of(it) + jt) * (TILE * TILE) + mb * 1024) + lane;
      // on the diagonal tile, k-steps past the warp's last row are all
      // above the diagonal
      const int kend = jt == it ? min(8, 2 * mb + 2) : 8;
      float4 next = __ldg(tile);   // each k-step's scores, one step ahead
      for (int kp = 0; kp < kend; kp += KS) {
        float part[8][4];
        zero(part);
        for (int ks = kp; ks < min(kp + KS, kend); ++ks) {
          const float4 v = next;
          if (ks + 1 < kend) next = __ldg(tile + (ks + 1) * 32);
          const int j = j0 + ks * 8 + 2 * t;
          const double c0 = cs[j], c1 = cs[j + 1], csa = cs[ia],
                       csb = cs[ib];
          // decay, masked before exp: only j <= i inside the chunk
          const float s[4] = {
              (j <= ia && ia < chunk) ? v.x * expf((float)(csa - c0)) : 0.f,
              (j <= ib && ib < chunk) ? v.y * expf((float)(csb - c0)) : 0.f,
              (j + 1 <= ia && ia < chunk) ? v.z * expf((float)(csa - c1))
                                          : 0.f,
              (j + 1 <= ib && ib < chunk) ? v.w * expf((float)(csb - c1))
                                          : 0.f};
          uint32_t sh[4], sl[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(s[e], sh[e], sl[e]);
          const int r0 = (ks * 8 + 2 * t) * PX + gq;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            if (8 * q < Pl) {
              const uint32_t bh[2] = {Xh[r0 + 8 * q], Xh[r0 + PX + 8 * q]};
              const uint32_t bl[2] = {Xl[r0 + 8 * q], Xl[r0 + PX + 8 * q]};
              mma_tf32x3<false, false>(part[q], sh, sl, bh, bl);
            }
          }
        }
        const bool first = jt == 0 && kp == 0;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          float4 r = first ? make_float4(0.f, 0.f, 0.f, 0.f) : run[q * 32];
          r.x += part[q][0];
          r.y += part[q][1];
          r.z += part[q][2];
          r.w += part[q][3];
          run[q * 32] = r;
        }
      }
    }
    if (live) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float4 r = run[q * 32];
        const float v[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? ia : ib, p = 8 * q + 2 * t + (e & 1);
          if (i < chunk && p < Pl) ptr.y[(long long)i * H * P + p] = v[e];
        }
      }
    }
  }

  // the chunk's own state, st[p][n] = sum_j xw[j][p] (dec[j] B[j][n]), in
  // a pass of its own over the key tiles, last first (its xw is still
  // loaded); warp w takes p = 16 (w % 4) .. + 15, n = 64 (w / 4) .. + 63
  // of a slice of MAX_N columns (one slice for N <= 128), in four runs of
  // 16 n, so that a partial sum takes 8 registers
  const int nh = warp >> 2;
  const bool p_live = mb * 16 < Pl;
  for (int ns = 0; ns < N; ns += MAX_N) {
    const int Ns = min(MAX_N, N - ns), K8 = (Ns + 7) & ~7;
    float st[8][4];          // p = 16 mb + gq (+ 8); n = ns + 64 nh + 8q + 2t
    zero(st);
    for (int jt = nt - 1; jt >= 0; --jt) {
      const int j0 = jt * TILE;
      __syncthreads();
      if (jt != nt - 1 || ns > 0)
        load_xw(Xh, Xl, ptr.x, ptr.xs, dts, j0, chunk, Pl);
      load_rows<1>(Bs, ptr.b + ns, ptr.bs, j0, chunk, Ns, K8, dec + j0);
      __syncthreads();
      if (!p_live) continue;
      const int kend = min(8, (chunk - j0 + 7) / 8);
#pragma unroll
      for (int run16 = 0; run16 < 4; ++run16) {
        const int n0 = nh * 64 + 16 * run16;
        if (n0 >= Ns) continue;
        for (int kp = 0; kp < kend; kp += KS) {
          float part[2][4];
          zero(part);
          for (int ks = kp; ks < min(kp + KS, kend); ++ks) {
            const int r0 = (ks * 8 + 2 * t) * PX + mb * 16 + gq;
            const uint32_t xh[4] = {Xh[r0], Xh[r0 + 8], Xh[r0 + PX],
                                    Xh[r0 + PX + 8]};
            const uint32_t xl[4] = {Xl[r0], Xl[r0 + 8], Xl[r0 + PX],
                                    Xl[r0 + PX + 8]};
            const float* brow = Bs + (ks * 8 + 2 * t) * PK + n0 + gq;
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              if (n0 + 8 * q < Ns) {
                uint32_t bh[2], bl[2];
                split_tf32(brow[8 * q], bh[0], bl[0]);
                split_tf32(brow[PK + 8 * q], bh[1], bl[1]);
                mma_tf32x3<false, false>(part[q], xh, xl, bh, bl);
              }
            }
          }
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) st[2 * run16 + q][e] += part[q][e];
        }
      }
    }
    if (!p_live) continue;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = mb * 16 + gq + (e < 2 ? 0 : 8);
        const int n = nh * 64 + 8 * q + 2 * t + (e & 1);
        if (p < Pl && n < Ns) ptr.st[p * N + ns + n] = st[q][e];
      }
    }
  }
}

// the inter-chunk recurrence, in place: slot z of st becomes the state
// entering chunk z; the carry after the last chunk is the final state
__global__ void __launch_bounds__(THREADS)
ssd_state_kernel(float* __restrict__ st, const float* __restrict__ cs,
                 float* __restrict__ final_state, int S, int H, int PN,
                 int chunk) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  const int h = blockIdx.y, bi = blockIdx.z;
  if (e >= PN) return;
  const int nc = S / chunk;
  const float* csb = cs + ((long long)bi * H + h) * S;
  float carry = 0.f;
  for (int z = 0; z < nc; ++z) {
    float* slot = st + (((long long)bi * nc + z) * H + h) * PN + e;
    const float mine = *slot;
    *slot = carry;
    carry = carry * expf(csb[(long long)z * chunk + chunk - 1]) + mine;
  }
  final_state[((long long)bi * H + h) * PN + e] = carry;
}

// y += (C state_in^T) ⊙ exp(cs) over 64-row tiles of the chunk: warp w
// takes rows 16 (w % 4) .. + 15 and p = 32 (w / 4) .. + 31 of the block's
// 64 columns of P (blockIdx.x = z npb + pb, as ssd_chunk_kernel), the sum
// over N in slices of MAX_N (the state's slice loaded once for N <= 128)
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
ssd_carry_kernel(const T* __restrict__ cm, Strides cst, const float* st,
                 const float* __restrict__ cs, const float* yf, T* y, int S,
                 int H, int G, int P, int N, int chunk) {
  const int npb = (P + MAX_P - 1) / MAX_P;
  const int z = blockIdx.x / npb, pb = blockIdx.x % npb;
  const int h = blockIdx.y, bi = blockIdx.z;
  const int p0 = pb * MAX_P, Pl = min(MAX_P, P - p0);  // the block's P
  const int nc = S / chunk;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const long long s0 = (long long)z * chunk;
  const long long row = (long long)H * P;
  const float* yfb =
      yf + ((long long)bi * S + s0) * row + (long long)h * P + p0;
  T* yb = y + ((long long)bi * S + s0) * row + (long long)h * P + p0;
  if (z == 0) {              // a zero state enters the first chunk
    if ((const void*)yf != (const void*)y)
      for (int idx = tid; idx < chunk * Pl; idx += THREADS) {
        const int i = idx / Pl, p = idx % Pl;
        yb[i * row + p] = from_f<T>(yfb[i * row + p]);
      }
    return;
  }
  extern __shared__ float sm[];
  float* Cs = sm;                    // (64, PK): C rows
  float* Ps = Cs + TILE * PK;        // (64, PK): entering state, [p][n]
  const float* stb = st + ((((long long)bi * nc + z) * H + h) * P + p0) * N;
  const bool one = N <= MAX_N;       // the state's one slice, loaded once
  if (one)
    load_rows<8>(Ps, stb, (long long)N, 0, Pl, N, (N + 7) & ~7,
                 (const float*)nullptr);
  const float* csb = cs + ((long long)bi * H + h) * S + s0;
  const T* cb = cm + bi * cst.b + s0 * cst.s + (long long)g * cst.h;
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, t = lane & 3;
  const int mb = warp & 3, ph = warp >> 2;
  const bool p_live = ph * 32 < Pl;
  for (int i0 = 0; i0 < chunk; i0 += TILE) {
    const bool busy = p_live && i0 + mb * 16 < chunk;
    float acc[4][4];         // rows i0 + 16 mb + gq (+ 8), p = 32 ph + 8q + 2t
    zero(acc);
    for (int n0 = 0; n0 < N; n0 += MAX_N) {
      const int Ns = min(MAX_N, N - n0), K8 = (Ns + 7) & ~7;
      __syncthreads();
      load_rows<8>(Cs, cb + n0, cst.s, i0, chunk, Ns, K8,
                   (const float*)nullptr);
      if (!one)
        load_rows<8>(Ps, stb + n0, (long long)N, 0, Pl, Ns, K8,
                     (const float*)nullptr);
      __syncthreads();
      if (busy)
        nt_product<is_b16<T>, false>(Cs, Ps, mb * 16, ph * 32, Pl, K8, acc);
    }
    if (!busy) continue;
    // the warp's 16 x 32 of yf, every load issued before any store (y may
    // be yf itself: a load after each store would wait out each in turn)
    float yv[4][4];          // as acc
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + mb * 16 + gq + (e < 2 ? 0 : 8);
        const int p = ph * 32 + 8 * q + 2 * t + (e & 1);
        yv[q][e] = i < chunk && p < Pl ? yfb[i * row + p] : 0.f;
      }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + mb * 16 + gq + (e < 2 ? 0 : 8);
      if (i >= chunk) continue;
      const float ex = expf(csb[i]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = ph * 32 + 8 * q + 2 * t + (e & 1);
        if (p < Pl) yb[i * row + p] = from_f<T>(yv[q][e] + acc[q][e] * ex);
      }
    }
  }
}

static size_t tiles_smem() { return sizeof(float) * (size_t)2 * TILE * PK; }

// the chunk kernel's shared memory: its tiles, and the chunk-long arrays
// when they fit beside them (arrays_in_smem)
static size_t chunk_arrays(int chunk) {
  return (size_t)tiles_of(chunk) * TILE * (sizeof(double) + 2 * sizeof(float));
}
static size_t chunk_tiles() {
  return sizeof(uint32_t) * (size_t)2 * TILE * PX +
         sizeof(float) * (size_t)TILE * PK;
}
static bool arrays_in_smem(int chunk) {
  return chunk_tiles() + chunk_arrays(chunk) <= SMEM_OPTIN;
}

template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, typename TD>
static cudaError_t run(const void* x, const void* dt, const float* a,
                       const void* b, const void* c, Strides xs, Strides ds,
                       Strides bs, Strides cst, int B, int S, int H, int G,
                       int P, int N, int chunk, void* y, float* yf,
                       float* cs, float* st, float* cbuf, float* fin,
                       float* big, cudaStream_t stream) {
  const int nc = S / chunk, npairs = pairs_of(tiles_of(chunk));
  const int npb = (P + MAX_P - 1) / MAX_P;
  const bool in_smem = arrays_in_smem(chunk);
  if (in_smem != (big == nullptr)) return cudaErrorInvalidValue;
  const size_t smt = tiles_smem(),
               smc = chunk_tiles() + (in_smem ? chunk_arrays(chunk) : 0);
  cudaError_t err;
  if ((err = allow_smem(ssd_cb_kernel<T>, smt)) != cudaSuccess ||
      (err = allow_smem(ssd_chunk_kernel<T, TD, false>, smc)) !=
          cudaSuccess ||
      (err = allow_smem(ssd_chunk_kernel<T, TD, true>, smc)) != cudaSuccess ||
      (err = allow_smem(ssd_carry_kernel<T>, smt)) != cudaSuccess)
    return err;
  ssd_cb_kernel<T><<<dim3(npairs * nc, G, B), THREADS, smt, stream>>>(
      (const T*)b, (const T*)c, bs, cst, S, G, N, chunk, cbuf);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // the column blocks of P: full ones of MAX_P, then a ragged rest
  const int full = P > MAX_P ? P / MAX_P : 0, rest = P - full * MAX_P;
  auto chunk_kernel = in_smem ? ssd_chunk_kernel<T, TD, false>
                               : ssd_chunk_kernel<T, TD, true>;
  if (full > 0) {
    chunk_kernel<<<dim3(nc * full, H, B), THREADS, smc, stream>>>(
        (const T*)x, (const TD*)dt, a, (const T*)b, cbuf, xs, ds, bs, S, H,
        G, P, N, chunk, MAX_P, 0, full, yf, cs, st, big);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (rest > 0) {
    chunk_kernel<<<dim3(nc, H, B), THREADS, smc, stream>>>(
        (const T*)x, (const TD*)dt, a, (const T*)b, cbuf, xs, ds, bs, S, H,
        G, P, N, chunk, rest, full * MAX_P, 1, yf, cs, st,
        in_smem ? big : big + (long long)B * H * nc * full * 4 *
                                  tiles_of(chunk) * TILE);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const dim3 blocks(nc * npb, H, B);
  ssd_state_kernel<<<dim3((P * N + THREADS - 1) / THREADS, H, B), THREADS, 0,
                     stream>>>(st, cs, fin, S, H, P * N, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_carry_kernel<T><<<blocks, THREADS, smt, stream>>>(
      (const T*)c, cst, st, cs, yf, (T*)y, S, H, G, P, N, chunk);
  return cudaGetLastError();
}

// The floats of the global scratch buffer `big` that a call with these
// shapes needs (0: the chunk kernel keeps its chunk-long arrays in shared
// memory, and big is null): 4 ntp floats (cs in float64, dt, the decay)
// for each of its blocks.
extern "C" long long ssd_scan_big_floats(int B, int S, int H, int P,
                                         int chunk) {
  if (chunk < 1 || arrays_in_smem(chunk)) return 0;
  const long long npb = (P + MAX_P - 1) / MAX_P;
  return (long long)B * H * (S / chunk) * npb * 4 * tiles_of(chunk) * TILE;
}

// x (B, S, H, P), dt (B, S, H), b and c (B, S, G, N): unit stride on the
// last axis, the other strides (in elements) given; a (H,) float32.
// x, b and c share x_dt; dt has dt_dt (DT_F32, DT_BF16 or DT_F16).  y (B,
// S, H, P) contiguous in x's dtype; yf a float32 (B, S, H, P) buffer (y
// itself when x is float32); cs (B, H, S), st (B, S / chunk, H, P, N) and
// cb (B, S / chunk, G, T (T + 1) / 2, 64, 64) with T = ceil(chunk / 64)
// float32 scratch; fin (B, H, P, N) float32, the final state; big the
// scratch of ssd_scan_big_floats floats, or null when that is 0.  Any P,
// N >= 1 and chunk dividing S.
extern "C" int ssd_scan_launch(
    const void* x, const void* dt, const void* a, const void* b,
    const void* c, long long xsb, long long xss, long long xsh,
    long long dsb, long long dss, long long dsh, long long bsb,
    long long bss, long long bsg, long long csb, long long css,
    long long csg, int B, int S, int H, int G, int P, int N, int chunk,
    int x_dt, int dt_dt, void* y, void* yf, void* cs, void* st, void* cb,
    void* fin, void* big, void* stream) {
  if (B < 1 || S < 1 || H < 1 || G < 1 || H % G || P < 1 || N < 1 ||
      chunk < 1 || S % chunk || H > 65535 || G > 65535 || B > 65535 ||
      (long long)(S / chunk) * pairs_of(tiles_of(chunk)) > 0x7fffffff ||
      (long long)(S / chunk) * ((P + MAX_P - 1) / MAX_P) > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (x_dt != DT_F32 && yf == y) return (int)cudaErrorInvalidValue;
  const Strides xs{xsb, xss, xsh}, ds{dsb, dss, dsh}, bs{bsb, bss, bsg},
      cst{csb, css, csg};
  cudaStream_t s = (cudaStream_t)stream;
  const float* af = (const float*)a;
  float *yff = (float*)yf, *csf = (float*)cs, *stf = (float*)st,
        *cbf = (float*)cb, *ff = (float*)fin, *bg = (float*)big;
#define RUN(T, TD)                                                        \
  return (int)run<T, TD>(x, dt, af, b, c, xs, ds, bs, cst, B, S, H, G, P, \
                         N, chunk, y, yff, csf, stf, cbf, ff, bg, s)
#define RUN_DT(T)                             \
  {                                           \
    if (dt_dt == DT_F32) RUN(T, float);       \
    if (dt_dt == DT_BF16) RUN(T, bf16);       \
    if (dt_dt == DT_F16) RUN(T, f16);         \
  }
  if (x_dt == DT_F32) RUN_DT(float)
  if (x_dt == DT_BF16) RUN_DT(bf16)
  if (x_dt == DT_F16) RUN_DT(f16)
#undef RUN_DT
#undef RUN
  return (int)cudaErrorInvalidValue;
}
