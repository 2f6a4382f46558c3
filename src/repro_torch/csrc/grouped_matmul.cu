// Grouped (per-expert) matmul for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/grouped_matmul.py:49
// (grouped_matmul / _gmm_kernel :19): out[e] = x[e] @ w[e] for
// x (E, C, D), w (E, D, F), accumulated in float32 over D and stored in
// x's dtype.  The TPU kernel keeps a (block_c, block_f) float32
// accumulator in VMEM across a sequential grid dimension over D; here a
// loop over D inside each block takes that dimension's place and the
// accumulators stay in registers for the whole loop.
//
// Three routes, chosen by the wrapper from dtype, shape and alignment
// alone (kernels/grouped_matmul.py, grouped_matmul_route); the entry
// point refuses a route the input does not allow.
//
//  - wgmma (bf16 or fp16, D % 8 == 0, F % 8 == 0, D > 0, x and w 16-byte
//    aligned: what TMA's 16-byte strides and addresses need).  fp16 runs
//    the same kernel on fp16 operands (Hopper's wgmma and mma.sync take
//    f16 at the same shapes and rates as bf16, float32 accumulate).  Bound by
//    operations: at phi3.5-moe's expert up projection (E 16, C 640,
//    D 4,096, F 6,400) the product is 5.37e11 flops, 0.543 ms at 989
//    TFLOP/s, against 1.054 GB moved (x, w and out once each), 0.315 ms
//    at 3.35 TB/s.  Only wgmma reaches the tensor cores' full rate, so a
//    block is three warpgroups: one thread of the producer keeps TMA
//    loads of 128 x 64 x tiles and 64 x 256 w tiles in flight in a
//    four-stage ring of mbarriers (192 KB of shared memory, one block an
//    SM); two consumer warpgroups each run wgmma m64n256k16 on 64 rows
//    of the block's 128 x 256 output tile, with 128 float32 accumulators
//    a thread (setmaxnreg moves registers from the producer to them).
//    w is read in place: (D, F) with F contiguous is an N-major B
//    operand, loaded as four 64-wide boxes and fed to wgmma transposed,
//    so no transposed copy of w (0.84 GB at that shape) is ever made.
//    Blocks run C tiles fastest, then F tiles, then experts, so the
//    blocks that share a w tile run together and w comes from device
//    memory about once.  TMA's zero fill covers the ragged C, D and F
//    edges (its 3-D boxes never cross an expert); the epilogue masks
//    rows and columns.  With many small experts (kimi-k2: C 112,
//    D 7,168, F 2,048) the bytes of w bound it instead, and the ring
//    keeps 192 KB of them in flight on each SM.
//  - mma_sync (every other bf16 or fp16 input, e.g. a ragged D or F, or a view
//    off 16-byte alignment).  Eight warps on a 128 x 128 tile with
//    mma.sync m16n8k16, 32-deep slices of x and w staged through
//    registers into shared memory (w transposed), loads masked element
//    by element where the edges are ragged.
//  - fma (float32).  IEEE float32 FMAs, no TF32 (which would break the
//    reference's 2e-3 tolerance): a 64 x 64 tile per block of 256
//    threads, 4 x 4 outputs a thread, 16-deep slices in shared memory.
//    Bound by float32 operations at 67 TFLOP/s.
// The last two mask the ragged edges of C, F and D themselves:
// out-of-range elements load as zero and are never stored.

#include "hopper.cuh"

// ---------------------------------------------------------------------------
// bf16: mma.sync
// ---------------------------------------------------------------------------

#define BM 128
#define BN 128
#define BK 32
#define PITCH (BK + 8)  // 40 bf16 = 20 words: conflict-free fragment reads

// 8 consecutive 16-bit elements from row-major src at (r, c) of an
// (R, Cn) matrix, zero beyond the edges; vec: rows are 16-byte aligned and
// Cn % 8 == 0
template <typename T>
__device__ __forceinline__ uint4 load8(const T* src, int r, int c, int R,
                                       int Cn, bool vec) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (r >= R) return v;
  const T* p = src + (long long)r * Cn + c;
  if (vec && c + 8 <= Cn) return *reinterpret_cast<const uint4*>(p);
  unsigned short h[8];
  const unsigned short* ph = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = (c + i < Cn) ? ph[i] : 0;
  v.x = h[0] | ((uint32_t)h[1] << 16);
  v.y = h[2] | ((uint32_t)h[3] << 16);
  v.z = h[4] | ((uint32_t)h[5] << 16);
  v.w = h[6] | ((uint32_t)h[7] << 16);
  return v;
}

// T: bf16 or fp16
template <typename T>
__global__ void __launch_bounds__(256)
gmm_b16_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ out, int C, int D, int F, int vec) {
  __shared__ __align__(16) T As[BM][PITCH];  // x slice: [row][k]
  __shared__ __align__(16) T Bs[BN][PITCH];  // w slice, transposed: [n][k]
  const int e = blockIdx.z, c0 = blockIdx.y * BM, f0 = blockIdx.x * BN;
  const T* xe = x + (long long)e * C * D;
  const T* we = w + (long long)e * D * F;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;  // warp's 64 x 32 piece
  const int grp = lane / 4, tig = lane % 4;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][j][t] = 0.f;

  uint4 ra[2], rb[2];
  // x slice: chunk q = tid + 256 i -> row q / 4, k (q % 4) * 8
  // w slice: chunk q -> k q % 32, n (q / 32) * 8 (a warp covers 32 k of
  // one n group, so the transposed stores hit distinct banks)
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = tid + 256 * i;
      ra[i] = load8(xe, c0 + q / 4, k0 + (q % 4) * 8, C, D, vec);
      const int kk = q % 32, n = (q / 32) * 8;
      rb[i] = load8(we, k0 + kk, f0 + n, D, F, vec);
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = tid + 256 * i;
      *reinterpret_cast<uint4*>(&As[q / 4][(q % 4) * 8]) = ra[i];
      const int kk = q % 32, n = (q / 32) * 8;
      const unsigned short* h = reinterpret_cast<const unsigned short*>(&rb[i]);
#pragma unroll
      for (int t = 0; t < 8; ++t)
        reinterpret_cast<unsigned short*>(&Bs[n + t][kk])[0] = h[t];
    }
  };

  fetch(0);
  stash();
  __syncthreads();
  for (int k0 = 0; k0 < D; k0 += BK) {
    const bool more = k0 + BK < D;
    if (more) fetch(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm * 64 + i * 16 + grp;
        const int k = kk + tig * 2;
        a[i][0] = *reinterpret_cast<const uint32_t*>(&As[r][k]);
        a[i][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][k]);
        a[i][2] = *reinterpret_cast<const uint32_t*>(&As[r][k + 8]);
        a[i][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][k + 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn * 32 + j * 8 + grp;
        const int k = kk + tig * 2;
        b[j][0] = *reinterpret_cast<const uint32_t*>(&Bs[n][k]);
        b[j][1] = *reinterpret_cast<const uint32_t*>(&Bs[n][k + 8]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma16<T>(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
    if (more) {
      stash();
      __syncthreads();
    }
  }

  T* oe = out + (long long)e * C * F;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = c0 + wm * 64 + i * 16 + grp;
      const int n = f0 + wn * 32 + j * 8 + tig * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = r + 8 * h;
        if (rr >= C) continue;
        if (n < F) oe[(long long)rr * F + n] = from_f<T>(acc[i][j][2 * h]);
        if (n + 1 < F)
          oe[(long long)rr * F + n + 1] = from_f<T>(acc[i][j][2 * h + 1]);
      }
    }
}

// ---------------------------------------------------------------------------
// float32: IEEE FMAs
// ---------------------------------------------------------------------------

#define FT 64  // output tile
#define FK 16  // contraction slice

__global__ void __launch_bounds__(256)
gmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
               float* __restrict__ out, int C, int D, int F) {
  __shared__ float As[FK][FT + 1];  // x slice, transposed: [k][row]
  __shared__ float Bs[FK][FT];      // w slice: [k][n]
  const int e = blockIdx.z, c0 = blockIdx.y * FT, f0 = blockIdx.x * FT;
  const float* xe = x + (long long)e * C * D;
  const float* we = w + (long long)e * D * F;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += FK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = tid + 256 * i;
      const int kk = q % FK, r = q / FK;
      const int gr = c0 + r, gk = k0 + kk;
      As[kk][r] = (gr < C && gk < D) ? xe[(long long)gr * D + gk] : 0.f;
      const int n = q % FT, kb = q / FT;
      const int gn = f0 + n, gkb = k0 + kb;
      Bs[kb][n] = (gn < F && gkb < D) ? we[(long long)gkb * F + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* oe = out + (long long)e * C * F;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = c0 + ty + 16 * i, n = f0 + tx + 16 * j;
      if (r < C && n < F) oe[(long long)r * F + n] = acc[i][j];
    }
}

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA through an mbarrier ring
// ---------------------------------------------------------------------------

constexpr int WG_CONSUMERS = 2;              // consumer warpgroups
constexpr int WG_THREADS = 128 * (1 + WG_CONSUMERS);
constexpr int WG_BM = 64 * WG_CONSUMERS;     // rows of C a block
constexpr int WG_BN = 256;                   // columns of F a block
constexpr int WG_BK = 64;                    // one 128-byte swizzle row
constexpr int WG_STAGES = 4;
constexpr int WG_A_BYTES = WG_BM * WG_BK * 2;  // x tile, K-major
constexpr int WG_B_BYTES = WG_BK * WG_BN * 2;  // w tile, four N-major boxes
constexpr int WG_BOX_BYTES = WG_BK * 64 * 2;   // one 64-wide box of w
constexpr int WG_STAGE_BYTES = WG_A_BYTES + WG_B_BYTES;
// the ring, 1024 bytes to align it for the swizzle, the barriers
constexpr int WG_SMEM = WG_STAGES * WG_STAGE_BYTES + 1024 +
                        2 * WG_STAGES * (int)sizeof(uint64_t);

// tx: x as (D, C, E), boxes of 64 x WG_BM; tw: w as (F, D, E), boxes of
// 64 x 64.  One block per (C tile, F tile, expert), C tiles fastest.
// T: bf16 or fp16.
template <typename T>
__global__ void __launch_bounds__(WG_THREADS, 1)
gmm_wgmma_kernel(__grid_constant__ const CUtensorMap tx,
                 __grid_constant__ const CUtensorMap tw,
                 T* __restrict__ out, int C, int D, int F, int n_c,
                 int n_f) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + WG_STAGES *
                                               WG_STAGE_BYTES);
  uint64_t* empty = full + WG_STAGES;
  const int tile = blockIdx.x;
  const int c0 = (tile % n_c) * WG_BM;
  const int f0 = (tile / n_c % n_f) * WG_BN;
  const int e = tile / (n_c * n_f);
  const int n_k = (D + WG_BK - 1) / WG_BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);                      // the producer's arrival
      mbar_init(&empty[s], 4 * WG_CONSUMERS);      // one a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int k = 0; k < n_k; ++k) {
        const int s = k % WG_STAGES;
        // the stage's previous round has been read (round 0 passes)
        mbar_wait(&empty[s], ((k / WG_STAGES) & 1) ^ 1);
        uint8_t* a = ring + s * WG_STAGE_BYTES;
        uint8_t* b = a + WG_A_BYTES;
        mbar_arrive_expect_tx(&full[s], WG_STAGE_BYTES);
        tma_load_3d(a, &tx, &full[s], k * WG_BK, c0, e);
#pragma unroll
        for (int j = 0; j < WG_BN / 64; ++j)
          tma_load_3d(b + j * WG_BOX_BYTES, &tw, &full[s], f0 + 64 * j,
                      k * WG_BK, e);
      }
    }
  } else {
    // consumers: warpgroup cw owns rows 64 cw .. 64 cw + 63 of the tile
    setmaxnreg_inc<232>();
    const int cw = wg - 1;
    const int lane = threadIdx.x % 32;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    for (int k = 0; k < n_k; ++k) {
      const int s = k % WG_STAGES;
      mbar_wait(&full[s], (k / WG_STAGES) & 1);
      const uint8_t* a = ring + s * WG_STAGE_BYTES + cw * 64 * WG_BK * 2;
      const uint8_t* b = ring + s * WG_STAGE_BYTES + WG_A_BYTES;
      const uint64_t da = wgmma_desc_sw128(a, 16, 1024);
      const uint64_t db = wgmma_desc_sw128(b, WG_BOX_BYTES, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk)
        // 16 k: 32 bytes on in x's rows, 16 rows (2,048 bytes) on in w's
        wgmma_m64n256k16<1, T>(acc, da + 2 * kk, db + 128 * kk);
      wgmma_commit();
      // the group before this one is done: hand its stage back
      wgmma_wait<1>();
      if (k > 0 && lane == 0) mbar_arrive(&empty[(k - 1) % WG_STAGES]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 128; ++i) reg_fence(acc[i]);

    const int warp = (threadIdx.x % 128) / 32;
    const int r = c0 + 64 * cw + 16 * warp + lane / 4;
    T* oe = out + (long long)e * C * F;
#pragma unroll
    for (int j = 0; j < WG_BN / 8; ++j) {
      const int n = f0 + 8 * j + 2 * (lane % 4);
      if (n >= F) continue;  // F % 8 == 0: n + 1 < F too
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = r + 8 * h;
        if (rr >= C) continue;
        *reinterpret_cast<uint32_t*>(oe + (long long)rr * F + n) =
            pack2<T>(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// entry point
// ---------------------------------------------------------------------------

// route codes, as kernels/grouped_matmul.py passes them
#define ROUTE_FMA 0
#define ROUTE_MMA_SYNC 1
#define ROUTE_WGMMA 2

template <typename T>
static cudaError_t launch_wgmma(const void* x, const void* w, void* out,
                                int E, int C, int D, int F, bool f16,
                                cudaStream_t st) {
  const long long n_c = (C + WG_BM - 1) / WG_BM;
  const long long n_f = (F + WG_BN - 1) / WG_BN;
  if (n_c * n_f * E > 0x7fffffffLL) return cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  int rc = encode_b16_3d(&tx, x, D, C, E, WG_BK, WG_BM, f16);
  if (rc == 0) rc = encode_b16_3d(&tw, w, F, D, E, 64, WG_BK, f16);
  if (rc != 0) return (cudaError_t)rc;
  cudaError_t err = cudaFuncSetAttribute(
      gmm_wgmma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      WG_SMEM);
  if (err != cudaSuccess) return err;
  gmm_wgmma_kernel<T><<<(unsigned)(n_c * n_f * E), WG_THREADS, WG_SMEM,
                        st>>>(tx, tw, (T*)out, C, D, F, (int)n_c, (int)n_f);
  return cudaGetLastError();
}

// x (E, C, D), w (E, D, F), out (E, C, F), all contiguous, one dtype dt:
// DT_F32 for ROUTE_FMA, DT_BF16 or DT_F16 for the others.
// cudaErrorInvalidValue for a route the dtype, shape or alignment does
// not allow.
extern "C" int grouped_matmul_launch(const void* x, const void* w, void* out,
                                     int E, int C, int D, int F, int route,
                                     int dt, void* stream) {
  if (E < 1 || C < 1 || D < 0 || F < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool aligned = ((uintptr_t)x | (uintptr_t)w) % 16 == 0;
  const bool b16 = dt == DT_BF16 || dt == DT_F16;
  if (route == ROUTE_WGMMA && b16) {
    if (!(aligned && D > 0 && D % 8 == 0 && F % 8 == 0))
      return (int)cudaErrorInvalidValue;
    return (int)(dt == DT_F16
                     ? launch_wgmma<f16>(x, w, out, E, C, D, F, true, st)
                     : launch_wgmma<bf16>(x, w, out, E, C, D, F, false, st));
  } else if (route == ROUTE_MMA_SYNC && b16) {
    const dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, E);
    if (grid.y > 65535 || E > 65535) return (int)cudaErrorInvalidValue;
    const int v = aligned && D % 8 == 0 && F % 8 == 0;
    if (dt == DT_F16)
      gmm_b16_kernel<f16><<<grid, 256, 0, st>>>(
          (const f16*)x, (const f16*)w, (f16*)out, C, D, F, v);
    else
      gmm_b16_kernel<bf16><<<grid, 256, 0, st>>>(
          (const bf16*)x, (const bf16*)w, (bf16*)out, C, D, F, v);
  } else if (route == ROUTE_FMA && dt == DT_F32) {
    const dim3 grid((F + FT - 1) / FT, (C + FT - 1) / FT, E);
    if (grid.y > 65535 || E > 65535) return (int)cudaErrorInvalidValue;
    gmm_f32_kernel<<<grid, 256, 0, st>>>((const float*)x, (const float*)w,
                                         (float*)out, C, D, F);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
