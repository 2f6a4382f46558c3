// Grouped (per-expert) matmul for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/grouped_matmul.py:49
// (grouped_matmul / _gmm_kernel :19): out[e] = x[e] @ w[e] for
// x (E, C, D), w (E, D, F), accumulated in float32 over D and stored in
// x's dtype.
//
// What bounds it: operations.  At phi3.5-moe's expert up projection
// (E 16, C 640, D 4,096, F 6,400, bf16) the product is 5.37e11 flops
// against 0.97 GB moved: 0.543 ms at 989 TFLOP/s (bf16 tensor cores), 3.4x
// the bytes' time.  The TPU kernel keeps a (block_c, block_f) float32
// accumulator in VMEM across a sequential grid dimension over D.
//
// Design: one block per (e, 128-row C tile, 128-column F tile); the loop
// over D inside the block replaces the TPU's sequential grid dimension,
// and the float32 accumulators stay in registers for the whole loop.
//  - bf16: eight warps, each a 64 x 32 piece of the tile, on the tensor
//    cores with mma.sync m16n8k16 (bf16 in, float32 accumulate: each
//    product of two bf16 is exact in float32, as the TPU kernel's
//    widening).  32-deep slices of x and w are staged in shared memory,
//    w's transposed so that each B fragment is one 32-bit load; the next
//    slice is loaded into registers while the tensor cores work on this
//    one.
//  - float32: IEEE float32 FMAs (no TF32), a 64 x 64 tile per block of
//    256 threads, 4 x 4 outputs a thread, 16-deep slices in shared memory.
// Both mask the ragged edges of C, F and D themselves (phi3.5-moe's down
// projection contracts over 6,400, not a multiple of the reference's
// block_d = 512): out-of-range elements load as zero and are never
// stored.  wgmma and TMA are later work.

#include "common.cuh"

// ---------------------------------------------------------------------------
// bf16: mma.sync
// ---------------------------------------------------------------------------

#define BM 128
#define BN 128
#define BK 32
#define PITCH (BK + 8)  // 40 bf16 = 20 words: conflict-free fragment reads

// 8 consecutive bf16 from row-major src at (r, c) of an (R, Cn) matrix,
// zero beyond the edges; vec: rows are 16-byte aligned and Cn % 8 == 0
__device__ __forceinline__ uint4 load8(const bf16* src, int r, int c, int R,
                                       int Cn, bool vec) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (r >= R) return v;
  const bf16* p = src + (long long)r * Cn + c;
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

__global__ void __launch_bounds__(256)
gmm_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                bf16* __restrict__ out, int C, int D, int F, int vec) {
  __shared__ __align__(16) bf16 As[BM][PITCH];  // x slice: [row][k]
  __shared__ __align__(16) bf16 Bs[BN][PITCH];  // w slice, transposed: [n][k]
  const int e = blockIdx.z, c0 = blockIdx.y * BM, f0 = blockIdx.x * BN;
  const bf16* xe = x + (long long)e * C * D;
  const bf16* we = w + (long long)e * D * F;
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
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
    if (more) {
      stash();
      __syncthreads();
    }
  }

  bf16* oe = out + (long long)e * C * F;
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
        if (n < F) oe[(long long)rr * F + n] = from_f<bf16>(acc[i][j][2 * h]);
        if (n + 1 < F)
          oe[(long long)rr * F + n + 1] = from_f<bf16>(acc[i][j][2 * h + 1]);
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

// x (E, C, D), w (E, D, F), out (E, C, F), all contiguous, one dtype.
// vec: x and w are 16-byte aligned (bf16 only; D % 8 and F % 8 are
// checked here).
extern "C" int grouped_matmul_launch(const void* x, const void* w, void* out,
                                     int E, int C, int D, int F, int dt,
                                     int vec, void* stream) {
  if (E < 1 || C < 1 || D < 0 || F < 1 || E > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dt == DT_BF16) {
    const dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, E);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    const int v = vec && D % 8 == 0 && F % 8 == 0;
    gmm_bf16_kernel<<<grid, 256, 0, st>>>((const bf16*)x, (const bf16*)w,
                                          (bf16*)out, C, D, F, v);
  } else if (dt == DT_F32) {
    const dim3 grid((F + FT - 1) / FT, (C + FT - 1) / FT, E);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    gmm_f32_kernel<<<grid, 256, 0, st>>>((const float*)x, (const float*)w,
                                         (float*)out, C, D, F);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
