// RMSNorm for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/rmsnorm.py:36 (rmsnorm /
// _rmsnorm_kernel :17): for each row x of the (rows, D) input
//
//   y = (x * rsqrt(mean(x^2) + eps)) * scale
//
// in float32, stored in x's dtype (round to nearest even for bf16 and
// fp16).  x and the scale are each float32, bf16 or fp16.
//
// What bounds it: bytes.  Each element is read once and written once, and
// the work per element is three flops; at llama3.2-3b's hidden norm
// (16,384 x 3,072 bf16) that is 201 MB, 0.060 ms at 3.35 TB/s.  The TPU
// kernel exists to read x once instead of twice (once for the variance,
// once to normalise), and so does this one.
//
// Design: a row is loaded once into registers, its sum of squares
// reduced in float32 with warp shuffles (and across warps through shared
// memory for a wide row), then every element is scaled from the
// registers and stored.  Loads and stores move four elements a lane
// (8 bytes of bf16, 16 of float32) where D % 4 == 0 and the rows are
// aligned; one element otherwise.  Shapes of the same kernel serve both
// widths the models use:
//  - D <= 1,024: a warp per row (the qk-norm's D = 128 would leave a
//    block-wide row mostly idle), and for D <= 256 a warp takes 4 or 2
//    rows at once, so that it has several loads in flight;
//  - wider rows: a block of 256 threads per row (512 above D = 8,192),
//    the register array sized to the row (8, 16 or 32 values a thread),
//    so that an SM holds as many rows in flight as its registers allow.
// A lane's vectors are TPR vectors apart, so each warp load reads
// consecutive addresses.  A row wider than MAX_D (16,384: 512 threads x
// 32 registers) does not fit in the registers: it takes a block of 1,024
// threads and reads the row twice, once for the sum of squares and once
// to scale (the second read mostly from L2), at any D to int32 range.

#include "common.cuh"

#define MAX_D 16384
#define WIDE_T 1024

// TPR threads a row (32: a warp, 256 or 512: a block); VEC elements a
// load; NV loads a thread per row; R rows a warp (TPR == 32 only)
template <typename TX, typename TS, int TPR, int VEC, int NV, int R>
__global__ void __launch_bounds__(TPR == 32 ? 256 : TPR)
rmsnorm_kernel(const TX* __restrict__ x, const TS* __restrict__ scale,
               TX* __restrict__ y, long long rows, int D, float eps) {
  constexpr int ROWS_A_BLOCK = TPR == 32 ? 8 : 1;  // groups of R rows
  const int lane = threadIdx.x % TPR;
  const long long row0 =
      ((long long)blockIdx.x * ROWS_A_BLOCK + threadIdx.x / TPR) * R;
  float v[R][NV][VEC], ss[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    ss[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = (lane + i * TPR) * VEC;
      if (row0 + r < rows && c < D) {
        load_f<VEC>(x + (row0 + r) * D + c, v[r][i]);
      } else {
#pragma unroll
        for (int t = 0; t < VEC; ++t) v[r][i][t] = 0.f;
      }
#pragma unroll
      for (int t = 0; t < VEC; ++t) ss[r] += v[r][i][t] * v[r][i][t];
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) ss[r] = warp_sum(ss[r]);
  if constexpr (TPR > 32) {
    __shared__ float part[TPR / 32];
    __shared__ float total;
    if (lane % 32 == 0) part[lane / 32] = ss[0];
    __syncthreads();
    if (lane == 0) {
      float t = 0.f;
      for (int w = 0; w < TPR / 32; ++w) t += part[w];
      total = t;
    }
    __syncthreads();
    ss[0] = total;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (row0 + r >= rows) continue;
    const float inv = rsqrtf(ss[r] / (float)D + eps);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = (lane + i * TPR) * VEC;
      if (c >= D) continue;
      float sc[VEC], o[VEC];
      load_f<VEC>(scale + c, sc);
#pragma unroll
      for (int t = 0; t < VEC; ++t) o[t] = (v[r][i][t] * inv) * sc[t];
      store_f<VEC>(y + (row0 + r) * D + c, o);
    }
  }
}

// one row wider than MAX_D a block: the sum of squares in a first pass
// over the row, then the scaled row in a second; vec: four elements a
// load (D % 4 == 0 and the rows aligned)
template <typename TX, typename TS>
__global__ void __launch_bounds__(WIDE_T)
rmsnorm_wide_kernel(const TX* __restrict__ x, const TS* __restrict__ scale,
                    TX* __restrict__ y, int D, float eps, int vec) {
  const TX* xr = x + (long long)blockIdx.x * D;
  TX* yr = y + (long long)blockIdx.x * D;
  const int tid = threadIdx.x;
  float ss = 0.f;
  if (vec) {
    for (int c = 4 * tid; c < D; c += 4 * WIDE_T) {
      float v[4];
      load_f<4>(xr + c, v);
#pragma unroll
      for (int t = 0; t < 4; ++t) ss += v[t] * v[t];
    }
  } else {
    for (int c = tid; c < D; c += WIDE_T) {
      const float v = to_f(xr[c]);
      ss += v * v;
    }
  }
  __shared__ float part[WIDE_T / 32];
  __shared__ float total;
  ss = warp_sum(ss);
  if (tid % 32 == 0) part[tid / 32] = ss;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
    for (int w = 0; w < WIDE_T / 32; ++w) t += part[w];
    total = t;
  }
  __syncthreads();
  const float inv = rsqrtf(total / (float)D + eps);
  if (vec) {
    for (int c = 4 * tid; c < D; c += 4 * WIDE_T) {
      float v[4], sc[4], o[4];
      load_f<4>(xr + c, v);
      load_f<4>(scale + c, sc);
#pragma unroll
      for (int t = 0; t < 4; ++t) o[t] = (v[t] * inv) * sc[t];
      store_f<4>(yr + c, o);
    }
  } else {
    for (int c = tid; c < D; c += WIDE_T)
      yr[c] = from_f<TX>((to_f(xr[c]) * inv) * to_f(scale[c]));
  }
}

template <typename TX, typename TS, int TPR, int VEC, int NV, int R>
static void run(const void* x, const void* s, void* y, long long rows, int D,
                float eps, cudaStream_t st) {
  constexpr long long per_block = TPR == 32 ? 8 * R : 1;
  const long long blocks = (rows + per_block - 1) / per_block;
  rmsnorm_kernel<TX, TS, TPR, VEC, NV, R>
      <<<(unsigned)blocks, TPR == 32 ? 256 : TPR, 0, st>>>(
          (const TX*)x, (const TS*)s, (TX*)y, rows, D, eps);
}

template <typename TX, typename TS>
static cudaError_t launch(const void* x, const void* s, void* y,
                          long long rows, int D, float eps, int vec,
                          cudaStream_t st) {
  if (D > MAX_D) {
    rmsnorm_wide_kernel<TX, TS><<<(unsigned)rows, WIDE_T, 0, st>>>(
        (const TX*)x, (const TS*)s, (TX*)y, D, eps, vec);
    return cudaGetLastError();
  }
  if (vec) {
    if (D <= 128) run<TX, TS, 32, 4, 1, 4>(x, s, y, rows, D, eps, st);
    else if (D <= 256) run<TX, TS, 32, 4, 2, 2>(x, s, y, rows, D, eps, st);
    else if (D <= 1024) run<TX, TS, 32, 4, 8, 1>(x, s, y, rows, D, eps, st);
    else if (D <= 2048) run<TX, TS, 256, 4, 2, 1>(x, s, y, rows, D, eps, st);
    else if (D <= 4096) run<TX, TS, 256, 4, 4, 1>(x, s, y, rows, D, eps, st);
    else if (D <= 8192) run<TX, TS, 256, 4, 8, 1>(x, s, y, rows, D, eps, st);
    else run<TX, TS, 512, 4, 8, 1>(x, s, y, rows, D, eps, st);
  } else {
    if (D <= 1024) run<TX, TS, 32, 1, 32, 1>(x, s, y, rows, D, eps, st);
    else if (D <= 8192) run<TX, TS, 256, 1, 32, 1>(x, s, y, rows, D, eps, st);
    else run<TX, TS, 512, 1, 32, 1>(x, s, y, rows, D, eps, st);
  }
  return cudaGetLastError();
}

// x, y: (rows, D) contiguous; scale: (D,).  x_dt, s_dt: DT_F32, DT_BF16
// or DT_F16.  vec: x, y and scale are 16-byte aligned (D % 4 is checked
// here).  Any D >= 1 (past MAX_D the two-pass kernel).
template <typename TX>
static cudaError_t launch_x(const void* x, const void* s, void* y,
                            long long rows, int D, float eps, int s_dt,
                            int vec, cudaStream_t st) {
  if (s_dt == DT_F32) return launch<TX, float>(x, s, y, rows, D, eps, vec, st);
  if (s_dt == DT_BF16) return launch<TX, bf16>(x, s, y, rows, D, eps, vec, st);
  if (s_dt == DT_F16) return launch<TX, f16>(x, s, y, rows, D, eps, vec, st);
  return cudaErrorInvalidValue;
}

extern "C" int rmsnorm_launch(const void* x, const void* scale, void* y,
                              long long rows, int D, float eps, int x_dt,
                              int s_dt, int vec, void* stream) {
  if (rows < 1 || D < 1 || rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  vec = vec && D % 4 == 0;
  if (x_dt == DT_F32)
    return (int)launch_x<float>(x, scale, y, rows, D, eps, s_dt, vec, st);
  if (x_dt == DT_BF16)
    return (int)launch_x<bf16>(x, scale, y, rows, D, eps, s_dt, vec, st);
  if (x_dt == DT_F16)
    return (int)launch_x<f16>(x, scale, y, rows, D, eps, s_dt, vec, st);
  return (int)cudaErrorInvalidValue;
}
