// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan.py:81 (ssd_scan /
// _ssd_kernel :26).  For each sequence b, head h and chunk of c positions,
// with xw = dt * x and cs = cumsum(dt * a) over the chunk:
//
//   y     = (C B^T ⊙ tril(exp(cs_i - cs_j))) xw + (C state^T) ⊙ exp(cs)
//   state = state * exp(cs_last) + xw^T (B ⊙ exp(cs_last - cs))
//
// all in float32 from float32 or bf16 inputs; y is stored in x's dtype,
// the final state in float32.  b and c carry G groups; head h reads group
// h / (H / G), so the GQA expansion is an index, not a copy.
//
// What bounds it: operations.  Per (b, chunk) at mamba2-780m's c 256,
// P 64, N 128 the causal half of C B^T is 8.42 MFLOP for each group (the
// heads of a group share it; this kernel recomputes it per head), and per
// head the product with xw is 4.21 M, the carry-in C state^T 4.19 M and
// the state update 4.19 M: 19.2 GFLOP a call at B 2, S 4,096, H 48, G 1,
// 0.29 ms at 67 TFLOP/s of scalar float32, against 215 MB (0.064 ms at
// 3.35 TB/s) of inputs and outputs.
//
// Design.  The TPU runs the chunk axis in sequence and carries the (P, N)
// state in VMEM.  Here a CUDA grid dimension never carries state; the
// chunks run in parallel and the recurrence between them is a separate,
// cheap pass (the four stages of the model's ssd_chunked):
//  1. ssd_chunk_kernel, one block per (chunk, head, sequence): cs by a
//     warp scan; the intra-chunk y, tiled like causal attention without a
//     softmax (64-row query tiles over 64-row key tiles j <= i, the
//     (c, c) decay never held whole: at c 256 it would be 256 KB, over
//     the 227 KB a block may have); tiles above the diagonal are skipped
//     and the diagonal tile is masked before exp, since cs_i - cs_j > 0
//     there and exp could reach inf (inf * 0 is NaN); then, in a pass of
//     its own over the key tiles, the chunk's own state contribution
//     (held apart from y, so that two blocks fit an SM's registers).  y
//     goes to a float32 buffer, the chunk state to a (B, nc, H, P, N)
//     buffer, cs to a (B, H, S) buffer.
//  2. ssd_state_kernel, one thread per (sequence, head, p, n): the scan
//     over chunks, carry = carry * exp(cs_last) + chunk state, in place:
//     each chunk's slot is overwritten by the state entering it; the
//     final carry is the output state.
//  3. ssd_carry_kernel, one block per (chunk, head, sequence): y += (C
//     state_in^T) ⊙ exp(cs), and y stored in x's dtype (chunk 0 enters
//     with a zero state and is only stored).
// cs is summed and differenced in float64 (c adds a chunk): exp(cs_i -
// cs_j) from float32 cumsums loses |cs| * 2^-24 in the exponent, which at
// a strong decay (|cs| in the thousands) is an error of 1e-3 or more in
// y, as the Pallas kernel and the plain version have it; the differences
// are then rounded once to float32 for exp.
// Products are register-blocked: 256 threads each hold a 4 x 4 tile of a
// 64 x 64 product and read float4 runs of the shared operands, which are
// kept transposed ([k][row], rows padded to 68 floats).  Scalar IEEE
// float32 FMAs; tensor cores are later work.  Every long sum (over N for
// the scores and the carry-in, over the chunk's positions for y and the
// state) adds a partial sum of KB terms at a time into its running sum,
// which about halves the float32 rounding error of a sequential sum where
// the decay is weak and the state grows over the whole sequence.

#include "common.cuh"

#define TILE 64
#define LD 68            // padded row of a transposed 64-row tile
#define THREADS 256
#define MAX_P 64
#define MAX_N 128
#define MAX_CHUNK 1024
#define KB 32            // terms per partial sum

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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// dst[k * LD + r] = src row (r0 + r), column k, for r < 64 and k < K;
// rows at or past `rows` are zero.  src rows are `row_stride` apart.
template <typename T>
__device__ __forceinline__ void load_t(float* dst, const T* src,
                                       long long row_stride, int r0,
                                       int rows, int K) {
  for (int idx = threadIdx.x; idx < TILE * K; idx += THREADS) {
    const int r = idx / K, k = idx % K;
    dst[k * LD + r] = r0 + r < rows ? ld(src + (r0 + r) * row_stride + k)
                                    : 0.f;
  }
}

// dst[j * LD + p] = dt[j0 + j] * x[j0 + j][p] (xw), zero past the chunk
// or P
template <typename T>
__device__ __forceinline__ void load_xw(float* dst, const T* xb,
                                        long long row_stride,
                                        const float* dts, int j0, int chunk,
                                        int P) {
  for (int idx = threadIdx.x; idx < TILE * TILE; idx += THREADS) {
    const int j = idx / TILE, p = idx % TILE;
    dst[j * LD + p] = (j0 + j < chunk && p < P)
                          ? ld(xb + (j0 + j) * row_stride + p) * dts[j0 + j]
                          : 0.f;
  }
}

template <typename T, typename TD>
__global__ void __launch_bounds__(THREADS, 2)
ssd_chunk_kernel(const T* __restrict__ x, const TD* __restrict__ dt,
                 const float* __restrict__ a, const T* __restrict__ bm,
                 const T* __restrict__ cm, Strides xs, Strides ds,
                 Strides bs, Strides cst, int S, int H, int G, int P, int N,
                 int chunk, float* __restrict__ yf, float* __restrict__ cs_out,
                 float* __restrict__ st_out) {
  const int z = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int nc = S / chunk;
  const int g = h / (H / G);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  extern __shared__ float sm[];
  float* Ct = sm;                    // (N, LD): C tile, [n][i]
  float* Bt = Ct + N * LD;           // (N, LD): B tile, [n][j]
  float* Xs = Bt + N * LD;           // (64, LD): xw tile, [j][p]
  float* St = Xs + TILE * LD;        // (64, LD): masked scores, [j][i]
  double* cs = reinterpret_cast<double*>(St + TILE * LD);  // (chunk): cumsum
  float* dts = reinterpret_cast<float*>(cs + chunk);       // (chunk): dt
  float* dec = dts + chunk;                                // exp(cs_last - cs)

  const long long s0 = (long long)z * chunk;
  const T* xb = x + bi * xs.b + s0 * xs.s + (long long)h * xs.h;
  const T* bb = bm + bi * bs.b + s0 * bs.s + (long long)g * bs.h;
  const T* cb = cm + bi * cst.b + s0 * cst.s + (long long)g * cst.h;
  const TD* db = dt + bi * ds.b + s0 * ds.s + (long long)h * ds.h;
  const float ah = a[h];
  for (int i = tid; i < chunk; i += THREADS) {
    const float d = ld(db + i * ds.s);
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
      const double t = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += t;
    }
    double excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (tid == 0) excl = 0.0;
    for (int k = lo; k < hi; ++k) cs[k] += excl;
  }
  __syncthreads();
  const double cs_last = cs[chunk - 1];
  float* cso = cs_out + ((long long)bi * H + h) * S + s0;
  for (int i = tid; i < chunk; i += THREADS) {
    cso[i] = (float)cs[i];
    dec[i] = expf((float)(cs_last - cs[i]));
  }

  const int nt = (chunk + TILE - 1) / TILE;
  for (int it = 0; it < nt; ++it) {
    const int i0 = it * TILE;
    __syncthreads();
    load_t(Ct, cb, cst.s, i0, chunk, N);
    float yacc[4][4];        // y: i = i0 + ty*4 + r, p = tx*4 + q
    zero(yacc);
    for (int jt = 0; jt <= it; ++jt) {     // key tiles j <= i only
      const int j0 = jt * TILE;
      __syncthreads();
      load_t(Bt, bb, bs.s, j0, chunk, N);
      load_xw(Xs, xb, xs.s, dts, j0, chunk, P);
      __syncthreads();
      {
        // scores: s[r][q] = C_i . B_j, i = ty*4 + r, j = tx*4 + q
        float s[4][4];
        zero(s);
        for (int n0 = 0; n0 < N; n0 += KB) {
          float t[4][4];
          zero(t);
          for (int n = n0; n < min(n0 + KB, N); ++n) {
            const float4 cv = ld4(Ct + n * LD + ty * 4);
            const float4 bv = ld4(Bt + n * LD + tx * 4);
            const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
            const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int q = 0; q < 4; ++q)
                t[r][q] = fmaf(c4[r], b4[q], t[r][q]);
          }
          add_into(s, t);
        }
        // decay, masked before exp: only j <= i inside the chunk
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = j0 + tx * 4 + q;
          float o[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = i0 + ty * 4 + r;
            o[r] = (j <= i && i < chunk)
                       ? s[r][q] * expf((float)(cs[i] - cs[j]))
                       : 0.f;
          }
          *reinterpret_cast<float4*>(St + (tx * 4 + q) * LD + ty * 4) =
              make_float4(o[0], o[1], o[2], o[3]);
        }
        __syncthreads();
        for (int j0k = 0; j0k < TILE; j0k += KB) {
          float t[4][4];
          zero(t);
          for (int j = j0k; j < j0k + KB; ++j) {
            const float4 sv = ld4(St + j * LD + ty * 4);
            const float4 xv = ld4(Xs + j * LD + tx * 4);
            const float s4[4] = {sv.x, sv.y, sv.z, sv.w};
            const float x4[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int q = 0; q < 4; ++q)
                t[r][q] = fmaf(s4[r], x4[q], t[r][q]);
          }
          add_into(yacc, t);
        }
      }
    }
    float* yo = yf + ((long long)bi * S + s0) * H * P + (long long)h * P;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty * 4 + r;
      if (i >= chunk) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = tx * 4 + q;
        if (p < P) yo[(long long)i * H * P + p] = yacc[r][q];
      }
    }
  }

  // the chunk's own state, st[p][n] = sum_j xw[j][p] dec[j] B[j][n], in a
  // pass of its own over the key tiles, last first (it is still loaded),
  // so that the state's registers are never live beside y's
  float st[4][8];            // p = ty*4 + r, n = tx + 16*q
  zero(st);
  for (int jt = nt - 1; jt >= 0; --jt) {
    const int j0 = jt * TILE;
    if (jt != nt - 1) {
      __syncthreads();
      load_t(Bt, bb, bs.s, j0, chunk, N);
      load_xw(Xs, xb, xs.s, dts, j0, chunk, P);
      __syncthreads();
    }
    for (int j0k = 0; j0k < TILE && j0 + j0k < chunk; j0k += KB) {
      float t[4][8];
      zero(t);
      for (int j = j0k; j < j0k + KB && j0 + j < chunk; ++j) {
        const float w = dec[j0 + j];
        const float4 xv = ld4(Xs + j * LD + ty * 4);
        const float x4[4] = {xv.x * w, xv.y * w, xv.z * w, xv.w * w};
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int n = tx + 16 * q;
          if (n < N) {
            const float bv = Bt[n * LD + j];
#pragma unroll
            for (int r = 0; r < 4; ++r) t[r][q] = fmaf(x4[r], bv, t[r][q]);
          }
        }
      }
      add_into(st, t);
    }
  }
  float* so = st_out + (((long long)bi * nc + z) * H + h) * P * N;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = ty * 4 + r;
    if (p >= P) continue;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int n = tx + 16 * q;
      if (n < N) so[p * N + n] = st[r][q];
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_carry_kernel(const T* __restrict__ cm, Strides cst, const float* st,
                 const float* __restrict__ cs, const float* yf, T* y, int S,
                 int H, int G, int P, int N, int chunk) {
  const int z = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int nc = S / chunk;
  const int g = h / (H / G);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long s0 = (long long)z * chunk;
  const long long row = (long long)H * P;
  const float* yfb = yf + ((long long)bi * S + s0) * row + (long long)h * P;
  T* yb = y + ((long long)bi * S + s0) * row + (long long)h * P;
  if (z == 0) {              // a zero state enters the first chunk
    if ((const void*)yf != (const void*)y)
      for (int idx = tid; idx < chunk * P; idx += THREADS) {
        const int i = idx / P, p = idx % P;
        yb[i * row + p] = from_f<T>(yfb[i * row + p]);
      }
    return;
  }
  extern __shared__ float sm[];
  float* Ct = sm;                    // (N, LD): C tile, [n][i]
  float* Pt = Ct + N * LD;           // (N, LD): entering state, [n][p]
  const float* sb = st + (((long long)bi * nc + z) * H + h) * P * N;
  for (int idx = tid; idx < TILE * N; idx += THREADS) {
    const int p = idx / N, n = idx % N;
    Pt[n * LD + p] = p < P ? sb[p * N + n] : 0.f;
  }
  const float* csb = cs + ((long long)bi * H + h) * S + s0;
  const T* cb = cm + bi * cst.b + s0 * cst.s + (long long)g * cst.h;
  for (int i0 = 0; i0 < chunk; i0 += TILE) {
    __syncthreads();
    load_t(Ct, cb, cst.s, i0, chunk, N);
    __syncthreads();
    float acc[4][4];         // i = i0 + ty*4 + r, p = tx*4 + q
    zero(acc);
    for (int n0 = 0; n0 < N; n0 += KB) {
      float t[4][4];
      zero(t);
      for (int n = n0; n < min(n0 + KB, N); ++n) {
        const float4 cv = ld4(Ct + n * LD + ty * 4);
        const float4 pv = ld4(Pt + n * LD + tx * 4);
        const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
        const float p4[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) t[r][q] = fmaf(c4[r], p4[q], t[r][q]);
      }
      add_into(acc, t);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty * 4 + r;
      if (i >= chunk) continue;
      const float e = expf(csb[i]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = tx * 4 + q;
        if (p < P)
          yb[i * row + p] = from_f<T>(yfb[i * row + p] + acc[r][q] * e);
      }
    }
  }
}

static size_t chunk_smem(int N, int chunk) {
  return sizeof(float) * ((size_t)2 * N * LD + 2 * TILE * LD + 2 * chunk) +
         sizeof(double) * chunk;
}

static size_t carry_smem(int N) { return sizeof(float) * (size_t)2 * N * LD; }

template <typename T, typename TD>
static cudaError_t run(const void* x, const void* dt, const float* a,
                       const void* b, const void* c, Strides xs, Strides ds,
                       Strides bs, Strides cst, int B, int S, int H, int G,
                       int P, int N, int chunk, void* y, float* yf,
                       float* cs, float* st, float* fin, cudaStream_t stream) {
  const int nc = S / chunk;
  const size_t sm1 = chunk_smem(N, chunk), sm3 = carry_smem(N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T, TD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sm1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_carry_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sm3);
  if (err != cudaSuccess) return err;
  const dim3 blocks(nc, H, B);
  ssd_chunk_kernel<T, TD><<<blocks, THREADS, sm1, stream>>>(
      (const T*)x, (const TD*)dt, a, (const T*)b, (const T*)c, xs, ds, bs,
      cst, S, H, G, P, N, chunk, yf, cs, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_state_kernel<<<dim3((P * N + THREADS - 1) / THREADS, H, B), THREADS, 0,
                     stream>>>(st, cs, fin, S, H, P * N, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_carry_kernel<T><<<blocks, THREADS, sm3, stream>>>(
      (const T*)c, cst, st, cs, yf, (T*)y, S, H, G, P, N, chunk);
  return cudaGetLastError();
}

// x (B, S, H, P), dt (B, S, H), b and c (B, S, G, N): unit stride on the
// last axis, the other strides (in elements) given; a (H,) float32.
// x, b and c share x_dt; dt has dt_dt (DT_F32 or DT_BF16).  y (B, S, H,
// P) contiguous in x's dtype; yf a float32 (B, S, H, P) buffer (y itself
// when x is float32); cs (B, H, S) and st (B, S / chunk, H, P, N) float32
// scratch; fin (B, H, P, N) float32, the final state.
extern "C" int ssd_scan_launch(
    const void* x, const void* dt, const void* a, const void* b,
    const void* c, long long xsb, long long xss, long long xsh,
    long long dsb, long long dss, long long dsh, long long bsb,
    long long bss, long long bsg, long long csb, long long css,
    long long csg, int B, int S, int H, int G, int P, int N, int chunk,
    int x_dt, int dt_dt, void* y, void* yf, void* cs, void* st, void* fin,
    void* stream) {
  if (B < 1 || S < 1 || H < 1 || G < 1 || H % G || P < 1 || P > MAX_P ||
      N < 1 || N > MAX_N || chunk < 1 || chunk > MAX_CHUNK || S % chunk ||
      H > 65535 || B > 65535 || S / chunk > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (x_dt == DT_BF16 && yf == y) return (int)cudaErrorInvalidValue;
  const Strides xs{xsb, xss, xsh}, ds{dsb, dss, dsh}, bs{bsb, bss, bsg},
      cst{csb, css, csg};
  cudaStream_t s = (cudaStream_t)stream;
  const float* af = (const float*)a;
  float *yff = (float*)yf, *csf = (float*)cs, *stf = (float*)st,
        *ff = (float*)fin;
#define RUN(T, TD)                                                        \
  return (int)run<T, TD>(x, dt, af, b, c, xs, ds, bs, cst, B, S, H, G, P, \
                         N, chunk, y, yff, csf, stf, ff, s)
  if (x_dt == DT_F32 && dt_dt == DT_F32) RUN(float, float);
  if (x_dt == DT_F32 && dt_dt == DT_BF16) RUN(float, bf16);
  if (x_dt == DT_BF16 && dt_dt == DT_F32) RUN(bf16, float);
  if (x_dt == DT_BF16 && dt_dt == DT_BF16) RUN(bf16, bf16);
#undef RUN
  return (int)cudaErrorInvalidValue;
}
