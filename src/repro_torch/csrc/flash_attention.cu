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
// out in q's dtype (round to nearest even for bf16).
//
// What bounds it: operations.  At llama3.2-3b's prefill (B 2, S 4,096,
// H 24, d 128, causal) the unmasked half of Q K^T and P V is 2.06e11
// flops against 0.2 GB moved: 0.208 ms at 989 TFLOP/s (bf16).  At
// gemma3-4b's d = 256 a thread cannot hold a query row and its
// accumulator in registers.
//
// Design: one block of 256 threads per (64-row query tile, head,
// sequence); the loop over key tiles inside the block replaces the TPU's
// sequential grid dimension.  The query tile (pre-scaled, float32), a key
// tile and a value tile sit in shared memory (64 keys a tile for
// d <= 128, 32 for d = 256; 66-140 KB, so the entry point raises the
// block's dynamic shared-memory limit).  Per key tile: S = Q K^T with
// 4 x 4 scores a thread, the online softmax with four threads a row
// (shuffles within the four), then acc += P V with 4 rows x d/16 columns
// a thread, so the float32 accumulator is spread over the block and never
// spills.  Key tiles that the causal or window mask covers wholly are not
// visited, as _flash_kernel skips them (:41-47); ragged S is masked.
// Arithmetic is scalar float32 FMA; tensor cores (mma / wgmma) and TMA
// are later work.  The inputs are read through their strides, so the
// model layout (B, S, H, d) is never transposed.

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
// widened to float and multiplied by mul; rows past S are zeros
template <typename T, int DH, int R, int P>
__device__ __forceinline__ void load_tile(float (*dst)[P], const T* src,
                                          long long ss, int r0, int S,
                                          float mul) {
  for (int idx = threadIdx.x; idx < R * DH / 4; idx += NT) {
    const int r = idx / (DH / 4), c = (idx % (DH / 4)) * 4;
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < S) load_f<4>(src + (long long)(r0 + r) * ss + c, t);
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[r][c + i] = t[i] * mul;
  }
}

template <typename T, int DH, int BKT>
__global__ void __launch_bounds__(NT)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, const Strides st,
             int S, int causal, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<DH, BKT>& sm = *reinterpret_cast<Smem<DH, BKT>*>(smem_raw);
  // heaviest causal tiles first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* qp = q + b * st.v[0] + h * st.v[2];
  const T* kp = k + b * st.v[3] + h * st.v[5];
  const T* vp = v + b * st.v[6] + h * st.v[8];
  T* op = o + b * st.v[9] + h * st.v[11];

  load_tile<T, DH, BQ, DH + 1>(sm.q, qp, st.v[1], q0, S, scale);
  if (tid < BQ) {
    sm.m[tid] = NEG_INF;
    sm.l[tid] = 0.f;
  }
  constexpr int CW = DH / 16;  // accumulator columns a thread
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
    load_tile<T, DH, BKT, DH + 1>(sm.k, kp, st.v[4], k0, S, 1.f);
    load_tile<T, DH, BKT, DH>(sm.v, vp, st.v[7], k0, S, 1.f);
    __syncthreads();

    // S = Q K^T: rows ty + 16 i, keys tx + 16 j
    constexpr int KJ = BKT / 16;
    float s[4][KJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < DH; ++c) {
      float a[4], kk[KJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sm.q[ty + 16 * i][c];
#pragma unroll
      for (int j = 0; j < KJ; ++j) kk[j] = sm.k[tx + 16 * j][c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
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

    // acc = acc * alpha + P V: rows ty + 16 i, columns tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = sm.a[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < CW; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int c = 0; c < BKT; ++c) {
      float p[4], vv[CW];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sm.s[ty + 16 * i][c];
#pragma unroll
      for (int j = 0; j < CW; ++j) vv[j] = sm.v[c][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CW; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= S) continue;
    const float denom = fmaxf(sm.l[r], 1e-30f);
    T* orow = op + (long long)(q0 + r) * st.v[10];
#pragma unroll
    for (int j = 0; j < CW; ++j)
      orow[tx + 16 * j] = from_f<T>(acc[i][j] / denom);
  }
}

template <typename T, int DH, int BKT>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          void* o, const Strides& strides, int B, int S,
                          int H, int causal, int window, float scale,
                          cudaStream_t st) {
  const size_t bytes = sizeof(Smem<DH, BKT>);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DH, BKT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_kernel<T, DH, BKT><<<grid, NT, bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, strides, S, causal,
      window, scale);
  return cudaGetLastError();
}

// q, k, v, o: (B, S, H, dh) with unit stride on dh; strides: a host
// array of 12 int64, the {batch, seq, head} element strides of q, k, v and
// o in that order.  dh in {32, 64, 128, 256}.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const long long* strides, int B, int S,
                                      int H, int dh, int causal, int window,
                                      float scale, int dt, void* stream) {
  if (B < 1 || S < 1 || H < 1 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Strides sv;
  for (int i = 0; i < 12; ++i) sv.v[i] = strides[i];
#define FA_CASE(TT, D, BKT)                                                 \
  return (int)launch<TT, D, BKT>(q, k, v, o, sv, B, S, H, causal,            \
                                 window, scale, st)
  if (dt == DT_F32) {
    switch (dh) {
      case 32: FA_CASE(float, 32, 64);
      case 64: FA_CASE(float, 64, 64);
      case 128: FA_CASE(float, 128, 64);
      case 256: FA_CASE(float, 256, 32);
    }
  } else if (dt == DT_BF16) {
    switch (dh) {
      case 32: FA_CASE(bf16, 32, 64);
      case 64: FA_CASE(bf16, 64, 64);
      case 128: FA_CASE(bf16, 128, 64);
      case 256: FA_CASE(bf16, 256, 32);
    }
  }
#undef FA_CASE
  return (int)cudaErrorInvalidValue;
}
