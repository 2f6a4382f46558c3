// Decode attention (one query token per sequence) for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/decode_attention.py:103
// (decode_attention / _decode_kernel :27): q (B, H, d) against K/V caches
// in the model layout (B, K, KV, d), GQA group g = H / KV per KV head;
// cache position p counts for sequence b when
//
//   p < length  and  (window <= 0 or length - 1 - p < window)
//
// softmax over those positions in float32 with the kernel's finite
// -1e30 mask and its max(l, 1e-30) denominator, so that length 0 gives
// zeros.  length and window are read from device memory when the caller
// passes 0-d int32 tensors (no host synchronisation, as the TPU kernel's
// scalar prefetch), or taken by value from Python ints.
//
// What bounds it: bytes.  Every valid K and V row is read once: at
// llama3.2-3b (B 8, KV 8, d 128, bf16, length 6,000) that is 197 MB,
// 0.059 ms at 3.35 TB/s, against 1.2 flops per byte.
//
// Design (FlashDecoding): the cache axis is cut into splits of `split`
// positions; one block of four warps per (split, KV head, sequence).  A
// split that lies wholly at or beyond `length`, or wholly older than
// `window`, does no loads at all: the bytes read are the valid rows only.
// Each warp walks its positions four at a time and requests the four K
// rows and the four V rows of a step before it uses any, so that eight
// row loads are in flight a warp: the kernel lives on memory-level
// parallelism, not on arithmetic.  A lane holds d / 32 elements of a row,
// so a warp reads each row with one coalesced load, once for the whole
// GQA group (the group's query rows and accumulators stay in registers,
// sized by the group rounded up to 1, 2, 4 or 8, which keeps the register
// count, and so the number of warps an SM holds, as the group allows).
// Scores are warp all-reduces; each warp keeps float32 running max / sum
// / accumulator, the four warps are merged through shared memory, and the
// block writes one partial (m, l, acc) per query head.  A second kernel combines the partials of a query head by
// log-sum-exp, divides and stores in q's dtype.  The caches are read
// through their strides, so the model layout is never transposed.

#include "common.cuh"

#define MAX_G 8
#define NW 4  // warps a block
#define U 4   // positions a warp takes per step

// G: the group size rounded up to 1, 2, 4 or 8 (g <= G query heads per
// KV head are live; the registers are sized by G)
template <typename T, int EPL, int G>
__global__ void __launch_bounds__(NW * 32)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                      const T* __restrict__ vc, long long kb, long long kp,
                      long long kn, long long vb, long long vp, long long vn,
                      int H, int K, int g, int split, int nsplit,
                      const int* len_dev, int len_host, const int* win_dev,
                      int win_host, float scale, float* __restrict__ part_acc,
                      float* __restrict__ part_ml) {
  constexpr int DH = 32 * EPL;
  const int sp = blockIdx.x, n = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int length = len_dev ? *len_dev : len_host;
  const int window = win_dev ? *win_dev : win_host;
  int lo = sp * split;
  const int hi = min(min(lo + split, K), length);
  if (window > 0) lo = max(lo, length - window);

  float qf[G][EPL], acc[G][EPL], m[G], l[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    m[j] = NEG_INF;
    l[j] = 0.f;
#pragma unroll
    for (int t = 0; t < EPL; ++t) acc[j][t] = qf[j][t] = 0.f;
    if (j < g) {
      load_f<EPL>(q + ((long long)b * H + n * g + j) * DH + lane * EPL, qf[j]);
#pragma unroll
      for (int t = 0; t < EPL; ++t) qf[j][t] *= scale;
    }
  }

  const T* kbase = kc + b * kb + n * kn + lane * EPL;
  const T* vbase = vc + b * vb + n * vn + lane * EPL;
  for (int p0 = lo + warp * U; p0 < hi; p0 += NW * U) {
    // every K and V row of the step is requested before any is used
    float kr[U][EPL], vr[U][EPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (p0 + u < hi) {
        load_f<EPL>(kbase + (long long)(p0 + u) * kp, kr[u]);
        load_f<EPL>(vbase + (long long)(p0 + u) * vp, vr[u]);
      } else {
#pragma unroll
        for (int t = 0; t < EPL; ++t) kr[u][t] = vr[u][t] = 0.f;
      }
    }
    float s[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < G; ++j) {
        float d = 0.f;
#pragma unroll
        for (int t = 0; t < EPL; ++t) d = fmaf(qf[j][t], kr[u][t], d);
        s[u][j] = warp_sum(d);
      }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      float mt = s[0][j];  // p0 < hi: position 0 of the step is valid
#pragma unroll
      for (int u = 1; u < U; ++u)
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

  // merge the four warps' states, then one partial per query head
  __shared__ float sm_m[NW][G], sm_l[NW][G];
  __shared__ float sm_acc[NW][G][DH];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (lane == 0) {
      sm_m[warp][j] = m[j];
      sm_l[warp][j] = l[j];
    }
#pragma unroll
    for (int t = 0; t < EPL; ++t) sm_acc[warp][j][lane * EPL + t] = acc[j][t];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < g * DH; idx += NW * 32) {
    const int j = idx / DH, c = idx % DH;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, sm_m[w][j]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(sm_m[w][j] - M);
      L += sm_l[w][j] * f;
      A += sm_acc[w][j][c] * f;
    }
    const long long head = ((long long)b * H + n * g + j) * nsplit + sp;
    part_acc[head * DH + c] = A;
    if (c == 0) {
      part_ml[head * 2] = M;
      part_ml[head * 2 + 1] = L;
    }
  }
}

template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_ml,
                                      T* __restrict__ out, int nsplit,
                                      int dh) {
  const long long bh = blockIdx.x;
  const int c = threadIdx.x;
  const float* ml = part_ml + bh * nsplit * 2;
  const float* pa = part_acc + bh * nsplit * dh + c;
  float M = NEG_INF;
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, ml[2 * s]);
  float L = 0.f, A = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const float f = expf(ml[2 * s] - M);
    L += ml[2 * s + 1] * f;
    A += pa[(long long)s * dh] * f;
  }
  out[bh * dh + c] = from_f<T>(A / fmaxf(L, 1e-30f));
}

template <typename T, int EPL, int G>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          const long long* ks, const long long* vs, int B,
                          int H, int KV, int K, int split, const int* len_dev,
                          int len_host, const int* win_dev, int win_host,
                          float scale, float* part_acc, float* part_ml,
                          void* out, cudaStream_t st) {
  const int nsplit = (K + split - 1) / split;
  const dim3 grid(nsplit, KV, B);
  decode_partial_kernel<T, EPL, G><<<grid, NW * 32, 0, st>>>(
      (const T*)q, (const T*)k, (const T*)v, ks[0], ks[1], ks[2], vs[0],
      vs[1], vs[2], H, K, H / KV, split, nsplit, len_dev, len_host, win_dev,
      win_host, scale, part_acc, part_ml);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<B * H, 32 * EPL, 0, st>>>(part_acc, part_ml,
                                                     (T*)out, nsplit, 32 * EPL);
  return cudaGetLastError();
}

// q (B, H, dh) contiguous; k, v (B, K, KV, dh) with unit stride on dh and
// element strides ks/vs = {batch, position, head}; out (B, H, dh).
// part_acc: B * H * nsplit * dh floats, part_ml: B * H * nsplit * 2, with
// nsplit = ceil(K / split).  len_dev / win_dev: device int32 or NULL (then
// len_host / win_host).  dh in {64, 128, 256}; H / KV <= 8.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, long long kb, long long kp,
    long long kn, long long vb, long long vp, long long vn, int B, int H,
    int KV, int K, int dh, int split, const int* len_dev, int len_host,
    const int* win_dev, int win_host, float scale, float* part_acc,
    float* part_ml, void* out, int dt, void* stream) {
  if (B < 1 || KV < 1 || K < 1 || split < 1 || H % KV != 0 ||
      H / KV > MAX_G || B > 65535 || KV > 65535)
    return (int)cudaErrorInvalidValue;
  const long long ks[3] = {kb, kp, kn}, vs[3] = {vb, vp, vn};
  cudaStream_t st = (cudaStream_t)stream;
  const int g = H / KV;
  const int G = g <= 1 ? 1 : g <= 2 ? 2 : g <= 4 ? 4 : 8;
#define DEC_CASE(TT, E, GG)                                                  \
  return (int)launch<TT, E, GG>(q, k, v, ks, vs, B, H, KV, K, split,         \
                                len_dev, len_host, win_dev, win_host, scale, \
                                part_acc, part_ml, out, st)
#define DEC_GROUPS(TT, E)            \
  switch (G) {                       \
    case 1: DEC_CASE(TT, E, 1);      \
    case 2: DEC_CASE(TT, E, 2);      \
    case 4: DEC_CASE(TT, E, 4);      \
    default: DEC_CASE(TT, E, 8);     \
  }
  if (dt == DT_F32) {
    switch (dh) {
      case 64: DEC_GROUPS(float, 2);
      case 128: DEC_GROUPS(float, 4);
      case 256: DEC_GROUPS(float, 8);
    }
  } else if (dt == DT_BF16) {
    switch (dh) {
      case 64: DEC_GROUPS(bf16, 2);
      case 128: DEC_GROUPS(bf16, 4);
      case 256: DEC_GROUPS(bf16, 8);
    }
  }
#undef DEC_GROUPS
#undef DEC_CASE
  return (int)cudaErrorInvalidValue;
}
