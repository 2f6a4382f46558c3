// Helpers shared by the model kernels (rmsnorm, grouped_matmul,
// decode_attention, flash_attention): the dtype codes the C entry points
// take, float <-> storage conversions, and vector loads that widen a run
// of elements to float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes passed by the Python wrappers
#define DT_F32 0
#define DT_BF16 1

// the Pallas kernels' finite mask value
#define NEG_INF (-1e30f)

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
// round to nearest even, as JAX's .astype(bfloat16)
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// two bf16 packed in one 32-bit word -> two floats (exact)
__device__ __forceinline__ void bf16x2_to_f(uint32_t w, float* o) {
  o[0] = __uint_as_float(w << 16);
  o[1] = __uint_as_float(w & 0xffff0000u);
}

// N consecutive elements starting at p, widened to float.  p must be
// aligned to the vector width used: 16 bytes when N * sizeof(T) is a
// multiple of 16, else 8, else 4 (the wrappers check the alignment).
template <int N>
__device__ __forceinline__ void load_f(const float* p, float* o) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      o[i] = v.x; o[i + 1] = v.y; o[i + 2] = v.z; o[i + 3] = v.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + i);
      o[i] = v.x; o[i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = p[i];
  }
}

template <int N>
__device__ __forceinline__ void load_f(const bf16* p, float* o) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + i);
      bf16x2_to_f(v.x, o + i); bf16x2_to_f(v.y, o + i + 2);
      bf16x2_to_f(v.z, o + i + 4); bf16x2_to_f(v.w, o + i + 6);
    }
  } else if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const uint2 v = *reinterpret_cast<const uint2*>(p + i);
      bf16x2_to_f(v.x, o + i); bf16x2_to_f(v.y, o + i + 2);
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2)
      bf16x2_to_f(*reinterpret_cast<const uint32_t*>(p + i), o + i);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = to_f(p[i]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// N floats stored as N consecutive elements at p, with the alignment
// load_f asks for
template <int N>
__device__ __forceinline__ void store_f(float* p, const float* v) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = v[i];
  }
}

template <int N>
__device__ __forceinline__ void store_f(bf16* p, const float* v) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const __nv_bfloat162 a = __floats2bfloat162_rn(v[i], v[i + 1]);
      const __nv_bfloat162 b = __floats2bfloat162_rn(v[i + 2], v[i + 3]);
      uint2 w;
      w.x = *reinterpret_cast<const uint32_t*>(&a);
      w.y = *reinterpret_cast<const uint32_t*>(&b);
      *reinterpret_cast<uint2*>(p + i) = w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = __float2bfloat16_rn(v[i]);
  }
}
