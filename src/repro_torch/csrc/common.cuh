// Helpers shared by the model kernels (rmsnorm, grouped_matmul,
// decode_attention, flash_attention, ssd_scan): the dtype codes the C
// entry points take, float <-> storage conversions, vector loads that
// widen a run of elements to float32, and the PTX wrappers of the
// tensor-core kernels (mma.sync in bf16 / fp16 and in split TF32,
// ldmatrix, cp.async) with the 16-bit packing and TF32 splitting they
// feed on.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// dtype codes passed by the Python wrappers
#define DT_F32 0
#define DT_BF16 1
#define DT_F16 2

// the Pallas kernels' finite mask value
#define NEG_INF (-1e30f)

typedef __nv_bfloat16 bf16;
typedef __half f16;

// whether T is one of the two 16-bit storage types (bf16, fp16)
template <typename T>
constexpr bool is_b16 =
    std::is_same<T, bf16>::value || std::is_same<T, f16>::value;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(f16 v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
// round to nearest even, as JAX's .astype(bfloat16)
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
// round to nearest even, as JAX's .astype(float16)
template <>
__device__ __forceinline__ f16 from_f<f16>(float v) {
  return __float2half_rn(v);
}

// two bf16 packed in one 32-bit word -> two floats (exact)
__device__ __forceinline__ void bf16x2_to_f(uint32_t w, float* o) {
  o[0] = __uint_as_float(w << 16);
  o[1] = __uint_as_float(w & 0xffff0000u);
}

// two 16-bit values of type T packed in one word (low half first) -> two
// floats (exact)
template <typename T>
__device__ __forceinline__ void b16x2_to_f(uint32_t w, float* o) {
  if constexpr (std::is_same<T, bf16>::value) {
    bf16x2_to_f(w, o);
  } else {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w));
    o[0] = f.x;
    o[1] = f.y;
  }
}

// a float pair -> two T in one word (low half = x), rounded to nearest
// even
template <typename T>
__device__ __forceinline__ uint32_t pack2(float x, float y) {
  if constexpr (std::is_same<T, bf16>::value) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    return *reinterpret_cast<const uint32_t*>(&h);
  } else {
    const __half2 h = __floats2half2_rn(x, y);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
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

template <int N, typename T>
__device__ __forceinline__ void load_b16(const T* p, float* o) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + i);
      b16x2_to_f<T>(v.x, o + i); b16x2_to_f<T>(v.y, o + i + 2);
      b16x2_to_f<T>(v.z, o + i + 4); b16x2_to_f<T>(v.w, o + i + 6);
    }
  } else if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const uint2 v = *reinterpret_cast<const uint2*>(p + i);
      b16x2_to_f<T>(v.x, o + i); b16x2_to_f<T>(v.y, o + i + 2);
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2)
      b16x2_to_f<T>(*reinterpret_cast<const uint32_t*>(p + i), o + i);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = to_f(p[i]);
  }
}

template <int N>
__device__ __forceinline__ void load_f(const bf16* p, float* o) {
  load_b16<N>(p, o);
}
template <int N>
__device__ __forceinline__ void load_f(const f16* p, float* o) {
  load_b16<N>(p, o);
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

template <int N, typename T>
__device__ __forceinline__ void store_b16(T* p, const float* v) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      uint2 w;
      w.x = pack2<T>(v[i], v[i + 1]);
      w.y = pack2<T>(v[i + 2], v[i + 3]);
      *reinterpret_cast<uint2*>(p + i) = w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = from_f<T>(v[i]);
  }
}
template <int N>
__device__ __forceinline__ void store_f(bf16* p, const float* v) {
  store_b16<N>(p, v);
}
template <int N>
__device__ __forceinline__ void store_f(f16* p, const float* v) {
  store_b16<N>(p, v);
}

// ---------------------------------------------------------------------------
// tensor cores and asynchronous copies (sm_80 and later)
// ---------------------------------------------------------------------------

// c += a b on the tensor cores: a 16 x 16 bf16 A fragment (row-major), a
// 16 x 8 bf16 B fragment (column-major), a 16 x 8 float32 accumulator.
// Thread (group g = lane / 4, t = lane % 4) holds A rows g and g + 8,
// columns 2t, 2t + 1 (a[0], a[1]) and 2t + 8, 2t + 9 (a[2], a[3]); B
// rows 2t, 2t + 1 (b[0]) and 2t + 8, 2t + 9 (b[1]) of column g; C rows g
// (c[0], c[1]) and g + 8 (c[2], c[3]), columns 2t, 2t + 1.  Each product
// of two bf16 is exact in float32.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the same product with fp16 operands (each product of two fp16 is exact
// in float32 too)
__device__ __forceinline__ void mma_f16(float* c, const uint32_t* a,
                                        const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// mma_bf16 or mma_f16 by the operands' 16-bit type T
template <typename T>
__device__ __forceinline__ void mma16(float* c, const uint32_t* a,
                                      const uint32_t* b) {
  if constexpr (std::is_same<T, bf16>::value) {
    mma_bf16(c, a, b);
  } else {
    mma_f16(c, a, b);
  }
}

// c += a b on the tensor cores in TF32: a 16 x 8 A fragment (row-major),
// an 8 x 8 B fragment (column-major), a 16 x 8 float32 accumulator.
// Thread (g = lane / 4, t = lane % 4) holds A at (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4); B at (t, g), (t + 4, g); C at (g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).  The operands are float32
// bit patterns already rounded to TF32 (tf32_rna); the tensor core reads
// 10 bits of mantissa and ignores the rest.
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// v rounded to TF32 (11 significant bits), to nearest, ties away
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v as two TF32 terms, hi = tf32(v) and lo = tf32(v - hi): hi + lo
// carries 22 of float32's 24 bits (v - hi is exact)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// c += a b with float32-accurate operands from three TF32 products, the
// small terms first: a_lo b_hi + a_hi b_lo, then a_hi b_hi (a_lo b_lo,
// below float32's rounding, is dropped).  An operand that is exact in
// TF32 (a bf16 value: 8 significant bits) has lo = 0 and skips its
// term, so two bf16 operands take one product.
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma_tf32x3(float* c, const uint32_t* ah,
                                           const uint32_t* al,
                                           const uint32_t* bh,
                                           const uint32_t* bl) {
  if constexpr (!A_EXACT) mma_tf32(c, al, bh);
  if constexpr (!B_EXACT) mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// float32 pair -> two bf16 (low half = x), rounded to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// a float32 pair as two bf16 terms, hi = bf16(x) and lo = bf16(x - hi):
// the A operand of a product whose float32 factor one bf16 cannot carry
__device__ __forceinline__ void pack_bf16_hi_lo(float x, float y,
                                                uint32_t& hi, uint32_t& lo) {
  float hf[2];
  hi = pack_bf16(x, y);
  bf16x2_to_f(hi, hf);  // exact: float(hi)
  lo = pack_bf16(x - hf[0], y - hf[1]);
}

// the same split in the 16-bit type T: hi = T(x), lo = T(x - hi)
template <typename T>
__device__ __forceinline__ void pack2_hi_lo(float x, float y, uint32_t& hi,
                                            uint32_t& lo) {
  if constexpr (std::is_same<T, bf16>::value) {
    pack_bf16_hi_lo(x, y, hi, lo);
  } else {
    float hf[2];
    hi = pack2<T>(x, y);
    b16x2_to_f<T>(hi, hf);  // exact: float(hi)
    lo = pack2<T>(x - hf[0], y - hf[1]);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 b16 matrices from shared memory: lanes 8i .. 8i + 7 give the
// addresses of matrix i's rows (16 bytes each); r[i] holds matrix i, lane
// l its row l / 4, elements 2 (l % 4) and 2 (l % 4) + 1
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// the same, each matrix transposed: lane l holds rows 2 (l % 4) and
// 2 (l % 4) + 1 of column l / 4
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// 16 bytes global -> shared without passing through registers (L2 only);
// fill = false writes 16 zero bytes and reads nothing from src (src must
// still be a valid address)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_u32(dst)), "l"(src), "r"(fill ? 16 : 0));
}

// close the group of copies this thread has issued since the last commit
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
