// PTX wrappers of Hopper's asynchronous machinery (sm_90a): mbarriers,
// TMA tensor loads, wgmma with its shared-memory descriptors, and
// setmaxnreg; thread-block clusters with their distributed shared memory
// (DSMEM) and cluster barrier; and on the host, the encoding of a TMA
// tensor map and the launch of a cluster grid.  Used by the grouped
// matmul's wgmma kernel, the bf16 decode attention kernel, the ELL fixed
// point's cluster route and the histogram's DSMEM route.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (header only: no -lcuda)

#include <mutex>
#include <vector>

#include "common.cuh"

// ---------------------------------------------------------------------------
// mbarriers (shared-memory barriers that count arrivals and TMA bytes)
// ---------------------------------------------------------------------------

// one thread: the barrier completes a phase after `count` arrivals (and
// whatever transaction bytes the phase was told to expect)
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// after the inits, before any thread or TMA uses the barriers
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive once and add `bytes` to the transaction bytes the current phase
// waits for (the producer's arrival before its TMA loads)
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// spin until the phase of parity `parity` has completed: a fresh barrier
// is in phase 0, so waiting on parity 1 passes at once and waiting on 0
// blocks until the first phase completes
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// one thread: copy the box of `map` at element coordinates (c0, c1, c2),
// innermost first, into shared memory at dst; the bytes complete on bar.
// Out-of-range elements land as zeros and still count as bytes.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// the same for a 4-D map, coordinates (c0, c1, c2, c3) innermost first
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma (a warpgroup of 128 threads, operands in shared memory)
// ---------------------------------------------------------------------------

// before the first wgmma, and after any other instruction touched its
// accumulator registers
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// close the group of wgmmas this warpgroup has issued
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pin a register after a wgmma_wait: the compiler may not move a read of
// an accumulator above the wait that makes it valid
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// descriptor of a SWIZZLE_128B operand tile in shared memory (what TMA
// writes under CU_TENSOR_MAP_SWIZZLE_128B; the tile 1024-byte aligned).
// Fields: start address >> 4 (bits 0-13), leading byte offset >> 4
// (16-29), stride byte offset >> 4 (32-45), layout 1 = 128-byte swizzle
// (62-63).  K-major (K contiguous, 64 bf16 = one 128-byte row): lbo is
// unused, sbo the step between groups of 8 rows (1024).  MN-major (MN
// contiguous in 128-byte rows of 64 elements, one row per k): lbo the
// step between 64-wide MN blocks, sbo the step between groups of 8 k.
// Adding 2 (32 bytes) moves a K-major tile on by 16 k inside its rows.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* tile,
                                                     uint32_t lbo,
                                                     uint32_t sbo) {
  const uint64_t a = smem_u32(tile);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

#define WGMMA_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WGMMA_D16(i) \
  WGMMA_D4(i), WGMMA_D4(i + 4), WGMMA_D4(i + 8), WGMMA_D4(i + 12)

// d (64 x 256, float32) += A (64 x 16) B (16 x 256), both of the 16-bit
// type T (bf16 or fp16): A K-major, B K-major (TRANS_B 0) or N-major
// (TRANS_B 1), both by descriptor.  Thread l of warp w in the warpgroup
// holds d[4j + h]: row 16 w + l / 4 (+ 8 for h >= 2), column 8 j + 2 (l %
// 4) + h % 2.  Each product of two bf16 (or two fp16) is exact in
// float32.
#define WGMMA_M64N256K16(TY)                                                \
  asm volatile(                                                             \
      "{\n"                                                                 \
      ".reg .pred p;\n"                                                     \
      "setp.ne.b32 p, %130, 0;\n"                                           \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " "           \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "   \
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "   \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "   \
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "    \
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "  \
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "  \
      "%127}, %128, %129, p, 1, 1, 0, %131;\n"                               \
      "}\n"                                                                 \
      : WGMMA_D16(0), WGMMA_D16(16), WGMMA_D16(32), WGMMA_D16(48),          \
        WGMMA_D16(64), WGMMA_D16(80), WGMMA_D16(96), WGMMA_D16(112)         \
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TRANS_B))

template <int TRANS_B, typename T = bf16>
__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t desc_a,
                                                 uint64_t desc_b) {
  if constexpr (std::is_same<T, bf16>::value) {
    WGMMA_M64N256K16("bf16");
  } else {
    WGMMA_M64N256K16("f16");
  }
}

#undef WGMMA_M64N256K16
#undef WGMMA_D16
#undef WGMMA_D4

// ---------------------------------------------------------------------------
// warp specialisation
// ---------------------------------------------------------------------------

// a whole warpgroup lowers (producer) or raises (consumer) its register
// budget; the counts are multiples of 8 in [24, 256]
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// host: TMA tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*TensorMapEncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled (its CUDA 12.0 signature), found
// through the runtime (CUDA 12.5 or later) so that the library needs no
// -lcuda; null if the driver does not have it
static TensorMapEncodeTiled tensor_map_encoder() {
  static TensorMapEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
    if (rc == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<TensorMapEncodeTiled>(p);
  }
  return fn;
}

// a 16-bit tensor of rank R (bf16, or fp16 when f16), dims n[0..R)
// innermost first, unit stride on dim 0 and byte strides s[0..R-1) for
// dims 1..R-1 (multiples of 16, as TMA asks, like the base address), read
// in boxes of box[0..R) with the 128-byte swizzle (box[0] * 2 <= 128) and
// zeros beyond the edges.  Returns 0 or a cudaError_t.
template <int R>
static int encode_b16(CUtensorMap* map, const void* base,
                      const uint64_t* n, const uint64_t* s,
                      const uint32_t* box, bool f16 = false) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t dims[R], strides[R - 1];
  cuuint32_t boxes[R], step[R];
  for (int i = 0; i < R; ++i) {
    dims[i] = n[i];
    boxes[i] = box[i];
    step[i] = 1;
    if (i + 1 < R) {
      if (s[i] % 16 != 0 || s[i] >= (1ull << 40))
        return (int)cudaErrorInvalidValue;
      strides[i] = s[i];
    }
  }
  const CUresult rc = encode(
      map,
      f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      R, const_cast<void*>(base), dims, strides, boxes, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// a 3-D 16-bit tensor, contiguous, dims (n0, n1, n2) innermost first, read
// in boxes of (b0, b1, 1); n0 % 8 == 0 and base 16-byte aligned
static int encode_b16_3d(CUtensorMap* map, const void* base, uint64_t n0,
                         uint64_t n1, uint64_t n2, uint32_t b0, uint32_t b1,
                         bool f16) {
  const uint64_t dims[3] = {n0, n1, n2};
  const uint64_t strides[2] = {n0 * 2, n0 * n1 * 2};
  const uint32_t box[3] = {b0, b1, 1};
  return encode_b16<3>(map, base, dims, strides, box, f16);
}

// ---------------------------------------------------------------------------
// thread-block clusters and distributed shared memory (DSMEM)
// ---------------------------------------------------------------------------

// this CTA's rank in its cluster, and the cluster's size in CTAs
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_nctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

// the cluster barrier, split: every thread of every CTA of the cluster
// arrives (release: its earlier shared-memory writes, local and remote,
// become visible to the cluster) and then waits (acquire) until all have
// arrived.  Called by all threads of the CTA, in converged code.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// the shared::cluster address of `local` (this CTA's shared memory) in
// the CTA of rank `rank`: every CTA of a kernel lays its shared memory
// out alike, so the same variable sits at the same offset in each
__device__ __forceinline__ uint32_t dsmem_map(const void* local,
                                              uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_u32(local)), "r"(rank));
  return a;
}

// 32-bit load, 16-byte load, 32-bit store and add at a shared::cluster
// address (any CTA of the cluster, this one included; the 16-byte load's
// address 16-byte aligned)
__device__ __forceinline__ uint32_t dsmem_ld(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n"
               : "=r"(v)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ int4 dsmem_ld4(uint32_t addr) {
  int4 v;
  asm volatile("ld.shared::cluster.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void dsmem_st(uint32_t addr, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(addr), "r"(v)
               : "memory");
}

__device__ __forceinline__ void dsmem_add(uint32_t addr, uint32_t v) {
  asm volatile("red.shared::cluster.add.u32 [%0], %1;\n" ::"r"(addr),
               "r"(v)
               : "memory");
}

// host: the opt-in shared memory of one CTA on sm_90 (227 KB), what the
// routes that keep state in shared memory are sized against
#define SMEM_OPTIN_BYTES 232448

// host: make `kernel` launchable in clusters of `cluster` CTAs (sizes
// above 8 are non-portable and must be allowed per kernel) with up to
// SMEM_OPTIN_BYTES of dynamic shared memory, and return in *fit how many
// such clusters of `threads`-thread CTAs with `smem` bytes each the
// device holds at once (cudaOccupancyMaxActiveClusters).  The answer is
// cached per (kernel, device, cluster, threads, smem).  Returns 0 or a
// cudaError_t; *fit == 0 means the cluster cannot be placed at all.
template <typename Kernel>
static int cluster_fit(Kernel kernel, unsigned cluster, unsigned threads,
                       size_t smem, cudaStream_t s, int* fit) {
  struct Entry {
    const void* fn;
    int dev;
    unsigned cluster, threads;
    size_t smem;
    int fit;
  };
  static std::mutex lock;
  static std::vector<Entry> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const void* fn = reinterpret_cast<const void*>(kernel);
  {
    std::lock_guard<std::mutex> g(lock);
    for (const Entry& e : cache)
      if (e.fn == fn && e.dev == dev && e.cluster == cluster &&
          e.threads == threads && e.smem == smem) {
        *fit = e.fit;
        return 0;
      }
  }
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_OPTIN_BYTES);
  if (err != cudaSuccess) return (int)err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  *fit = n;
  std::lock_guard<std::mutex> g(lock);
  if (cache.size() < 64) cache.push_back({fn, dev, cluster, threads, smem, n});
  return 0;
}

// host: launch `kernel` on `grid` (grid.x a multiple of `cluster`) in
// clusters of `cluster` CTAs along x, after cluster_fit says one fits.
// Returns 0 or a cudaError_t (cudaErrorInvalidConfiguration when no
// cluster fits); never falls back to another launch.
template <typename... Params, typename... Args>
static int launch_cluster(void (*kernel)(Params...), dim3 grid,
                          unsigned cluster, unsigned threads, size_t smem,
                          cudaStream_t s, Args... args) {
  int fit = 0;
  const int rc = cluster_fit(kernel, cluster, threads, smem, s, &fit);
  if (rc != 0) return rc;
  if (fit < 1) return (int)cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
