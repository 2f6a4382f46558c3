// Random 32-bit adds into a thread-block cluster's distributed shared
// memory (DSMEM) against the same adds into global memory, on Hopper
// (sm_90a).  Prints one JSON line.  Build and run from the repo's root:
//
//   mkdir -p build && nvcc -gencode arch=compute_90a,code=sm_90a \
//       -std=c++17 -O3 -o build/dsmem_microbench tools/dsmem_microbench.cu
//   nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
//   build/dsmem_microbench
//
// Work: N adds of 1 at random bins of a BINS-bin int32 histogram (the
// outcome-code histogram's size at paper scale: 120,827 edges x 4 codes),
// bin ids precomputed on the device by a hash and read with 16-byte
// loads, as a telemetry chunk's edge ids are.
//   global  one atomicAdd a bin into a zeroed global array (the histogram
//           kernel's "global" route)
//   dsmem   Q clusters of 16 CTAs; a cluster spreads the whole histogram
//           over its CTAs' shared memory (bin b in CTA b % 16 at b / 16)
//           and each add is a red.shared::cluster into the owner CTA
//   local   the same grid, but every add goes to the adding CTA's own
//           shared memory (bins folded into its range): the shared-memory
//           atomic rate without the SM-to-SM network
// Each timed launch includes zeroing the bins (memset, or the CTAs'
// own shared memory) and, for dsmem and local, the cluster barriers.

#include <cstdio>
#include <cstdlib>

#include "../src/repro_torch/csrc/hopper.cuh"

#define BINS 483308
#define N_ADDS 4000000
#define CL 16
#define THREADS 1024
#define REPS 20

__global__ void make_bins(int* bins, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    uint32_t h = (uint32_t)i * 2654435761u;
    h ^= h >> 15;
    h *= 2246822519u;
    h ^= h >> 13;
    bins[i] = (int)(h % BINS);
  }
}

__global__ void global_adds(const int4* idx, int n4, int* hist) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += gridDim.x * blockDim.x) {
    const int4 b = idx[i];
    atomicAdd(hist + b.x, 1);
    atomicAdd(hist + b.y, 1);
    atomicAdd(hist + b.z, 1);
    atomicAdd(hist + b.w, 1);
  }
}

template <bool LOCAL>
__global__ void __launch_bounds__(THREADS, 1)
    dsmem_adds(const int4* idx, int n4, int per_cta, int* sink) {
  extern __shared__ __align__(16) int bins[];
  const uint32_t rank = cluster_ctarank();
  for (int i = threadIdx.x; i < per_cta; i += THREADS) bins[i] = 0;
  cluster_sync();
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < n4;
       i += gridDim.x * THREADS) {
    const int4 b = idx[i];
    const int v[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t owner = LOCAL ? rank : (uint32_t)v[k] % CL;
      dsmem_add(dsmem_map(bins + v[k] / CL, owner), 1);
    }
  }
  cluster_sync();
  if (threadIdx.x == 0) atomicAdd(sink, bins[0]);
}

#define CHECK(x)                                                         \
  do {                                                                   \
    cudaError_t e = (x);                                                 \
    if (e != cudaSuccess) {                                              \
      fprintf(stderr, "%s: %s\n", #x, cudaGetErrorString(e));            \
      exit(1);                                                           \
    }                                                                    \
  } while (0)

template <typename F>
static float time_ms(F f) {
  for (int i = 0; i < 3; ++i) f();
  cudaEvent_t a, b;
  CHECK(cudaEventCreate(&a));
  CHECK(cudaEventCreate(&b));
  CHECK(cudaEventRecord(a));
  for (int i = 0; i < REPS; ++i) f();
  CHECK(cudaEventRecord(b));
  CHECK(cudaEventSynchronize(b));
  float ms = 0;
  CHECK(cudaEventElapsedTime(&ms, a, b));
  return ms / REPS;
}

int main() {
  int sms = 0;
  CHECK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0));
  int *idx, *hist, *sink;
  CHECK(cudaMalloc(&idx, N_ADDS * sizeof(int)));
  CHECK(cudaMalloc(&hist, BINS * sizeof(int)));
  CHECK(cudaMalloc(&sink, sizeof(int)));
  make_bins<<<sms * 4, 256>>>(idx, N_ADDS);
  CHECK(cudaGetLastError());
  const int n4 = N_ADDS / 4;
  const int4* idx4 = reinterpret_cast<const int4*>(idx);

  const float g_ms = time_ms([&] {
    cudaMemsetAsync(hist, 0, BINS * sizeof(int));
    global_adds<<<sms * 8, 256>>>(idx4, n4, hist);
  });
  CHECK(cudaGetLastError());

  const int per_cta = (BINS + CL - 1) / CL;
  const size_t smem = (size_t)per_cta * sizeof(int);
  int fit = 0;
  if (cluster_fit(dsmem_adds<false>, CL, THREADS, smem, 0, &fit) != 0 ||
      fit < 1) {
    fprintf(stderr, "no cluster of %d CTAs with %zu bytes fits\n", CL, smem);
    return 1;
  }
  const dim3 grid(CL * fit);
  float d_ms = time_ms([&] {
    if (launch_cluster(dsmem_adds<false>, grid, CL, THREADS, smem, 0, idx4,
                       n4, per_cta, sink) != 0)
      exit(1);
  });
  float l_ms = time_ms([&] {
    if (launch_cluster(dsmem_adds<true>, grid, CL, THREADS, smem, 0, idx4,
                       n4, per_cta, sink) != 0)
      exit(1);
  });
  CHECK(cudaDeviceSynchronize());
  cudaDeviceProp p;
  CHECK(cudaGetDeviceProperties(&p, 0));
  printf("{\"device\": \"%s\", \"adds\": %d, \"bins\": %d, "
         "\"clusters\": %d, \"cluster_ctas\": %d, \"smem_per_cta\": %zu, "
         "\"global_ms\": %.6f, \"dsmem_ms\": %.6f, \"local_ms\": %.6f, "
         "\"global_gadds_per_s\": %.3f, \"dsmem_gadds_per_s\": %.3f, "
         "\"local_gadds_per_s\": %.3f}\n",
         p.name, N_ADDS, BINS, fit, CL, smem, g_ms, d_ms, l_ms,
         N_ADDS / g_ms / 1e6, N_ADDS / d_ms / 1e6, N_ADDS / l_ms / 1e6);
  return 0;
}
