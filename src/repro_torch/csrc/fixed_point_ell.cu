// One Jacobi round of ELL failure propagation for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/ufa/propagation.py
// (fixed_point_ell / _round_kernel): for every dark-set row s and caller u
//
//   hit[s, u] = any_k cur[s, ell_dst[u, k]] & ell_closed[u, k]
//   nxt[s, u] = cur[s, u] | hit[s, u]
//
// and a device int32 flag is set when any entry flips.  The host loop in
// repro_torch/kernels/ufa/propagation.py launches rounds until the flag
// stays 0 or n + 1 rounds ran, counting the final no-change round, as the
// reference's while_loop does.
//
// What bounds it: memory and latency, not arithmetic.  A round reads the
// adjacency (n * K * 5 bytes: 1.4 MB of ell_dst and 0.35 MB of ell_closed
// at paper scale, n = 21,979, K = 16) and the U * n dark slab, and writes
// U * n bytes: under 2 MB, under 1 us at 3.35 TB/s, and L2-resident
// (50 MB) from the second round on.  The launch and the host's read of
// the flag after each round (a device-to-host copy and a synchronise)
// set the pace, which is recorded in PERF.md, not fixed here.
//
// Design: one thread per (row, caller); a thread whose caller is already
// broken copies it and skips the gather; otherwise it walks its K slots,
// testing the fail-close bit before it gathers the callee (pad slots are
// never read) and stops at the first hit.  The round is double-buffered:
// it reads `cur` and writes `nxt`, never the slab it reads.  Updating in
// place would let a hit travel several hops in one round, converging in
// fewer rounds than the reference and breaking the exact `rounds` count.
// The Pallas kernel's (scenario block, caller block) tiling is not carried
// over: there each tile reloaded the whole slab into VMEM; here the gather
// goes through L1/L2 and the grid is flat.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256

__global__ void __launch_bounds__(THREADS)
ell_round_kernel(const uint8_t* __restrict__ cur, uint8_t* __restrict__ nxt,
                 const int32_t* __restrict__ ell_dst,
                 const uint8_t* __restrict__ ell_closed, int U, int n, int K,
                 int* __restrict__ changed) {
  const size_t idx = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (size_t)U * n) return;
  const size_t row = idx / (size_t)n;
  const size_t u = idx - row * (size_t)n;
  uint8_t b = cur[idx];
  if (!b) {
    const uint8_t* brow = cur + row * (size_t)n;
    const int32_t* dst = ell_dst + u * (size_t)K;
    const uint8_t* closed = ell_closed + u * (size_t)K;
    for (int k = 0; k < K; ++k) {
      if (closed[k] && brow[dst[k]]) {
        b = 1;
        break;
      }
    }
    if (b) *changed = 1;  // every writer stores the same value
  }
  nxt[idx] = b;
}

extern "C" int ell_round_launch(const uint8_t* cur, uint8_t* nxt,
                                const int32_t* ell_dst,
                                const uint8_t* ell_closed, int U, int n,
                                int K, int* changed, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (U < 1 || n < 1 || K < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(changed, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)U * n;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  ell_round_kernel<<<blocks, THREADS, 0, s>>>(cur, nxt, ell_dst, ell_closed,
                                              U, n, K, changed);
  return (int)cudaGetLastError();
}
