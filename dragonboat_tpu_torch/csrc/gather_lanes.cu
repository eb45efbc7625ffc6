// K2: the router's response-lane pick.
//
// Replaces the Pallas kernel `gather_lanes_pallas` (_gather_pallas /
// _gather_block_kernel) in dragonboat_tpu/parallel/fabric_pallas.py.
//
// out[g, m] = vals[g, idx[g, m]] for idx in [0, K); any other index (the
// router's lane == K "no lane" sentinel) reads 0, as the Pallas one-hot
// select does.
//
// Bound on the H100: memory.  Each output reads one index and at most one
// value and writes one int32; there is no arithmetic to speak of.  Design:
// one thread per (g, m) output, consecutive threads on consecutive outputs
// so the index loads and output stores coalesce; the value rows (K = 10 on
// the main path) are small enough that the scattered value reads hit L1/L2.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void gather_lanes_kernel(const int32_t* __restrict__ vals,
                                    const int32_t* __restrict__ idx,
                                    int32_t* __restrict__ out, int G, int K,
                                    int M) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)G * M) return;
  int64_t g = t / M;
  int32_t i = idx[t];
  out[t] = (i >= 0 && i < K) ? vals[g * K + i] : 0;
}

}  // namespace

extern "C" int dbt_gather_lanes(const void* vals, const void* idx, void* out,
                                int G, int K, int M, void* stream) {
  if (G <= 0 || K <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int64_t n = (int64_t)G * M;
  const int blocks = (int)((n + threads - 1) / threads);
  gather_lanes_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)vals, (const int32_t*)idx, (int32_t*)out, G, K, M);
  return (int)cudaGetLastError();
}
