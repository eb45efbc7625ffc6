// K1: the commit rule's order statistic.
//
// Replaces the Pallas kernel `quorum_match_pallas` (_quorum_pallas /
// _quorum_block_kernel) in dragonboat_tpu/parallel/fabric_pallas.py.
//
// Per row g: the quorum[g]-th largest match[g, :] among voting[g, :] peers,
// by compare-count rank select (no sort): cnt[i] = #{voting j : m[j] >= m[i]},
// the answer is the largest voting m[i] with cnt[i] >= q.  With fewer
// voters than the quorum it is the smallest voting match, and with no
// voters INT_MAX — the same clip the sort-then-gather reference takes.
//
// Bound on the H100: memory.  A row reads P int32 matches, P bool votes
// and one quorum and writes one int32: (5P + 8) bytes for O(P^2) integer
// compares on P <= 16 values.  Design: one thread per row, the row held in
// registers, the P^2 compare-count unrolled over a fixed-size array; no
// shared memory and no synchronisation.  Neighbouring threads read
// neighbouring rows, so the loads coalesce across the warp.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxPeers = 16;

__global__ void quorum_match_kernel(const int32_t* __restrict__ match,
                                    const uint8_t* __restrict__ voting,
                                    const int32_t* __restrict__ quorum,
                                    int32_t* __restrict__ out, int G, int P) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  int32_t m[kMaxPeers];
  bool v[kMaxPeers];
#pragma unroll
  for (int i = 0; i < kMaxPeers; ++i) {
    if (i < P) {
      m[i] = match[(int64_t)g * P + i];
      v[i] = voting[(int64_t)g * P + i] != 0;
    } else {
      m[i] = 0;
      v[i] = false;
    }
  }
  const int32_t q = quorum[g];
  bool any_ok = false;
  int32_t best = INT_MIN;
  int32_t fallback = INT_MAX;
#pragma unroll
  for (int i = 0; i < kMaxPeers; ++i) {
    if (!v[i]) continue;
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < kMaxPeers; ++j) cnt += (v[j] && m[j] >= m[i]) ? 1 : 0;
    if (cnt >= q) {
      any_ok = true;
      best = max(best, m[i]);
    }
    fallback = min(fallback, m[i]);
  }
  out[g] = any_ok ? best : fallback;
}

}  // namespace

extern "C" int dbt_quorum_match(const void* match, const void* voting,
                                const void* quorum, void* out, int G, int P,
                                void* stream) {
  if (G <= 0 || P <= 0 || P > kMaxPeers) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int blocks = (G + threads - 1) / threads;
  quorum_match_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)match, (const uint8_t*)voting, (const int32_t*)quorum,
      (int32_t*)out, G, P);
  return (int)cudaGetLastError();
}
