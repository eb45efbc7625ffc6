// K1: the commit rule's order statistic.
//
// Replaces the Pallas kernel `quorum_match_pallas` (_quorum_pallas /
// _quorum_block_kernel) in dragonboat_tpu/parallel/fabric_pallas.py.
//
// Per row g: the q-th largest match[g, :] among the voting peers, by
// compare-count rank select (no sort): cnt[i] = #{voting j : m[j] >= m[i]},
// the answer is the largest voting m[i] with cnt[i] >= q.  With fewer
// voters than the quorum it is the smallest voting match, and with no
// voters INT_MAX — the same clip the sort-then-gather reference takes.
//
// Two entries share that select (`select_quorum`):
// - `dbt_quorum_match` takes voting [G, P] bool and quorum [G] i32 as the
//   TPU kernel does (the invariant probe's `quorum(match)`);
// - `dbt_commit_quorum` takes the peer kinds [G, P] i32 and derives in
//   registers what the step's commit rule built around each call:
//   voting = kind is K_VOTER or K_WITNESS and quorum = nv / 2 + 1.  That
//   folds the ~9 small launches of the mask and the count (two compares,
//   an or, the same again for the count, a sum, the halving, the +1) into
//   the one launch; the step makes 16 such calls.
//
// Bound on the H100: neither bytes nor operations but the launch.  A row
// of `commit_quorum` reads P int32 matches and P int32 kinds and writes
// one int32, (4P + 4P + 4) bytes: 0.00022 ms at [24576, 3] against
// 3.35 TB/s, for O(P^2) integer compares on P <= 16 values.  An empty
// launch takes ~0.0017 ms on the H100 (K2 on one row, chip_smoke.py), so
// the byte bound lies under a tenth of the launch floor and no one-launch
// design can come within half of it; only fewer launches (a CUDA graph of
// the step) remove that gap.  Design: one thread per row, the row held in
// registers, the compare-count unrolled over a fixed array sized for P
// (4, 8 or 16); no shared memory and no synchronisation.  Neighbouring
// threads read neighbouring rows, so the loads coalesce across the warp.
// Blocks of 128 threads: the 24,576 rows of the bench's 8192 x 3 give 192
// blocks, more than the 132 SMs, where blocks of 256 left 36 SMs idle.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxPeers = 16;
constexpr int kThreads = 128;

// The quorum-th largest of the voting matches of one row (in registers).
template <int MaxP>
__device__ __forceinline__ int32_t select_quorum(const int32_t (&m)[MaxP],
                                                 const bool (&v)[MaxP],
                                                 int32_t q) {
  bool any_ok = false;
  int32_t best = INT_MIN;
  int32_t fallback = INT_MAX;
#pragma unroll
  for (int i = 0; i < MaxP; ++i) {
    if (!v[i]) continue;
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < MaxP; ++j) cnt += (v[j] && m[j] >= m[i]) ? 1 : 0;
    if (cnt >= q) {
      any_ok = true;
      best = max(best, m[i]);
    }
    fallback = min(fallback, m[i]);
  }
  return any_ok ? best : fallback;
}

template <int MaxP>
__global__ void __launch_bounds__(kThreads)
    quorum_match_kernel(const int32_t* __restrict__ match,
                        const uint8_t* __restrict__ voting,
                        const int32_t* __restrict__ quorum,
                        int32_t* __restrict__ out, int G, int P) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  int32_t m[MaxP];
  bool v[MaxP];
#pragma unroll
  for (int i = 0; i < MaxP; ++i) {
    const bool in = i < P;
    m[i] = in ? match[(int64_t)g * P + i] : 0;
    v[i] = in && voting[(int64_t)g * P + i] != 0;
  }
  out[g] = select_quorum<MaxP>(m, v, quorum[g]);
}

template <int MaxP>
__global__ void __launch_bounds__(kThreads)
    commit_quorum_kernel(const int32_t* __restrict__ match,
                         const int32_t* __restrict__ kind,
                         int32_t* __restrict__ out, int G, int P,
                         int32_t voter, int32_t witness) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  int32_t m[MaxP];
  bool v[MaxP];
  int nv = 0;
#pragma unroll
  for (int i = 0; i < MaxP; ++i) {
    const bool in = i < P;
    m[i] = in ? match[(int64_t)g * P + i] : 0;
    const int32_t k = in ? kind[(int64_t)g * P + i] : -1;
    v[i] = in && (k == voter || k == witness);
    nv += v[i] ? 1 : 0;
  }
  out[g] = select_quorum<MaxP>(m, v, nv / 2 + 1);
}

// G is an int (one thread a row): rows up to 2^31 - 1 - kThreads, far
// past the 300,000 of 100,000 groups x 3
int blocks_for(int G) { return (G + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int dbt_quorum_match(const void* match, const void* voting,
                                const void* quorum, void* out, int G, int P,
                                void* stream) {
  if (G <= 0 || P <= 0 || P > kMaxPeers) return (int)cudaErrorInvalidValue;
  const auto* m = (const int32_t*)match;
  const auto* v = (const uint8_t*)voting;
  const auto* q = (const int32_t*)quorum;
  auto* o = (int32_t*)out;
  auto s = (cudaStream_t)stream;
  if (P <= 4)
    quorum_match_kernel<4><<<blocks_for(G), kThreads, 0, s>>>(m, v, q, o, G, P);
  else if (P <= 8)
    quorum_match_kernel<8><<<blocks_for(G), kThreads, 0, s>>>(m, v, q, o, G, P);
  else
    quorum_match_kernel<16><<<blocks_for(G), kThreads, 0, s>>>(m, v, q, o, G, P);
  return (int)cudaGetLastError();
}

extern "C" int dbt_commit_quorum(const void* match, const void* kind,
                                 void* out, int G, int P, int voter,
                                 int witness, void* stream) {
  if (G <= 0 || P <= 0 || P > kMaxPeers) return (int)cudaErrorInvalidValue;
  const auto* m = (const int32_t*)match;
  const auto* k = (const int32_t*)kind;
  auto* o = (int32_t*)out;
  auto s = (cudaStream_t)stream;
  if (P <= 4)
    commit_quorum_kernel<4><<<blocks_for(G), kThreads, 0, s>>>(m, k, o, G, P, voter, witness);
  else if (P <= 8)
    commit_quorum_kernel<8><<<blocks_for(G), kThreads, 0, s>>>(m, k, o, G, P, voter, witness);
  else
    commit_quorum_kernel<16><<<blocks_for(G), kThreads, 0, s>>>(m, k, o, G, P, voter, witness);
  return (int)cudaGetLastError();
}
