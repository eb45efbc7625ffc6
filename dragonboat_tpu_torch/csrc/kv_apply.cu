// K3: the device KV state machine's apply window.
//
// Replaces the Pallas kernel `apply_kernel_pallas` (_apply_pallas /
// _apply_block_kernel) in dragonboat_tpu/rsm/device_kv_pallas.py.
//
// Per shard row: AB (key, val) commands applied in order to a [T]
// linear-probe table.  Keys are stored +1 (0 = empty).  The home slot is
// splitmix32(key) & (T-1) when hashed, else key & (T-1).  Within the probe
// window of D slots the first hit wins, else the first empty slot.  A full
// window or a negative key gives result -1 and ok 0.  keys, vals and count
// are updated in place.
//
// Bound on the H100: memory.  Applying the window needs one read and one
// write of the row's keys and vals (2 * T * 4 bytes each way; about 201 MB
// each way at 24,576 rows x T = 1024), against the 2 * AB full-table passes
// of the sequential plain arm.  Design: one block per shard row; the row's
// keys and vals are staged in shared memory by all threads (coalesced), the
// AB commands then run serially in warp 0 — each probe window is examined
// 32 offsets at a time, one offset per lane, and the first hit and first
// empty offsets come from a warp ballot (the block's min reduction), after
// which lane 0 alone decides and writes shared memory — and finally all
// threads write the row back.  The serial command loop touches only shared
// memory, so the row crosses device memory exactly once each way.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t splitmix32(uint32_t x) {
  x += 0x9E3779B9u;
  uint32_t z = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  z = (z ^ (z >> 13)) * 0xC2B2AE35u;
  return z ^ (z >> 16);
}

__global__ void kv_apply_kernel(int32_t* __restrict__ keys,
                                int32_t* __restrict__ vals,
                                int32_t* __restrict__ count,
                                const int32_t* __restrict__ cmds,
                                const uint8_t* __restrict__ valid,
                                int32_t* __restrict__ results,
                                uint8_t* __restrict__ ok, int T, int D,
                                int AB, int hash_keys) {
  extern __shared__ int32_t smem[];
  int32_t* keys_s = smem;
  int32_t* vals_s = smem + T;
  const int64_t row = blockIdx.x;
  int32_t* keys_row = keys + row * T;
  int32_t* vals_row = vals + row * T;
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    keys_s[i] = keys_row[i];
    vals_s[i] = vals_row[i];
  }
  __syncthreads();

  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const uint32_t tmask = (uint32_t)(T - 1);
    int added = 0;
    for (int j = 0; j < AB; ++j) {
      const int64_t c = row * AB + j;
      const int32_t key = cmds[2 * c];
      const int32_t val = cmds[2 * c + 1];
      const bool lane_ok = valid[c] != 0;
      const uint32_t h =
          (hash_keys ? splitmix32((uint32_t)key) : (uint32_t)key) & tmask;
      const int32_t stored = (int32_t)((uint32_t)key + 1u);
      int min_hit = D;
      int min_empty = D;
      for (int base = 0; base < D; base += 32) {
        const int off = base + lane;
        const bool in_win = off < D;
        const int32_t k = in_win ? keys_s[(h + (uint32_t)off) & tmask] : 1;
        const uint32_t hits = __ballot_sync(0xFFFFFFFFu, in_win && k == stored);
        const uint32_t empties = __ballot_sync(0xFFFFFFFFu, in_win && k == 0);
        if (min_hit == D && hits) min_hit = base + __ffs(hits) - 1;
        if (min_empty == D && empties) min_empty = base + __ffs(empties) - 1;
      }
      const bool any_hit = min_hit < D;
      const int use = any_hit ? min_hit : min_empty;
      const bool do_it = lane_ok && use < D && key >= 0;
      if (lane == 0) {
        if (do_it) {
          const uint32_t slot = (h + (uint32_t)use) & tmask;
          keys_s[slot] = stored;
          vals_s[slot] = val;
        }
        results[c] = do_it ? val : -1;
        ok[c] = do_it ? 1 : 0;
        added += (do_it && !any_hit) ? 1 : 0;
      }
      __syncwarp();
    }
    if (lane == 0) count[row] += added;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    keys_row[i] = keys_s[i];
    vals_row[i] = vals_s[i];
  }
}

}  // namespace

extern "C" int dbt_kv_apply(void* keys, void* vals, void* count,
                            const void* cmds, const void* valid, void* results,
                            void* ok, int G, int T, int D, int AB,
                            int hash_keys, void* stream) {
  if (G <= 0 || T <= 0 || (T & (T - 1)) != 0 || D <= 0 || D > T || AB <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)T * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kv_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kv_apply_kernel<<<G, 256, smem, (cudaStream_t)stream>>>(
      (int32_t*)keys, (int32_t*)vals, (int32_t*)count, (const int32_t*)cmds,
      (const uint8_t*)valid, (int32_t*)results, (uint8_t*)ok, T, D, AB,
      hash_keys);
  return (int)cudaGetLastError();
}
