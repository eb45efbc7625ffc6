// K3: the device KV state machine's apply window.
//
// Replaces the Pallas kernel `apply_kernel_pallas` (_apply_pallas /
// _apply_block_kernel) in dragonboat_tpu/rsm/device_kv_pallas.py.
//
// Per shard row: AB (key, val) commands applied in order to a [T]
// linear-probe table.  Keys are stored +1 (0 = empty).  The home slot is
// splitmix32(key) & (T-1) when hashed, else key & (T-1).  Within the probe
// window of D slots the first hit wins, else the first empty slot.  A full
// window or a negative key gives result -1 and ok 0.  Later commands see
// earlier writes.  keys, vals and count are updated in place.
//
// Bound on the H100: the bytes of the window, not of the table.  A row
// needs its AB commands and valid flags in, its results and ok flags out,
// the keys of the slots its probe windows cover (a stored value is never
// read: a result is the command's own value) and the key and value of
// each slot it writes.  On the main path's contiguous direct-mapped
// window that is AB + D - 1 slots of the T, about 2 KB a row against the
// 8 KB of a whole-row pass each way.  Rows whose windows interfere add a
// serial chain of AB dependent steps, each one shared-memory probe.
//
// Design: one warp per shard row, several rows per block (as many as
// 16 KB of 4 * T byte images allow, 1 to 8), and no block-wide barrier.
// Each warp
//   1. loads its row's commands and valid flags once, coalesced: lane l
//      holds commands l, l + 32, ... in registers, with their home slots;
//   2. gathers every active command's D-slot window of keys straight from
//      device memory and speculates its decision against the table as it
//      stood (first hit, else first empty);
//   3. verifies the row in shared memory: the speculative decisions are
//      the sequential ones unless some earlier command's write slot lies
//      in a later active command's window (by induction on the command
//      order, every window then holds what it held before the apply).
//      Each writer stamps its index on its slot; a writer that reads back
//      another index shares its slot with another writer, and a command
//      that finds a smaller index in its window sees an earlier write;
//   4. on a row that fails, re-gathers the windows' keys into its
//      shared-memory image and runs the commands serially there (warp
//      ballots find the first hit and first empty, lane 0 writes the
//      image); the commands come from registers by shuffle, so no device
//      memory access stays in the chain;
//   5. writes results and ok flags, the key and value of each written slot
//      (on a serial row only the slot's last writer writes it), and adds
//      the row's new inserts to count.
// The branch is chosen per row on the device; serial_rows, when not null,
// records it (1 = the serial loop ran).

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxRowsPerBlock = 8;
// shared memory a block aims for, an image of 4 * T bytes per row: 4 rows
// per block at T = 1024 (small blocks fill the SMs' tails more evenly)
constexpr int kBlockImageBytes = 16 * 1024;
constexpr int kMaxSmemBytes = 227 * 1024;
constexpr int32_t kNoWriter = INT_MAX;

__device__ __forceinline__ uint32_t splitmix32(uint32_t x) {
  x += 0x9E3779B9u;
  uint32_t z = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  z = (z ^ (z >> 13)) * 0xC2B2AE35u;
  return z ^ (z >> 16);
}

__device__ __forceinline__ int32_t stored_key(int32_t key) {
  return (int32_t)((uint32_t)key + 1u);
}

// Keys of window offsets d0 .. d0 + U - 1 of each of a lane's commands,
// all loads issued before any is used (1 past the window or for an
// inactive command).
template <int CPL, int U>
__device__ __forceinline__ void load_window(int32_t (&kk)[CPL][U],
                                            const int32_t* keys_row,
                                            const int32_t (&home)[CPL],
                                            int d0, int D, uint32_t mask) {
#pragma unroll
  for (int k = 0; k < CPL; ++k)
#pragma unroll
    for (int u = 0; u < U; ++u)
      kk[k][u] = (home[k] >= 0 && d0 + u < D)
                     ? keys_row[((uint32_t)home[k] + (uint32_t)(d0 + u)) & mask]
                     : 1;
}

// CPL: commands per lane, ceil(AB / 32) rounded up to 1, 2, 4 or 8.
template <int CPL>
__global__ void __launch_bounds__(kMaxRowsPerBlock * 32)
kv_apply_kernel(int32_t* __restrict__ keys, int32_t* __restrict__ vals,
                int32_t* __restrict__ count, const int2* __restrict__ cmds,
                const uint8_t* __restrict__ valid,
                int32_t* __restrict__ results, uint8_t* __restrict__ ok,
                uint8_t* __restrict__ serial_rows, int G, int T, int D,
                int AB, int hash_keys) {
  // window offsets loaded per command at a time
  constexpr int U = (16 / CPL) < 2 ? 2 : 16 / CPL;
  extern __shared__ int32_t smem[];
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= G) return;
  int32_t* img = smem + (size_t)(threadIdx.x >> 5) * T;
  int32_t* keys_row = keys + row * T;
  int32_t* vals_row = vals + row * T;
  const uint32_t mask = (uint32_t)(T - 1);
  const int64_t cbase = row * AB;

  // 1. commands: home < 0 marks an inactive lane (invalid, negative key,
  //    or past AB); w is the write slot, -1 for none
  int32_t key[CPL], val[CPL], home[CPL], w[CPL];
  bool fresh[CPL], last[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int j = k * 32 + lane;
    home[k] = -1;
    w[k] = -1;
    fresh[k] = false;
    key[k] = 0;
    val[k] = 0;
    if (j < AB) {
      const int2 c = cmds[cbase + j];
      key[k] = c.x;
      val[k] = c.y;
      if (valid[cbase + j] && c.x >= 0)
        home[k] = (int32_t)((hash_keys ? splitmix32((uint32_t)c.x)
                                       : (uint32_t)c.x) & mask);
    }
  }

  // 2. gather each window's keys and speculate against the table as it
  //    stood; stamp every window slot "no writer" for the verify
  int hit[CPL], empty[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) hit[k] = empty[k] = -1;
  for (int d0 = 0; d0 < D; d0 += U) {
    int32_t kk[CPL][U];
    load_window(kk, keys_row, home, d0, D, mask);
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      if (home[k] < 0) continue;
      const int32_t stored = stored_key(key[k]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int d = d0 + u;
        if (d >= D) break;
        img[((uint32_t)home[k] + (uint32_t)d) & mask] = kNoWriter;
        if (hit[k] < 0 && kk[k][u] == stored) hit[k] = d;
        if (empty[k] < 0 && kk[k][u] == 0) empty[k] = d;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int use = hit[k] >= 0 ? hit[k] : empty[k];
    if (home[k] >= 0 && use >= 0) {
      w[k] = (int32_t)(((uint32_t)home[k] + (uint32_t)use) & mask);
      fresh[k] = hit[k] < 0;
    }
  }
  __syncwarp();

  // 3. verify: stamp each write slot with its writer's index
#pragma unroll
  for (int k = 0; k < CPL; ++k)
    if (w[k] >= 0) img[w[k]] = k * 32 + lane;
  __syncwarp();
  bool fail = false;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    if (home[k] < 0) continue;
    const int j = k * 32 + lane;
    fail |= w[k] >= 0 && img[w[k]] != j;
    for (int d = 0; d < D && !fail; ++d)
      fail = img[((uint32_t)home[k] + (uint32_t)d) & mask] < j;
  }
  const bool serial = __any_sync(kFull, fail);
  if (serial_rows != nullptr && lane == 0) serial_rows[row] = serial ? 1 : 0;

  if (!serial) {
#pragma unroll
    for (int k = 0; k < CPL; ++k) last[k] = w[k] >= 0;
  } else {
    // 4. the serial loop on the shared-memory image of the windows
    __syncwarp();
    for (int d0 = 0; d0 < D; d0 += U) {
      int32_t kk[CPL][U];
      load_window(kk, keys_row, home, d0, D, mask);
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        if (home[k] < 0) continue;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (d0 + u >= D) break;
          img[((uint32_t)home[k] + (uint32_t)(d0 + u)) & mask] = kk[k][u];
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      for (int src = 0; src < 32 && k * 32 + src < AB; ++src) {
        const int h = __shfl_sync(kFull, home[k], src);
        const int32_t stored = stored_key(__shfl_sync(kFull, key[k], src));
        if (h < 0) continue;
        int min_hit = D, min_empty = D;
        for (int base = 0; base < D && min_hit == D; base += 32) {
          const int off = base + lane;
          const bool in_win = off < D;
          const int32_t kv = in_win ? img[((uint32_t)h + (uint32_t)off) & mask] : 1;
          const uint32_t hits = __ballot_sync(kFull, in_win && kv == stored);
          const uint32_t empties = __ballot_sync(kFull, in_win && kv == 0);
          if (hits) min_hit = base + __ffs(hits) - 1;
          if (min_empty == D && empties) min_empty = base + __ffs(empties) - 1;
        }
        const int use = min_hit < D ? min_hit : min_empty;
        const int32_t slot = use < D ? (int32_t)(((uint32_t)h + (uint32_t)use) & mask) : -1;
        if (lane == src) {
          w[k] = slot;
          fresh[k] = slot >= 0 && min_hit == D;
        }
        if (lane == 0 && slot >= 0) img[slot] = stored;
        __syncwarp();
      }
    }
    // the last writer of each slot writes it back
#pragma unroll
    for (int k = 0; k < CPL; ++k)
      if (w[k] >= 0) img[w[k]] = -1;
    __syncwarp();
#pragma unroll
    for (int k = 0; k < CPL; ++k)
      if (w[k] >= 0) atomicMax(&img[w[k]], k * 32 + lane);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < CPL; ++k)
      last[k] = w[k] >= 0 && img[w[k]] == k * 32 + lane;
  }

  // 5. results, the written slots, count
  int added = 0;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int j = k * 32 + lane;
    if (j >= AB) continue;
    results[cbase + j] = w[k] >= 0 ? val[k] : -1;
    ok[cbase + j] = w[k] >= 0 ? 1 : 0;
    if (last[k]) {
      keys_row[w[k]] = stored_key(key[k]);
      vals_row[w[k]] = val[k];
    }
    added += fresh[k] ? 1 : 0;
  }
  added = __reduce_add_sync(kFull, added);
  if (lane == 0 && added != 0) count[row] += added;
}

template <int CPL>
int launch(int32_t* keys, int32_t* vals, int32_t* count, const int2* cmds,
           const uint8_t* valid, int32_t* results, uint8_t* ok,
           uint8_t* serial_rows, int G, int T, int D, int AB, int hash_keys,
           cudaStream_t stream) {
  int rows = kBlockImageBytes / (4 * T);
  rows = rows < 1 ? 1 : (rows > kMaxRowsPerBlock ? kMaxRowsPerBlock : rows);
  const size_t smem = (size_t)rows * T * sizeof(int32_t);
  if (smem > (size_t)kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kv_apply_kernel<CPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (G + rows - 1) / rows;
  kv_apply_kernel<CPL><<<blocks, rows * 32, smem, stream>>>(
      keys, vals, count, cmds, valid, results, ok, serial_rows, G, T, D, AB,
      hash_keys);
  return (int)cudaGetLastError();
}

}  // namespace

// cmds must be 8-byte aligned ([G, AB, 2] int32); serial_rows may be null.
extern "C" int dbt_kv_apply(void* keys, void* vals, void* count,
                            const void* cmds, const void* valid, void* results,
                            void* ok, void* serial_rows, int G, int T, int D,
                            int AB, int hash_keys, void* stream) {
  if (G <= 0 || T <= 0 || (T & (T - 1)) != 0 || D <= 0 || D > T || AB <= 0 ||
      AB > 8 * 32 || ((uintptr_t)cmds & 7) != 0)
    return (int)cudaErrorInvalidValue;
  auto* k = (int32_t*)keys;
  auto* v = (int32_t*)vals;
  auto* c = (int32_t*)count;
  auto* cm = (const int2*)cmds;
  auto* va = (const uint8_t*)valid;
  auto* r = (int32_t*)results;
  auto* o = (uint8_t*)ok;
  auto* s = (uint8_t*)serial_rows;
  auto st = (cudaStream_t)stream;
  if (AB <= 32) return launch<1>(k, v, c, cm, va, r, o, s, G, T, D, AB, hash_keys, st);
  if (AB <= 64) return launch<2>(k, v, c, cm, va, r, o, s, G, T, D, AB, hash_keys, st);
  if (AB <= 128) return launch<4>(k, v, c, cm, va, r, o, s, G, T, D, AB, hash_keys, st);
  return launch<8>(k, v, c, cm, va, r, o, s, G, T, D, AB, hash_keys, st);
}
