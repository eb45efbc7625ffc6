// K2: the router's response-lane pick.
//
// Replaces the Pallas kernel `gather_lanes_pallas` (_gather_pallas /
// _gather_block_kernel) in dragonboat_tpu/parallel/fabric_pallas.py.
//
// For every field f and lane tensor l, with the lanes read as [A, B, C]:
//   out[l][f][a, b, c] = field_f[a * C + c, lane_l[a, b, c]]
// and a lane outside [0, K) (the router's lane == K "no lane" sentinel)
// reads 0, as the Pallas one-hot select does.  Two entries launch the
// same kernel:
// - `dbt_gather_lanes_multi`: the route's whole response pick in one
//   launch, six [G, K] StepOutput fields (five int32, r_reject bool) by
//   the two [N, Rt, Rs] lane tensors (first and second matching lane) in
//   the route's own layout (A = N, B = Rt, C = Rs, G = N * Rs), twelve
//   outputs.  That replaces twelve launches of the one-field kernel and
//   the ~16 launches around them (an index transpose copy per call, the
//   bool field's two casts);
// - `dbt_gather_lanes`: the TPU kernel's own signature, vals [G, K] int32
//   by idx [G, M], out[g, m] = vals[g, idx[g, m]]: one field, one lane,
//   read as [G, M, 1].
//
// Bound on the H100: the launch, then memory.  At the bench's 8192 x 3
// (K = 10) the route's pick moves each field once (5 x 983,040 B int32 +
// 245,760 B bool), both lanes once (2 x 294,912 B) and the twelve outputs
// (10 x 294,912 B + 2 x 73,728 B): ~8.85 MB, 0.0026 ms at 3.35 TB/s,
// beside an empty launch of ~0.0017 ms (chip_smoke.py); there is no
// arithmetic to speak of.  Design: one thread per lane position (a, b, c);
// it reads its lane indexes once and, for each field, at most one value
// per lane, and writes one output per lane.  Consecutive threads take
// consecutive positions, so the lane loads and every output store
// coalesce across the warp; the value rows (K = 10 on the main path) of
// neighbouring positions are neighbours, so the scattered value reads hit
// L1/L2.  The field and output pointers and each field's element size
// reach the kernel by value in one parameter struct, filled by the C entry
// point from host arrays: no device-side pointer table, no extra copy.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kMaxFields = 8;
constexpr int kMaxLanes = 2;
constexpr int kThreads = 256;

struct GatherArgs {
  const void* field[kMaxFields];
  int field_bytes[kMaxFields];  // 4: int32, 1: bool
  const int32_t* lane[kMaxLanes];
  void* out[kMaxLanes][kMaxFields];
  int n_fields, n_lanes;
  int64_t n;                    // lane positions, A * B * C
  int64_t bc;                   // B * C
  int c, k;
};

template <typename T>
__device__ __forceinline__ void pick(const GatherArgs& a, int f, int64_t p,
                                     int64_t row, const int32_t (&li)[kMaxLanes],
                                     const bool (&in)[kMaxLanes]) {
  const T* src = (const T*)a.field[f] + row * a.k;
#pragma unroll
  for (int l = 0; l < kMaxLanes; ++l) {
    if (l < a.n_lanes) ((T*)a.out[l][f])[p] = in[l] ? src[li[l]] : T(0);
  }
}

__global__ void __launch_bounds__(kThreads)
    gather_lanes_kernel(const __grid_constant__ GatherArgs a) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= a.n) return;
  const int64_t row = (p / a.bc) * a.c + p % a.c;
  int32_t li[kMaxLanes];
  bool in[kMaxLanes];
#pragma unroll
  for (int l = 0; l < kMaxLanes; ++l) {
    li[l] = l < a.n_lanes ? a.lane[l][p] : -1;
    in[l] = li[l] >= 0 && li[l] < a.k;
  }
#pragma unroll
  for (int f = 0; f < kMaxFields; ++f) {
    if (f >= a.n_fields) break;
    if (a.field_bytes[f] == 4)
      pick<int32_t>(a, f, p, row, li, in);
    else
      pick<uint8_t>(a, f, p, row, li, in);
  }
}

int launch(const GatherArgs& a, void* stream) {
  // one thread a (row, lane position): gridDim.x takes up to 2^31 - 1
  // blocks, so n up to ~5.5e11 positions (900,000 at 100,000 groups x 3)
  const int blocks = (int)((a.n + kThreads - 1) / kThreads);
  gather_lanes_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// fields[n_fields], field_bytes[n_fields], lanes[n_lanes] and
// outs[n_lanes * n_fields] (lane-major) are host arrays of device pointers.
extern "C" int dbt_gather_lanes_multi(const void* const* fields,
                                      const int* field_bytes, int n_fields,
                                      const void* const* lanes, int n_lanes,
                                      void* const* outs, int A, int B, int C,
                                      int K, void* stream) {
  if (n_fields <= 0 || n_fields > kMaxFields || n_lanes <= 0 ||
      n_lanes > kMaxLanes || A <= 0 || B <= 0 || C <= 0 || K <= 0)
    return (int)cudaErrorInvalidValue;
  GatherArgs a = {};
  for (int f = 0; f < n_fields; ++f) {
    if (field_bytes[f] != 4 && field_bytes[f] != 1)
      return (int)cudaErrorInvalidValue;
    a.field[f] = fields[f];
    a.field_bytes[f] = field_bytes[f];
  }
  for (int l = 0; l < n_lanes; ++l) {
    a.lane[l] = (const int32_t*)lanes[l];
    for (int f = 0; f < n_fields; ++f) a.out[l][f] = outs[l * n_fields + f];
  }
  a.n_fields = n_fields;
  a.n_lanes = n_lanes;
  a.bc = (int64_t)B * C;
  a.n = (int64_t)A * a.bc;
  a.c = C;
  a.k = K;
  return launch(a, stream);
}

extern "C" int dbt_gather_lanes(const void* vals, const void* idx, void* out,
                                int G, int K, int M, void* stream) {
  const int bytes = 4;
  void* outs[1] = {out};
  return dbt_gather_lanes_multi(&vals, &bytes, 1, &idx, 1, outs, G, M, 1, K,
                                stream);
}
