// Per-value queue statistics of packed histories, for Hopper (sm_90a).
//
// Replaces the TPU kernel jepsen_tpu/ops/pallas_stats.py::_fused_kernel.
// For each history b and value id v, over the live rows (mask != 0 and
// value >= 0) it computes
//   a  enqueue invokes             e  enqueue oks        x  enqueue fails
//   d  ok dequeue/drain reads      s  least position of an enqueue invoke
//   t  least position of an ok read           (INT32_MAX where there is none)
// into out[b][k][v], k = 0..5 in that order, int32.  A row's position is
// its row index, or pos[b][i] when a pos array is given.
//
// Bound: bytes.  Every row is read once (int8 f and type, int16 or int32
// value, bool mask: 5 or 7 bytes) and 24 bytes are written for each
// (history, value id): 5*B*L + 24*B*V bytes for int16 values.  The work is
// a few integer operations per row, far below the card's operation rate.
//
// Design: one block per (history, tile of at most 2048 value ids).  The
// tile's six int32 arrays live in shared memory (24 bytes per id, 48 KB at
// most); 256 threads stride over the history's rows, read the narrow
// columns as they are (no widening pass), and update the tile with
// shared-memory atomics, so a row touches only its own value's slots.
// The TPU kernel's dense value x row comparison tile is not carried over.
// Integer atomics commute, so the result does not depend on the order in
// which rows land and is bit-exact against the plain PyTorch version.
// The tile is then written out coalesced.  Any L and V are accepted.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 2048;
constexpr int kStats = 6;
constexpr int32_t kInf = 0x7fffffff;

// Op codes of jepsen_tpu_torch/history/ops.py.
constexpr int8_t kInvoke = 0, kOk = 1, kFail = 2;
constexpr int8_t kEnqueue = 0, kDequeue = 1, kDrain = 2;

template <typename ValueT>
__global__ void __launch_bounds__(kThreads)
queue_stats_kernel(const int8_t* __restrict__ f,
                   const int8_t* __restrict__ type,
                   const ValueT* __restrict__ value,
                   const uint8_t* __restrict__ mask,
                   const int32_t* __restrict__ pos,
                   int32_t* __restrict__ out,
                   int L, int V, int tile) {
  extern __shared__ int32_t sm[];  // [kStats][tile]: a, e, x, d, s, t
  const long long b = blockIdx.x;
  const int v0 = blockIdx.y * tile;
  const int width = min(tile, V - v0);
  int32_t* a = sm;
  int32_t* e = sm + tile;
  int32_t* x = sm + 2 * tile;
  int32_t* d = sm + 3 * tile;
  int32_t* s = sm + 4 * tile;
  int32_t* t = sm + 5 * tile;
  for (int j = threadIdx.x; j < width; j += kThreads) {
    a[j] = 0;
    e[j] = 0;
    x[j] = 0;
    d[j] = 0;
    s[j] = kInf;
    t[j] = kInf;
  }
  __syncthreads();

  const long long row0 = b * L;
  for (int i = threadIdx.x; i < L; i += kThreads) {
    const long long r = row0 + i;
    const int raw = static_cast<int>(value[r]);
    // Negative values (NO_VALUE) and values of other tiles fall out here.
    if (raw < v0 || raw >= v0 + width || mask[r] == 0) continue;
    const int v = raw - v0;
    const int8_t fr = f[r];
    const int8_t ty = type[r];
    const int32_t p = pos != nullptr ? pos[r] : i;
    if (fr == kEnqueue) {
      if (ty == kInvoke) {
        atomicAdd(&a[v], 1);
        atomicMin(&s[v], p);
      } else if (ty == kOk) {
        atomicAdd(&e[v], 1);
      } else if (ty == kFail) {
        atomicAdd(&x[v], 1);
      }
    } else if ((fr == kDequeue || fr == kDrain) && ty == kOk) {
      atomicAdd(&d[v], 1);
      atomicMin(&t[v], p);
    }
  }
  __syncthreads();

  int32_t* o = out + b * kStats * V + v0;
  for (int k = 0; k < kStats; ++k) {
    for (int j = threadIdx.x; j < width; j += kThreads) {
      o[static_cast<long long>(k) * V + j] = sm[k * tile + j];
    }
  }
}

}  // namespace

// Launches the kernel on `stream` over [B, L] row-major columns and a
// [B, 6, V] int32 output.  value_bytes is 2 (int16 values) or 4 (int32);
// pos may be null.  Allocates nothing, does not synchronise, and returns
// cudaGetLastError() (0 on success).
extern "C" int queue_stats_launch(const void* f, const void* type,
                                  const void* value, int value_bytes,
                                  const void* mask, const void* pos,
                                  void* out, long long B, int L, int V,
                                  void* stream) {
  if (B <= 0 || B > 0x7fffffffLL || L < 0 || V <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tile = V < kMaxTile ? V : kMaxTile;
  const dim3 grid(static_cast<unsigned>(B), (V + tile - 1) / tile);
  const size_t smem = sizeof(int32_t) * kStats * tile;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* f8 = static_cast<const int8_t*>(f);
  const auto* t8 = static_cast<const int8_t*>(type);
  const auto* m8 = static_cast<const uint8_t*>(mask);
  const auto* p32 = static_cast<const int32_t*>(pos);
  auto* o32 = static_cast<int32_t*>(out);
  if (value_bytes == 2) {
    queue_stats_kernel<int16_t><<<grid, kThreads, smem, st>>>(
        f8, t8, static_cast<const int16_t*>(value), m8, p32, o32, L, V, tile);
  } else if (value_bytes == 4) {
    queue_stats_kernel<int32_t><<<grid, kThreads, smem, st>>>(
        f8, t8, static_cast<const int32_t*>(value), m8, p32, o32, L, V, tile);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
