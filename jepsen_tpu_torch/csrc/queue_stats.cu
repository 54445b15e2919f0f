// Per-value queue statistics of packed histories, for Hopper (sm_90a).
//
// Replaces the TPU kernel jepsen_tpu/ops/pallas_stats.py::_fused_kernel
// (:76).  For each history b and value id v, over the live rows (mask != 0
// and value >= 0) it computes
//   a  enqueue invokes             e  enqueue oks        x  enqueue fails
//   d  ok dequeue/drain reads      s  least position of an enqueue invoke
//   t  least position of an ok read           (INT32_MAX where there is none)
// into out[b][k][v], k = 0..5 in that order, int32.  A row's position is
// its row index, or pos[b * pos_stride + i] when a pos array is given
// (pos_stride 0 shares one [L] row of positions across the batch).
//
// Bound: bytes.  Every row is read once (int8 f and type, int16 or int32
// value, bool mask: 5 or 7 bytes, 4 more with pos) and 24 bytes are
// written for each (history, value id): 5*B*L + 24*B*V bytes for int16
// values.  The work is a few integer operations per row, far below the
// card's operation rate.
//
// Design: the time goes to bytes in flight, not to operations.  A block
// holds kHist = 4 histories of one value-id tile, 64 threads each, and
// each history has its own six int32 arrays of the tile in shared memory
// (24 bytes per id).  Every load of a chunk is issued before any row is
// tested:
//   - vector path: a thread takes 16 consecutive rows and loads them as
//     one 16-byte load each of f, type and mask, two (int16) or four
//     (int32) of value and four of pos, so that a warp moves 512 bytes
//     per load instruction.  Where L exceeds one chunk of 64 x 16 rows,
//     the next chunk's loads are issued before the current chunk's
//     atomics (a double buffer in registers).  The tile goes out with
//     16-byte stores.  It needs L % 16 == 0, V % 4 == 0 and every array
//     on a 16-byte boundary; the launcher takes it wherever that holds.
//   - scalar path, for any other shape or alignment (a sliced column,
//     odd L or V): a thread loads 16 rows strided by 64 as single
//     elements, all before any test, and stores the tile element by
//     element.
// Rows then update the tile with shared-memory atomics, so a row touches
// only its own value's slots.  Integer atomics commute, so the result
// does not depend on the order in which rows land and is bit-exact
// against the plain PyTorch version.  Several histories per block, and
// several blocks per SM, keep tens of KB of loads in flight per SM while
// other histories zero, update and write out their tiles.  The TPU
// kernel's dense value x row comparison tile is not carried over.  Value
// ids are tiled by at most 2048 (192 KB of shared memory per block at
// the widest tile).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kHist = 4;                     // histories per block
constexpr int kHistThreads = 64;             // threads per history
constexpr int kThreads = kHist * kHistThreads;
constexpr int kRun = 16;                     // rows per thread and chunk
constexpr int kChunk = kHistThreads * kRun;  // rows per history and chunk
constexpr int kMaxTile = 2048;
constexpr int kStats = 6;
constexpr int32_t kInf = 0x7fffffff;
constexpr size_t kDefaultSmem = 48 * 1024;

// Op codes of jepsen_tpu_torch/history/ops.py.
constexpr int kInvoke = 0, kOk = 1, kFail = 2;
constexpr int kEnqueue = 0, kDequeue = 1, kDrain = 2;

struct Args {
  const int8_t* f;
  const int8_t* type;
  const void* value;
  const uint8_t* mask;
  const int32_t* pos;  // null: row index
  long long pos_stride;
  int32_t* out;
  long long B;
  int L, V, tile;
};

// One live-or-not row into history tile `sm` ([kStats][tile]).
__device__ __forceinline__ void add_row(int32_t* sm, int tile, int v0,
                                        int width, int fr, int ty, int raw,
                                        bool live, int32_t p) {
  // Negative values (NO_VALUE) and values of other tiles fall out here.
  if (!live || raw < v0 || raw - v0 >= width) return;
  const int v = raw - v0;
  if (fr == kEnqueue) {
    if (ty == kInvoke) {
      atomicAdd(&sm[v], 1);
      atomicMin(&sm[4 * tile + v], p);
    } else if (ty == kOk) {
      atomicAdd(&sm[tile + v], 1);
    } else if (ty == kFail) {
      atomicAdd(&sm[2 * tile + v], 1);
    }
  } else if ((fr == kDequeue || fr == kDrain) && ty == kOk) {
    atomicAdd(&sm[3 * tile + v], 1);
    atomicMin(&sm[5 * tile + v], p);
  }
}

__device__ __forceinline__ uint32_t word(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

// 16 consecutive rows of one history, as loaded by the vector path.
template <typename ValueT, bool kPos>
struct Run {
  static constexpr int kValueLoads = kRun * sizeof(ValueT) / 16;
  uint4 f, ty, m;
  uint4 v[kValueLoads];
  uint4 p[kPos ? 4 : 1];

  __device__ __forceinline__ void load(const Args& a, long long r,
                                       const int32_t* prow, int i) {
    f = __ldg(reinterpret_cast<const uint4*>(a.f + r));
    ty = __ldg(reinterpret_cast<const uint4*>(a.type + r));
    m = __ldg(reinterpret_cast<const uint4*>(a.mask + r));
    const auto* vv = reinterpret_cast<const uint4*>(
        static_cast<const ValueT*>(a.value) + r);
#pragma unroll
    for (int q = 0; q < kValueLoads; ++q) v[q] = __ldg(vv + q);
    if constexpr (kPos) {
      const auto* pp = reinterpret_cast<const uint4*>(prow + i);
#pragma unroll
      for (int q = 0; q < 4; ++q) p[q] = __ldg(pp + q);
    }
  }

  __device__ __forceinline__ int byte(const uint4& u, int k) const {
    return static_cast<int8_t>(word(u, k >> 2) >> (8 * (k & 3)));
  }

  __device__ __forceinline__ int value(int k) const {
    constexpr int per_word = 4 / sizeof(ValueT);
    const int w = k / per_word;
    return static_cast<ValueT>(word(v[w >> 2], w & 3) >>
                               (32 / per_word * (k % per_word)));
  }

  // Row k of the run, at row index i + k, into the tile.
  __device__ __forceinline__ void add(int32_t* sm, int tile, int v0,
                                      int width, int i) const {
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      const int32_t pk =
          kPos ? static_cast<int32_t>(word(p[k >> 2], k & 3)) : i + k;
      add_row(sm, tile, v0, width, byte(f, k), byte(ty, k), value(k),
              byte(m, k) != 0, pk);
    }
  }
};

template <typename ValueT, bool kVec, bool kPos>
__global__ void __launch_bounds__(kThreads)
queue_stats_kernel(const Args a) {
  extern __shared__ __align__(16) int32_t smem[];  // [kHist][kStats][tile]
  const int h = threadIdx.x / kHistThreads;
  const int j = threadIdx.x % kHistThreads;
  const long long b = static_cast<long long>(blockIdx.x) * kHist + h;
  const bool active = b < a.B;
  const int tile = a.tile;
  const int v0 = blockIdx.y * tile;
  const int width = min(tile, a.V - v0);
  int32_t* sm = smem + h * kStats * tile;

  for (int k = 0; k < kStats; ++k) {
    for (int i = j; i < width; i += kHistThreads) {
      sm[k * tile + i] = k < 4 ? 0 : kInf;
    }
  }
  __syncthreads();

  if (active) {
    const long long row0 = b * a.L;
    const int32_t* prow = a.pos != nullptr ? a.pos + b * a.pos_stride : nullptr;
    if constexpr (kVec) {
      // L % 16 == 0: a thread's run of 16 rows lies wholly in or out.
      Run<ValueT, kPos> cur, nxt;
      int i = kRun * j;
      if (i < a.L) cur.load(a, row0 + i, prow, i);
      while (i < a.L) {
        const int next = i + kChunk;
        if (next < a.L) nxt.load(a, row0 + next, prow, next);
        cur.add(sm, tile, v0, width, i);
        cur = nxt;
        i = next;
      }
    } else {
      const auto* value = static_cast<const ValueT*>(a.value);
      for (int c = 0; c < a.L; c += kChunk) {
        int fr[kRun], ty[kRun], raw[kRun];
        bool live[kRun];
        int32_t p[kRun];
#pragma unroll
        for (int k = 0; k < kRun; ++k) {
          const int i = c + j + k * kHistThreads;
          fr[k] = ty[k] = raw[k] = -1;
          live[k] = false;
          p[k] = 0;
          if (i < a.L) {
            const long long r = row0 + i;
            fr[k] = a.f[r];
            ty[k] = a.type[r];
            raw[k] = static_cast<int>(value[r]);
            live[k] = a.mask[r] != 0;
            p[k] = prow != nullptr ? prow[i] : i;
          }
        }
#pragma unroll
        for (int k = 0; k < kRun; ++k) {
          add_row(sm, tile, v0, width, fr[k], ty[k], raw[k], live[k], p[k]);
        }
      }
    }
  }
  __syncthreads();

  if (active) {
    int32_t* o = a.out + b * kStats * a.V + v0;
    for (int k = 0; k < kStats; ++k) {
      if constexpr (kVec) {
        // V % 4 == 0, so tile, v0 and width are multiples of 4 too.
        for (int i = 4 * j; i < width; i += 4 * kHistThreads) {
          __stcs(reinterpret_cast<int4*>(o + static_cast<long long>(k) * a.V + i),
                 *reinterpret_cast<const int4*>(sm + k * tile + i));
        }
      } else {
        for (int i = j; i < width; i += kHistThreads) {
          o[static_cast<long long>(k) * a.V + i] = sm[k * tile + i];
        }
      }
    }
  }
}

template <typename ValueT, bool kVec, bool kPos>
cudaError_t launch(const Args& a, dim3 grid, size_t smem, cudaStream_t st) {
  auto* kernel = queue_stats_kernel<ValueT, kVec, kPos>;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename ValueT>
cudaError_t launch_value(const Args& a, bool vec, dim3 grid, size_t smem,
                         cudaStream_t st) {
  if (!vec) return launch<ValueT, false, false>(a, grid, smem, st);
  if (a.pos != nullptr) return launch<ValueT, true, true>(a, grid, smem, st);
  return launch<ValueT, true, false>(a, grid, smem, st);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Launches the kernel on `stream` of CUDA device `device` over [B, L]
// row-major columns and a [B, 6, V] int32 output.  value_bytes is 2 (int16 values) or 4 (int32);
// pos may be null, else row b's positions start at pos + b * pos_stride.
// The vector path is taken where L % 16 == 0, V % 4 == 0 and every array
// is 16-byte aligned, else the scalar path; *path (if not null) is set
// to 1 or 0 accordingly.  Allocates nothing, does not synchronise,
// leaves the calling thread's current device as it found it, and returns
// the first CUDA error of the device switch, the shared-memory attribute
// or the launch (0 on success).
extern "C" int queue_stats_launch(const void* f, const void* type,
                                  const void* value, int value_bytes,
                                  const void* mask, const void* pos,
                                  long long pos_stride, void* out,
                                  long long B, int L, int V, int* path,
                                  int device, void* stream) {
  const long long blocks = (B + kHist - 1) / kHist;
  const int tile = V < kMaxTile ? V : kMaxTile;
  const long long tiles = V > 0 ? (static_cast<long long>(V) + tile - 1) / tile : 0;
  if (B <= 0 || blocks > 0x7fffffffLL || L < 0 || V <= 0 || tiles > 65535 ||
      pos_stride < 0 || (value_bytes != 2 && value_bytes != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = L % kRun == 0 && V % 4 == 0 && pos_stride % 4 == 0 &&
                   aligned16(f) && aligned16(type) && aligned16(value) &&
                   aligned16(mask) && aligned16(out) &&
                   (pos == nullptr || aligned16(pos));
  if (path != nullptr) *path = vec;
  const Args a{static_cast<const int8_t*>(f), static_cast<const int8_t*>(type),
               value, static_cast<const uint8_t*>(mask),
               static_cast<const int32_t*>(pos), pos_stride,
               static_cast<int32_t*>(out), B, L, V, tile};
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(tiles));
  const size_t smem = sizeof(int32_t) * kHist * kStats * tile;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e == cudaSuccess && prev != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = value_bytes == 2 ? launch_value<int16_t>(a, vec, grid, smem, st)
                       : launch_value<int32_t>(a, vec, grid, smem, st);
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (e == cudaSuccess) e = back;
  }
  return static_cast<int>(e);
}
