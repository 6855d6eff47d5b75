// K3 for Hopper: per-class Dice counts of two label volumes,
// out[c] = [|P_c & T_c|, |P_c|, |T_c|] as int32, for c in [0, C).
//
// Replaces the TPU kernel src/repro/kernels/dice.py::_dice_kernel. That
// kernel streams blocks of 65536 labels through VMEM in a sequential grid
// and carries one (C, 3) accumulator from step to step. Hopper's blocks
// run in parallel and in no order, so here each block counts a grid-stride
// share of the volume into its own counters and adds them into the global
// (C, 3) with one atomicAdd per counter at its end. The global array is
// zeroed by cudaMemsetAsync on the same stream first. Integer addition is
// associative, so the counts do not depend on the order and equal the
// plain version's exactly.
//
// A label outside [0, C) counts nowhere: the reference pads its volumes
// with -1 and -2, and any other value there matches no class either. Both
// label arrays are int32 or int64 (a template pair), so argmax's int64
// output is read as it is, with no cast pass.
//
// What bounds it on the card: bytes. Every label is read once and the
// arithmetic is a few integer operations per label, so the bound is
// N * (sizeof pred + sizeof truth) over the memory rate, 0.060 ms for a
// 256^3 int64/int32 pair at 3.35 TB/s. Each thread keeps kUnroll loads in
// flight so that enough bytes are outstanding to approach that rate.
//
// How it counts: each block keeps 3 * C shared counters (1,248 B at
// C = 104). Each warp groups its lanes by class with __match_any_sync and
// one lane per group adds the group's size, so a warp costs one shared
// atomic per class it holds and column, not one per lane, however few the
// classes are (2 and 3 for the mask and tissue models).
//
// Plain C entry points (bound from Python with ctypes); the launch goes on
// the caller's stream, does not synchronise and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kBlocksPerSM = 4;
constexpr unsigned kFullMask = 0xffffffffu;

// The class of label v, or -1 when v is outside [0, C).
template <typename T>
__device__ __forceinline__ int class_of(T v, int C) {
  return (v >= 0 && v < static_cast<T>(C)) ? static_cast<int>(v) : -1;
}

template <typename TP, typename TT>
__device__ __forceinline__ void load_pair(const TP* __restrict__ pred,
                                          const TT* __restrict__ truth,
                                          int64_t i, int64_t n, int C, int& p,
                                          int& t) {
  p = -1;
  t = -1;
  if (i < n) {
    p = class_of(pred[i], C);
    t = class_of(truth[i], C);
  }
}

// Adds, for each distinct class among the warp's 32 lanes, the number of
// lanes holding it to s[3 * cls + col]; cls < 0 adds nothing.
__device__ __forceinline__ void add_grouped(int* s, int cls, int col, int lane) {
  const unsigned peers = __match_any_sync(kFullMask, cls);
  if (cls >= 0 && lane == __ffs(peers) - 1) atomicAdd(&s[3 * cls + col], __popc(peers));
}

template <typename TP, typename TT>
__global__ void __launch_bounds__(kThreads)
dice_counts_shared(const TP* __restrict__ pred, const TT* __restrict__ truth,
                   int64_t n, int C, int* __restrict__ out) {
  extern __shared__ int s[];  // 3 * C counters
  for (int i = threadIdx.x; i < 3 * C; i += blockDim.x) s[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  // The loop variable is the warp's first index, so all 32 lanes run the
  // same iterations and the full-mask __match_any_sync is legal; lanes past
  // n carry class -1.
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
       base < n; base += kUnroll * stride) {
    int p[kUnroll], t[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      load_pair(pred, truth, base + lane + u * stride, n, C, p[u], t[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      add_grouped(s, p[u], 1, lane);
      add_grouped(s, t[u], 2, lane);
      add_grouped(s, p[u] == t[u] ? p[u] : -1, 0, lane);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * C; i += blockDim.x) {
    const int v = s[i];
    if (v) atomicAdd(&out[i], v);
  }
}

template <typename TP, typename TT>
cudaError_t launch(const void* pred, const void* truth, int64_t n, int C,
                   int* out, cudaStream_t stream) {
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)3 * C * sizeof(int), stream);
  if (e != cudaSuccess || n == 0) return e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int64_t per_block = (int64_t)kThreads * kUnroll;
  int64_t grid = (n + per_block - 1) / per_block;
  if (grid > (int64_t)sms * kBlocksPerSM) grid = (int64_t)sms * kBlocksPerSM;
  const TP* p = static_cast<const TP*>(pred);
  const TT* t = static_cast<const TT*>(truth);
  dice_counts_shared<TP, TT><<<(unsigned)grid, kThreads, (size_t)3 * C * sizeof(int), stream>>>(
      p, t, n, C, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The most classes one block's default 48 KB of dynamic shared memory holds.
int repro_dice_max_classes() { return 48 * 1024 / (3 * (int)sizeof(int)); }

// pred, truth: n contiguous labels each, int64 when *_is64 else int32;
// out: (C, 3) int32, overwritten. n < 2^31 (the counts are int32).
// Returns a cudaError_t (0 on success).
int repro_dice_counts(const void* pred, int pred_is64, const void* truth,
                      int truth_is64, int64_t n, int C, int* out, void* stream) {
  if (C < 1 || C > repro_dice_max_classes() || n < 0 || n > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pred_is64) {
    return truth_is64 ? launch<int64_t, int64_t>(pred, truth, n, C, out, s)
                      : launch<int64_t, int32_t>(pred, truth, n, C, out, s);
  }
  return truth_is64 ? launch<int32_t, int64_t>(pred, truth, n, C, out, s)
                    : launch<int32_t, int32_t>(pred, truth, n, C, out, s);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
