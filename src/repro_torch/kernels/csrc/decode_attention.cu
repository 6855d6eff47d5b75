// K4 for Hopper: single-token GQA decode attention over a KV cache.
// q (B, 1, H, hd) against k, v (B, S, KV, hd), H = KV * G; slot s takes
// part iff s < n_valid (n_valid = min(pos + 1, S), a host integer, so no
// launch waits to read it); out (B, 1, H, hd) = softmax(q k^T * scale) v,
// in q's type. fp32 and bf16 inputs (template instances), fp32 arithmetic.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// _decode_attn_kernel. That kernel walks the cache in S-blocks of 512 down
// a sequential grid and carries the online-softmax state (acc, max, denom)
// in its outputs from one grid step to the next. Hopper's blocks run in
// parallel and in no order, so here the valid slots [0, n_valid) are cut
// into `nsplit` chunks and each block, one per (chunk, KV head, batch row),
// carries the state of its G query heads through its own chunk in a loop:
//
//   * q's G heads of the group are staged once in shared memory;
//   * K and V rows of the chunk are staged in tiles of `tile` slots
//     (coalesced: a slot's hd values are contiguous) and shared by the G
//     heads, so the cache is read once and never repeated per head;
//   * scores go to shared memory, one warp per head takes their max and
//     sum with warp shuffles and rescales the running state, then every
//     thread adds p * V into the accumulators it owns;
//   * the loop stops at n_valid: slots after pos are masked in the
//     reference, so not reading them is the same function.
//
// With one chunk the block divides acc by max(l, 1e-30) and writes out.
// With several, each block writes its (acc, m, l) to an fp32 scratch
// array and a second kernel combines the chunks, rescaling each by
// exp(m_i - max m), and divides.
//
// What bounds it on the card: bytes. Each valid K/V slot is read once
// (2 * n_valid * KV * hd elements a batch row) against 4 * G floating
// operations per element, far below the ridge, so the bound is the valid
// cache bytes (plus q and out) over the memory rate. The split keeps
// enough blocks in flight to draw that rate: at B = 4, KV = 4 one block
// per (row, head) would be 16 blocks on 132 SMs.
//
// Plain C entry points (bound from Python with ctypes); the launches go on
// the caller's stream, do not synchronise and allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// Shared memory, in floats: q (G * hd), the K tile (tile * (hd + 1): one
// float of padding a row, so the threads of a warp, one slot each, read
// other banks), the V tile (tile * hd), scores (G * tile), acc (G * hd),
// and m, l, corr (G each).
size_t smem_floats(int G, int hd, int tile) {
  return (size_t)G * hd + (size_t)tile * (hd + 1) + (size_t)tile * hd +
         (size_t)G * tile + (size_t)G * hd + 3 * (size_t)G;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ out,
                   float* __restrict__ part, int S, int KV, int G, int hd,
                   int n_valid, int chunk, int tile, float scale) {
  extern __shared__ float smem[];
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int H = KV * G;
  const int kstride = hd + 1;
  const int gh = G * hd;
  float* s_q = smem;
  float* s_k = s_q + gh;
  float* s_v = s_k + tile * kstride;
  float* s_p = s_v + tile * hd;
  float* s_acc = s_p + G * tile;
  float* s_m = s_acc + gh;
  float* s_l = s_m + G;
  float* s_corr = s_l + G;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  // q (B, 1, H, hd): the group's G heads are contiguous.
  const T* qb = q + ((int64_t)b * H + (int64_t)kvh * G) * hd;
  for (int i = tid; i < gh; i += kThreads) {
    s_q[i] = to_float(qb[i]);
    s_acc[i] = 0.0f;
  }
  for (int g = tid; g < G; g += kThreads) {
    s_m[g] = -1e30f;
    s_l[g] = 0.0f;
  }

  const int64_t row = (int64_t)KV * hd;  // elements between two slots
  const T* kb = k + (int64_t)b * S * row + (int64_t)kvh * hd;
  const T* vb = v + (int64_t)b * S * row + (int64_t)kvh * hd;
  const int s_begin = split * chunk;
  const int s_end = min(n_valid, s_begin + chunk);
  __syncthreads();

  for (int t0 = s_begin; t0 < s_end; t0 += tile) {
    const int nt = min(tile, s_end - t0);
    for (int i = tid; i < nt * hd; i += kThreads) {
      const int s = i / hd, d = i - s * hd;
      const int64_t off = (int64_t)(t0 + s) * row + d;
      s_k[s * kstride + d] = to_float(kb[off]);
      s_v[s * hd + d] = to_float(vb[off]);
    }
    __syncthreads();

    for (int i = tid; i < G * tile; i += kThreads) {
      const int g = i / tile, s = i - g * tile;
      if (s < nt) {
        const float* qg = s_q + g * hd;
        const float* ks = s_k + s * kstride;
        float dot = 0.0f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qg[d], ks[d], dot);
        s_p[i] = dot * scale;
      }
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      float* pg = s_p + g * tile;
      float mx = -INFINITY;
      for (int s = lane; s < nt; s += 32) mx = fmaxf(mx, pg[s]);
      mx = warp_max(mx);
      const float m_old = s_m[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int s = lane; s < nt; s += 32) {
        const float e = expf(pg[s] - m_new);
        pg[s] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        s_corr[g] = c;
        s_l[g] = s_l[g] * c + sum;
        s_m[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < gh; i += kThreads) {
      const int g = i / hd, d = i - g * hd;
      const float* pg = s_p + g * tile;
      float a = s_acc[i] * s_corr[g];
      for (int s = 0; s < nt; ++s) a = fmaf(pg[s], s_v[s * hd + d], a);
      s_acc[i] = a;
    }
    __syncthreads();
  }

  if (nsplit == 1) {
    T* ob = out + ((int64_t)b * H + (int64_t)kvh * G) * hd;
    for (int i = tid; i < gh; i += kThreads)
      ob[i] = from_float<T>(s_acc[i] / fmaxf(s_l[i / hd], 1e-30f));
    return;
  }
  // part (B, KV, nsplit, G, hd + 2): acc (G * hd), then m (G), then l (G).
  float* pb = part + (((int64_t)b * KV + kvh) * nsplit + split) * (gh + 2 * G);
  for (int i = tid; i < gh; i += kThreads) pb[i] = s_acc[i];
  for (int g = tid; g < G; g += kThreads) {
    pb[gh + g] = s_m[g];
    pb[gh + G + g] = s_l[g];
  }
}

// One block per (KV head, batch row): each thread combines the chunks of
// the (head, d) entries it owns.
template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ part, T* __restrict__ out, int KV,
               int G, int hd, int nsplit) {
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int gh = G * hd, per = gh + 2 * G;
  const float* pb = part + ((int64_t)b * KV + kvh) * nsplit * per;
  T* ob = out + ((int64_t)b * KV * G + (int64_t)kvh * G) * hd;
  for (int i = threadIdx.x; i < gh; i += kThreads) {
    const int g = i / hd;
    float m = -INFINITY;
    for (int sp = 0; sp < nsplit; ++sp) m = fmaxf(m, pb[sp * per + gh + g]);
    float l = 0.0f, a = 0.0f;
    for (int sp = 0; sp < nsplit; ++sp) {
      const float c = expf(pb[sp * per + gh + g] - m);
      l = fmaf(pb[sp * per + gh + G + g], c, l);
      a = fmaf(pb[sp * per + i], c, a);
    }
    ob[i] = from_float<T>(a / fmaxf(l, 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* part, int B, int S, int KV, int G, int hd,
                   int n_valid, int nsplit, int chunk, cudaStream_t stream) {
  const int tile = hd <= 128 ? 64 : 32;
  const size_t smem = smem_floats(G, hd, tile) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const float scale = 1.0f / sqrtf((float)hd);
  decode_attn_kernel<T><<<dim3(nsplit, KV, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), part, S, KV, G, hd,
      n_valid, chunk, tile, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return e;
  combine_kernel<T><<<dim3(KV, B), kThreads, 0, stream>>>(
      part, static_cast<T*>(out), KV, G, hd, nsplit);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of shared memory one block of the kernel stages.
long long repro_decode_attention_smem_bytes(int G, int hd) {
  return (long long)(smem_floats(G, hd, hd <= 128 ? 64 : 32) * sizeof(float));
}

// q (B, 1, KV * G, hd), k and v (B, S, KV, hd), out like q: contiguous, all
// fp32 (bf16 = 0) or all bf16 (bf16 = 1). Slots [0, n_valid) take part,
// 1 <= n_valid <= S, cut into nsplit chunks of `chunk` slots, each chunk
// non-empty; part: fp32 scratch of B * KV * nsplit * G * (hd + 2) floats
// when nsplit > 1 (else unread). Returns a cudaError_t (0 on success).
int repro_decode_attention(const void* q, const void* k, const void* v,
                           void* out, void* part, int bf16, int B, int S,
                           int KV, int G, int hd, int n_valid, int nsplit,
                           int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, out, p, B, S, KV, G, hd, n_valid,
                                 nsplit, chunk, s);
  return launch<float>(q, k, v, out, p, B, S, KV, G, hd, n_valid, nsplit,
                       chunk, s);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
