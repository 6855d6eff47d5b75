// K4 for Hopper: single-token GQA decode attention over a KV cache, one
// launch a call, `pos` read on the card.
//
// q (B, 1, H, hd) against k, v (B, S, KV, hd), H = KV * G; slot s takes
// part iff s < n_valid = min(pos + 1, S); out (B, 1, H, hd) =
// softmax(q k^T / sqrt(hd)) v in q's type. fp32 and bf16 inputs, fp32
// arithmetic. `pos` is a host int passed as an argument, or a (1,) int32
// in device memory that every block reads, so the launch shape never
// depends on it and a CUDA graph can hold the call and be replayed at any
// position written into that int.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// _decode_attn_kernel, which walks the cache in S-blocks down a sequential
// grid and carries the online-softmax state (acc, max, denom) from one
// grid step to the next in its outputs. Hopper's blocks run in parallel
// and in no order, so here:
//
//   * The grid is fixed, (nsplit, KV, B), nsplit chosen by the wrapper
//     from S and B * KV alone. Each block reads n_valid and takes the
//     chunk [split * n_valid / nsplit, (split + 1) * n_valid / nsplit);
//     each of its 4 warps takes a quarter of that, by the same rule
//     (kernels/decode_attention.py::chunks mirrors it). Slots past n_valid
//     are masked in the reference; not reading them is the same function.
//   * A warp carries its own online-softmax state through its slots, so
//     the loop has no block barrier. It copies K and V rows in tiles of
//     16 slots (8 where a row is over 512 bytes), 16 bytes a copy
//     (cp.async.cg, 4 fp32 or 8 bf16 values), into a ring of kStages
//     stages in shared memory of its own, the next tile in flight while it
//     computes this one; a __syncwarp orders the ring.
//   * q's G heads of the group are staged once in shared memory as fp32,
//     scaled by log2(e) / sqrt(hd) so that the softmax runs on ex2. Every
//     K/V tile is shared by the G heads: the cache is read once.
//   * What holds a warp back is latency, not issue: a tile's work is a few
//     hundred instructions a lane. So the heads a group (GM, rounded up to
//     a power of two) and the head dimension (64, 128 and 256 have their
//     own instances) are template parameters: every loop over a tile
//     unrolls, the state (m, l and the accumulators, G x hd over the
//     warp) lives in registers, and every reduction runs over
//     all heads at once, one shuffle level after the other, so the heads'
//     shuffles overlap. Scores: the two lanes of a slot dot half its K row
//     each with the G heads; the slot's sum, the tile's max and the sum
//     of p over its slots are shuffles. bf16 widens to fp32 in registers.
//     PV: lane owns d = lane + 32 j of every head and adds p * V over the
//     tile's slots.
//   * The block merges its 4 warps, rescaling each by ex2(m_w - max m).
//     With nsplit = 1 it divides by max(l, 1e-30) and writes out. Else it
//     writes (acc, m, l) to an fp32 workspace, and one thread
//     __threadfence()s and counts the block in with an atomicAdd on its
//     (b, KV head) counter; the
//     block that arrives last merges the nsplit chunks the same way (each
//     thread four outputs, kMerge chunks' loads in flight at once), writes
//     out and resets the counter to 0 for the next launch or graph replay.
//     The wrapper allocates the workspace and counters once per shape and
//     keeps them.
//
// What bounds it on the card: bytes. Each valid K/V slot is read once
// (2 * n_valid * KV * hd elements a batch row) against 4 * G floating
// operations per element, far below the ridge. At the served shape
// (TinyLlama: B = 4, H = 32, KV = 4, hd = 64) at pos 255, 2.1 MB of valid
// fp32 cache is 0.63 us at 3.35 TB/s, so launch and memory latency, not
// bytes, set the floor there: one launch, one trip to device memory and
// the merge's trip through L2. So every block issues its first tile
// before it does anything else, a warp's chain of dependent steps is kept
// short, and the nsplit * KV * B blocks (128 at the served shape, about
// one an SM) keep every SM's loads in flight at the longest cache.
//
// Plain C entry points (bound from Python with ctypes); the launch goes on
// the caller's stream, does not synchronise and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;     // tiles of a warp's ring
constexpr int kTile = 16;      // slots of a tile at most: two lanes a slot
constexpr int kMaxG = 16;      // query heads a KV head may have
constexpr int kMaxHd = 256;    // head dimension at most (8 values a lane)
constexpr int kMerge = 8;      // chunks the last block loads at once, a thread
constexpr float kNoScore = -1e30f;  // the state's start: the reference's mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

// 16 bytes of T as floats.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void widen(const unsigned char* p, float* f) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void widen(const unsigned char* p, float* f) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

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

// 2^x, the hardware's approximation (relative error below 2^-22).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Floats of one chunk's partial row: acc (G * hd), then m (G) and l (G),
// padded to a multiple of 4 so that every row starts 16-byte aligned.
__host__ __device__ inline int partial_floats(int G, int hd) { return G * hd + ((2 * G + 3) & ~3); }

// Shared memory, in bytes: q (G * hd fp32), then per warp its ring
// (kStages x a K tile and a V tile of ts rows: kTile, or half that where a
// row is over 512 bytes, so that a block fits at hd 256 in fp32; each row
// hd values and 32 bytes of padding, so that the slots one 128-bit load
// phase reads sit in other banks), its tile's p (kTile x kMaxG fp32) and
// its final (m, l)
// (2 x kMaxG fp32); then the last-block flag. After its loop a warp keeps
// its accumulators (G * hd fp32) where its ring was. Every part is a
// multiple of 16 bytes.
struct Layout {
  int nv;      // 16-byte vectors in a slot's row
  int ts;      // slots of a tile
  int stride;  // bytes between two rows of a tile
  int tile;    // bytes of one K (or V) tile
  int warp;    // bytes of one warp's region
  int q;       // bytes of q
  __host__ __device__ Layout(int G, int hd, int elem) {
    const int row = hd * elem;
    nv = row / 16;
    ts = row > 512 ? kTile / 2 : kTile;
    stride = row + 32;
    tile = ts * stride;
    warp = kStages * 2 * tile + 4 * kTile * kMaxG + 4 * 2 * kMaxG;
    q = 4 * G * hd;
  }
  __host__ __device__ size_t bytes() const { return (size_t)q + (size_t)kWarps * warp + 16; }
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* part;         // (B * KV, nsplit, partial_floats(G, hd)) when nsplit > 1
  int* count;          // (B * KV) arrivals, 0 between launches
  const int* pos_dev;  // the position in device memory, or null
  int pos;             // the position, when pos_dev is null
  int S, KV, G, hd, nsplit;
  float qscale;        // log2(e) / sqrt(hd)
};

// GM: the group's G heads rounded up to a power of two; HD: the head
// dimension, or 0 for any (read from the arguments). With HD known every
// loop over a row unrolls, and a lane owns DL = ceil(HD / 32) values of it
// in PV.
template <typename T, int GM, int HD>
__global__ void __launch_bounds__(kThreads) decode_attn_kernel(const Args a) {
  constexpr int VEC = Vec<T>::N;
  constexpr int DL = HD > 0 ? (HD + 31) / 32 : kMaxHd / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hd = HD > 0 ? HD : a.hd;
  const int G = a.G, KV = a.KV, S = a.S, nsplit = a.nsplit;
  const int gh = G * hd, H = KV * G;
  const Layout lay(G, hd, (int)sizeof(T));

  // Warp w's region: its ring (later its accumulators), p and final (m, l).
  auto region = [&](int w) { return smem + lay.q + w * lay.warp; };
  auto ml_of = [&](int w) { return reinterpret_cast<float*>(region(w) + kStages * 2 * lay.tile) + kTile * kMaxG; };
  float* q_s = reinterpret_cast<float*>(smem);
  unsigned char* ring = region(warp);
  float* p_s = reinterpret_cast<float*>(ring + kStages * 2 * lay.tile);
  int* last_s = reinterpret_cast<int*>(region(kWarps));

  // This block's chunk of [0, n_valid), then this warp's quarter of it.
  const long long pos = a.pos_dev != nullptr ? (long long)*a.pos_dev : (long long)a.pos;
  const int n_valid = (int)max(0LL, min(pos + 1, (long long)S));
  const int c0 = (int)((long long)split * n_valid / nsplit);
  const int c1 = (int)((long long)(split + 1) * n_valid / nsplit);
  const int w0 = c0 + (c1 - c0) * warp / kWarps;
  const int w1 = c0 + (c1 - c0) * (warp + 1) / kWarps;
  const int ntiles = (w1 - w0 + lay.ts - 1) / lay.ts;

  const int64_t row = (int64_t)KV * hd;  // elements between two slots
  const T* kb = static_cast<const T*>(a.k) + (int64_t)b * S * row + (int64_t)kvh * hd;
  const T* vb = static_cast<const T*>(a.v) + (int64_t)b * S * row + (int64_t)kvh * hd;

  // Copy tile t's K and V rows into its stage; one commit group a tile,
  // empty past the last.
  auto issue = [&](int t) {
    if (t < ntiles) {
      const int s0 = w0 + t * lay.ts, ns = min(lay.ts, w1 - s0);
      unsigned char* kt = ring + (t % kStages) * 2 * lay.tile;
      for (int i = lane; i < 2 * ns * lay.nv; i += 32) {
        const int r = i / lay.nv, c = i - r * lay.nv;
        const bool is_v = r >= ns;
        const int s = is_v ? r - ns : r;
        cp_async16(kt + (is_v ? lay.tile : 0) + s * lay.stride + c * 16,
                   (is_v ? vb : kb) + (int64_t)(s0 + s) * row + c * VEC);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t);

  const T* qb = static_cast<const T*>(a.q) + ((int64_t)b * H + (int64_t)kvh * G) * hd;
  for (int i = tid; i < gh; i += kThreads) q_s[i] = to_float(qb[i]) * a.qscale;
  __syncthreads();

  float m[GM], l[GM], acc[GM][DL];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kNoScore;
    l[g] = 0.0f;
#pragma unroll
    for (int j = 0; j < DL; ++j) acc[g][j] = 0.0f;
  }
  const int my_slot = lane >> 1, my_part = lane & 1;

  for (int t = 0; t < ntiles; ++t) {
    issue(t + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const int ns = min(lay.ts, w1 - (w0 + t * lay.ts));
    const bool mine = my_slot < ns;
    const unsigned char* kt = ring + (t % kStages) * 2 * lay.tile;
    const unsigned char* vt = kt + lay.tile;

    // Scores of this lane's slot: half its K row each lane, then the pair.
    float x[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) x[g] = 0.0f;
    if (mine) {
      const unsigned char* krow = kt + my_slot * lay.stride;
#pragma unroll
      for (int cc = 0; cc < (lay.nv + 1) / 2; ++cc) {
        const int c = 2 * cc + my_part;
        if (c >= lay.nv) break;
        float kf[VEC];
        Vec<T>::widen(krow + c * 16, kf);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g < G) {
            const float4* qg = reinterpret_cast<const float4*>(q_s + g * hd + c * VEC);
#pragma unroll
            for (int e = 0; e < VEC / 4; ++e) {
              const float4 qq = qg[e];
              x[g] = fmaf(qq.x, kf[4 * e], x[g]);
              x[g] = fmaf(qq.y, kf[4 * e + 1], x[g]);
              x[g] = fmaf(qq.z, kf[4 * e + 2], x[g]);
              x[g] = fmaf(qq.w, kf[4 * e + 3], x[g]);
            }
          }
        }
      }
    }
    // The online softmax over the tile, every head's shuffles at once.
    float mx[GM], p[GM], corr[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      x[g] += __shfl_xor_sync(kFull, x[g], 1);
      mx[g] = mine ? x[g] : -INFINITY;
    }
#pragma unroll
    for (int o = 2; o < 32; o <<= 1) {
#pragma unroll
      for (int g = 0; g < GM; ++g) mx[g] = fmaxf(mx[g], __shfl_xor_sync(kFull, mx[g], o));
    }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float m_new = fmaxf(m[g], mx[g]);
      p[g] = mine ? ex2(x[g] - m_new) : 0.0f;
      corr[g] = ex2(m[g] - m_new);
      m[g] = m_new;
      mx[g] = p[g];  // the slots' sum, below
    }
#pragma unroll
    for (int o = 2; o < 32; o <<= 1) {
#pragma unroll
      for (int g = 0; g < GM; ++g) mx[g] += __shfl_xor_sync(kFull, mx[g], o);
    }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      l[g] = fmaf(l[g], corr[g], mx[g]);
#pragma unroll
      for (int j = 0; j < DL; ++j) acc[g][j] *= corr[g];
    }
    if (my_part == 0) {
#pragma unroll
      for (int g = 0; g < GM; ++g) p_s[my_slot * kMaxG + g] = p[g];
    }
    __syncwarp();

    // acc[g][d] += sum over the tile's slots of p[g][s] * V[s][d].
#pragma unroll
    for (int s = 0; s < kTile; ++s) {
      if (s >= ns) break;
      const T* vrow = reinterpret_cast<const T*>(vt + s * lay.stride);
      float vv[DL], pp[GM];
#pragma unroll
      for (int j = 0; j < DL; ++j) vv[j] = lane + 32 * j < hd ? to_float(vrow[lane + 32 * j]) : 0.0f;
#pragma unroll
      for (int g = 0; g < GM; ++g) pp[g] = p_s[s * kMaxG + g];
#pragma unroll
      for (int g = 0; g < GM; ++g) {
#pragma unroll
        for (int j = 0; j < DL; ++j) acc[g][j] = fmaf(pp[g], vv[j], acc[g][j]);
      }
    }
    __syncwarp();  // the next issue refills this stage, and p_s
  }
  cp_async_wait<0>();
  __syncwarp();

  // This warp's accumulators where its ring was, and its (m, l).
  float* acc_w = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int j = 0; j < DL; ++j) {
      if (g < G && lane + 32 * j < hd) acc_w[g * hd + lane + 32 * j] = acc[g][j];
    }
  }
  if (lane == 0) {
    float* ml = ml_of(warp);
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      ml[g] = m[g];
      ml[kMaxG + g] = l[g];
    }
  }
  __syncthreads();

  // Merge the 4 warps: (acc, m, l) of the block's chunk.
  const int bkv = b * KV + kvh;
  const int per = partial_floats(G, hd);
  T* ob = static_cast<T*>(a.out) + ((int64_t)b * H + (int64_t)kvh * G) * hd;
  for (int i = tid; i < gh; i += kThreads) {
    const int g = i / hd;
    float mx = kNoScore;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, ml_of(w)[g]);
    float sum = 0.0f, den = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = ex2(ml_of(w)[g] - mx);
      sum = fmaf(reinterpret_cast<const float*>(region(w))[i], c, sum);
      den = fmaf(ml_of(w)[kMaxG + g], c, den);
    }
    if (nsplit == 1) {
      ob[i] = from_float<T>(sum / fmaxf(den, 1e-30f));
    } else {
      float* pb = a.part + ((int64_t)bkv * nsplit + split) * per;
      pb[i] = sum;
      if (i - g * hd == 0) {
        pb[gh + g] = mx;
        pb[gh + G + g] = den;
      }
    }
  }
  if (nsplit == 1) return;

  // Count in; the last block of this (b, KV head) merges the chunks. One
  // thread fences the block's writes, counts, and fences again, as
  // cooperative groups' grid barrier does.
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    *last_s = atomicAdd(a.count + bkv, 1) == nsplit - 1;
    __threadfence();
  }
  __syncthreads();
  if (!*last_s) return;
  // Each thread merges 4 neighbouring outputs of one head over the
  // chunks, kMerge chunks at a time: their (m, l) and a 16-byte load of
  // their acc all in flight at once, then an online rescale.
  const float* pr = a.part + (int64_t)bkv * nsplit * per;
  for (int i4 = tid; i4 < gh / 4; i4 += kThreads) {
    const int g = 4 * i4 / hd;
    float mx = kNoScore, den = 0.0f;
    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int sp0 = 0; sp0 < nsplit; sp0 += kMerge) {
      float ms[kMerge], ls[kMerge];
      float4 vs[kMerge];
#pragma unroll
      for (int j = 0; j < kMerge; ++j) {
        const float* prow = pr + (int64_t)min(sp0 + j, nsplit - 1) * per;
        ms[j] = sp0 + j < nsplit ? __ldcg(prow + gh + g) : kNoScore;
        ls[j] = __ldcg(prow + gh + G + g);
        vs[j] = __ldcg(reinterpret_cast<const float4*>(prow) + i4);
      }
      float top = mx;
#pragma unroll
      for (int j = 0; j < kMerge; ++j) top = fmaxf(top, ms[j]);
      const float c0 = ex2(mx - top);
      den *= c0;
      sum = make_float4(sum.x * c0, sum.y * c0, sum.z * c0, sum.w * c0);
#pragma unroll
      for (int j = 0; j < kMerge; ++j) {
        const float c = ex2(ms[j] - top);  // 0 for the slots past nsplit
        den = fmaf(ls[j], c, den);
        sum = make_float4(fmaf(vs[j].x, c, sum.x), fmaf(vs[j].y, c, sum.y), fmaf(vs[j].z, c, sum.z),
                          fmaf(vs[j].w, c, sum.w));
      }
      mx = top;
    }
    const float d = fmaxf(den, 1e-30f);
    ob[4 * i4] = from_float<T>(sum.x / d);
    ob[4 * i4 + 1] = from_float<T>(sum.y / d);
    ob[4 * i4 + 2] = from_float<T>(sum.z / d);
    ob[4 * i4 + 3] = from_float<T>(sum.w / d);
  }
  if (tid == 0) a.count[bkv] = 0;
}

template <typename T, int GM, int HD>
cudaError_t launch_as(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = Layout(a.G, a.hd, (int)sizeof(T)).bytes();
  // The opt-in above 48 KB is a property of the function on a device: set
  // it once for the largest size asked there, so that a call inside a graph
  // capture finds it set.
  static size_t opted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > opted[dev]) {
    e = cudaFuncSetAttribute(decode_attn_kernel<T, GM, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    opted[dev] = smem;
  }
  decode_attn_kernel<T, GM, HD><<<dim3(a.nsplit, a.KV, B), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The head dimensions of the port's dense models get a kernel of their own.
template <typename T, int GM>
cudaError_t launch_g(const Args& a, int B, cudaStream_t stream) {
  switch (a.hd) {
    case 64: return launch_as<T, GM, 64>(a, B, stream);
    case 128: return launch_as<T, GM, 128>(a, B, stream);
    case 256: return launch_as<T, GM, 256>(a, B, stream);
    default: return launch_as<T, GM, 0>(a, B, stream);
  }
}

template <typename T>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  if (a.G <= 1) return launch_g<T, 1>(a, B, stream);
  if (a.G <= 2) return launch_g<T, 2>(a, B, stream);
  if (a.G <= 4) return launch_g<T, 4>(a, B, stream);
  if (a.G <= 8) return launch_g<T, 8>(a, B, stream);
  return launch_g<T, 16>(a, B, stream);
}

}  // namespace

extern "C" {

// Bytes of shared memory one block takes at G heads a group, head dim hd
// and elements of `elem` bytes (4 fp32, 2 bf16).
long long repro_decode_attention_smem_bytes(int G, int hd, int elem) {
  return (long long)Layout(G, hd, elem).bytes();
}

// The most query heads a KV head may have, and the largest head dimension.
int repro_decode_attention_max_group(void) { return kMaxG; }
int repro_decode_attention_max_head_dim(void) { return kMaxHd; }

// Floats of the workspace a chunk takes.
int repro_decode_attention_partial_floats(int G, int hd) { return partial_floats(G, hd); }

// q (B, 1, KV * G, hd), k and v (B, S, KV, hd), out like q: contiguous, all
// fp32 (bf16 = 0) or all bf16 (bf16 = 1); k and v 16-byte aligned with hd
// values a multiple of 16 bytes; 1 <= G and hd within the most above.
// Slots [0, min(pos + 1, S)) take part, pos = *pos_dev when pos_dev is not
// null, else pos. The grid is (nsplit, KV, B); with nsplit > 1, part is an
// fp32 workspace of B * KV * nsplit * partial_floats(G, hd) floats (16-byte
// aligned) and count B * KV ints, all 0 before the first launch (each
// launch leaves them 0). Returns a cudaError_t (0 on success).
int repro_decode_attention(const void* q, const void* k, const void* v, void* out, void* part, void* count,
                           const void* pos_dev, int pos, int bf16, int B, int S, int KV, int G, int hd, int nsplit,
                           void* stream) {
  if (G < 1 || G > kMaxG || hd > kMaxHd) return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.part = static_cast<float*>(part);
  a.count = static_cast<int*>(count);
  a.pos_dev = static_cast<const int*>(pos_dev);
  a.pos = pos;
  a.S = S;
  a.KV = KV;
  a.G = G;
  a.hd = hd;
  a.nsplit = nsplit;
  a.qscale = kLog2e / sqrtf((float)hd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(a, B, s) : launch<float>(a, B, s);
}

const char* repro_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
