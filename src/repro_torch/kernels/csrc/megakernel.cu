// K2 for Hopper: one segment of the depth-first MeshNet forward, fp32.
// For each output tile and batch member, the segment's k dilated 3x3x3
// conv layers run back to back, each with bias, the folded inference
// BatchNorm (scale, offset) and ReLU; the segment may end in the fused
// 1x1x1 head. Positions outside the true volume are set to zero after
// every layer but the last, which reproduces per-layer 'same' padding.
//
// Replaces the TPU kernel src/repro/kernels/megakernel.py::_segment_kernel.
// That kernel DMAs the tile's haloed input window into VMEM and keeps every
// layer's activation there. On Hopper a d = 16 layer's window alone is
// (t + 32)^3 * 5 * 4 bytes, over 700 KB at any tile, against 227 KB of
// shared memory a block. So here one block takes one (tile, batch member):
//  - the first layer reads its taps straight from the input staging array
//    in device memory through the read-only cache, skipping taps outside
//    the volume (the staging array's border is never read, whatever it
//    holds), as K1 does;
//  - each hidden layer's output, over the tile plus the halo the rest of
//    the segment still needs, goes to dynamic shared memory, ping and pong
//    in turn, with out-of-volume positions selected to 0 (never multiplied:
//    the value may be anything);
//  - the last layer writes the tile into the output staging array at the
//    next segment's halo offset, or, with the head fused, the head's
//    logits, looping over the classes (104 for atlas_104).
// Each thread computes all C outputs of one voxel at a time in registers (C
// is a template parameter: 5, 10, 18, 21), walking the 27 taps in the
// reference's order with the input channels innermost. The segment's
// weights, biases, scales, offsets and head are staged in shared memory
// first. The planner (kernels/megakernel.py::_segment_smem_bytes) prices
// exactly these bytes against one block's 227 KB.
//
// What bounds it on the card: fp32 FMAs, about 1350 operations per voxel
// and layer at C = 5 against 40 bytes, above the fp32 CUDA-core ridge (about
// 20 op/byte on an H100 SXM), plus the halo each segment recomputes
// (MegakernelPlan.operations counts it). The depth-first schedule saves
// device-memory bytes, which this bound does not reward; it pays once the
// convs move to the tensor cores. Later steps to
// make it fast: the first layer's haloed input through TMA into shared
// memory, cluster distributed shared memory so a d = 16 window can span
// the blocks of a cluster, and the C x C products on tensor cores (TF32 or
// bf16 wgmma).
//
// Plain C entry points (bound from Python with ctypes); the launch goes on
// the caller's stream, does not synchronise and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxLayers = 16;
constexpr int kGeomFixed = 22;  // ints before the dilations in the geometry array

struct Geom {
  int B, cin, k, classes;
  int vol[3], tile[3], ntiles[3];
  int in_dims[3], in_halo;
  int out_dims[3], out_halo;
  int n_params, ping, pong;  // shared-memory floats
  int dil[kMaxLayers];
};

template <int C>
__global__ void __launch_bounds__(kThreads)
segment_kernel(const float* __restrict__ x, const float* __restrict__ params,
               float* __restrict__ out, const Geom g) {
  extern __shared__ float smem[];
  float* s_par = smem;
  float* s_ping = smem + g.n_params;
  float* s_pong = s_ping + g.ping;
  for (int i = threadIdx.x; i < g.n_params; i += blockDim.x) s_par[i] = params[i];
  __syncthreads();

  // block -> (tile z, y, x, batch member), batch innermost
  int64_t blk = blockIdx.x;
  const int b = (int)(blk % g.B);
  blk /= g.B;
  const int t2 = (int)(blk % g.ntiles[2]);
  blk /= g.ntiles[2];
  const int t1 = (int)(blk % g.ntiles[1]);
  const int t0 = (int)(blk / g.ntiles[1]);
  const int o0 = t0 * g.tile[0], o1 = t1 * g.tile[1], o2 = t2 * g.tile[2];

  int r = 0;  // halo the layers from here on still need
  for (int l = 0; l < g.k; ++l) r += g.dil[l];

  const float* lp = s_par;  // this layer's parameters
  const float* prev = nullptr;
  int p1 = 0, p2 = 0;  // Y and X extents of prev
  for (int l = 0; l < g.k; ++l) {
    const int d = g.dil[l];
    const int ro = r - d;  // halo of this layer's output
    const int cin = l == 0 ? g.cin : C;
    const float* w = lp;
    const float* bias = w + 27 * cin * C;
    const float* scale = bias + C;
    const float* offset = scale + C;
    lp = offset + C;
    const int s0 = g.tile[0] + 2 * ro, s1 = g.tile[1] + 2 * ro,
              s2 = g.tile[2] + 2 * ro;
    const int nvox = s0 * s1 * s2;
    const bool last = l == g.k - 1;
    float* dst = (l & 1) ? s_pong : s_ping;

    for (int v = threadIdx.x; v < nvox; v += blockDim.x) {
      const int j2 = v % s2;
      const int j1 = (v / s2) % s1;
      const int j0 = v / (s2 * s1);
      // global coordinates of this output voxel
      const int gz = o0 - ro + j0, gy = o1 - ro + j1, gx = o2 - ro + j2;

      float acc[C];
#pragma unroll
      for (int co = 0; co < C; ++co) acc[co] = 0.0f;

      if (l == 0) {
        for (int tz = -1; tz <= 1; ++tz) {
          const int z = gz + tz * d;
          if (z < 0 || z >= g.vol[0]) continue;
          for (int ty = -1; ty <= 1; ++ty) {
            const int y = gy + ty * d;
            if (y < 0 || y >= g.vol[1]) continue;
            for (int tx = -1; tx <= 1; ++tx) {
              const int xx = gx + tx * d;
              if (xx < 0 || xx >= g.vol[2]) continue;
              const float* px =
                  x + ((((int64_t)b * g.in_dims[0] + z + g.in_halo) *
                            g.in_dims[1] + y + g.in_halo) *
                           g.in_dims[2] + xx + g.in_halo) * cin;
              const float* pw =
                  w + (((tz + 1) * 3 + (ty + 1)) * 3 + (tx + 1)) * cin * C;
              for (int ci = 0; ci < cin; ++ci) {
                const float xv = __ldg(px + ci);
#pragma unroll
                for (int co = 0; co < C; ++co)
                  acc[co] = fmaf(xv, pw[ci * C + co], acc[co]);
              }
            }
          }
        }
      } else {
        // prev holds the previous layer over this output grown by d a side
        for (int tz = 0; tz < 3; ++tz) {
          for (int ty = 0; ty < 3; ++ty) {
            for (int tx = 0; tx < 3; ++tx) {
              const float* pp =
                  prev + (((j0 + tz * d) * p1 + (j1 + ty * d)) * p2 +
                          (j2 + tx * d)) * C;
              const float* pw = w + ((tz * 3 + ty) * 3 + tx) * C * C;
#pragma unroll
              for (int ci = 0; ci < C; ++ci) {
                const float xv = pp[ci];
#pragma unroll
                for (int co = 0; co < C; ++co)
                  acc[co] = fmaf(xv, pw[ci * C + co], acc[co]);
              }
            }
          }
        }
      }

#pragma unroll
      for (int co = 0; co < C; ++co)
        acc[co] = fmaxf((acc[co] + bias[co]) * scale[co] + offset[co], 0.0f);

      if (!last) {
        const bool inside = gz >= 0 && gz < g.vol[0] && gy >= 0 &&
                            gy < g.vol[1] && gx >= 0 && gx < g.vol[2];
        float* pd = dst + v * C;
#pragma unroll
        for (int co = 0; co < C; ++co) pd[co] = inside ? acc[co] : 0.0f;
      } else {
        const int64_t at =
            (((int64_t)b * g.out_dims[0] + gz + g.out_halo) * g.out_dims[1] +
             gy + g.out_halo) * g.out_dims[2] + gx + g.out_halo;
        if (g.classes > 0) {
          const float* hw = lp;  // (C, classes), then the classes' biases
          const float* hb = hw + C * g.classes;
          float* po = out + at * g.classes;
          for (int cls = 0; cls < g.classes; ++cls) {
            float s = 0.0f;
#pragma unroll
            for (int co = 0; co < C; ++co) s = fmaf(acc[co], hw[co * g.classes + cls], s);
            po[cls] = s + hb[cls];
          }
        } else {
          float* po = out + at * C;
#pragma unroll
          for (int co = 0; co < C; ++co) po[co] = acc[co];
        }
      }
    }
    __syncthreads();
    prev = dst;
    p1 = s1;
    p2 = s2;
    r = ro;
  }
}

template <int C>
cudaError_t launch(const float* x, const float* params, float* out,
                   const Geom& g, cudaStream_t stream) {
  const size_t smem = (size_t)(g.n_params + g.ping + g.pong) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        segment_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int64_t blocks =
      (int64_t)g.ntiles[0] * g.ntiles[1] * g.ntiles[2] * g.B;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  segment_kernel<C><<<(unsigned)blocks, kThreads, smem, stream>>>(x, params,
                                                                  out, g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Hidden widths this library is instantiated for (PAPER_MODELS use 5, 10,
// 18 and 21).
int repro_megakernel_supports(int c) {
  return c == 5 || c == 10 || c == 18 || c == 21;
}

// x: input staging (B, in_dims, cin) fp32 contiguous, the volume at offset
// in_halo on each axis; params: every layer's w (3, 3, 3, cin_l, C), bias,
// scale and offset (C each), then the head's w (C, classes) and bias when
// classes > 0; out: (B, out_dims, classes or C), written at offset
// out_halo. geom, n ints: B, cin, C, k, classes, vol[3], tile[3],
// in_dims[3], in_halo, out_dims[3], out_halo, n_params, ping, pong, then
// the k dilations. Returns a cudaError_t (0 on success).
int repro_megakernel_segment_f32(const float* x, const float* params,
                                 float* out, const int* geom, int n,
                                 void* stream) {
  if (n < kGeomFixed) return (int)cudaErrorInvalidValue;
  Geom g;
  const int* p = geom;
  g.B = *p++;
  g.cin = *p++;
  const int c = *p++;
  g.k = *p++;
  g.classes = *p++;
  for (int a = 0; a < 3; ++a) g.vol[a] = *p++;
  for (int a = 0; a < 3; ++a) g.tile[a] = *p++;
  for (int a = 0; a < 3; ++a) g.in_dims[a] = *p++;
  g.in_halo = *p++;
  for (int a = 0; a < 3; ++a) g.out_dims[a] = *p++;
  g.out_halo = *p++;
  g.n_params = *p++;
  g.ping = *p++;
  g.pong = *p++;
  if (g.k < 1 || g.k > kMaxLayers || n != kGeomFixed + g.k)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < g.k; ++l) g.dil[l] = *p++;
  for (int a = 0; a < 3; ++a) {
    if (g.tile[a] < 1) return (int)cudaErrorInvalidValue;
    g.ntiles[a] = (g.vol[a] + g.tile[a] - 1) / g.tile[a];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 5:
      return launch<5>(x, params, out, g, s);
    case 10:
      return launch<10>(x, params, out, g, s);
    case 18:
      return launch<18>(x, params, out, g, s);
    case 21:
      return launch<21>(x, params, out, g, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* repro_megakernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
