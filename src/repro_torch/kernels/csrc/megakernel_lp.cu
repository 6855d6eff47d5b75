// K2r for Hopper: K2's segment at the bf16 and int8w policies. For each
// output tile and batch member, the segment's k dilated 3x3x3 conv layers
// run back to back, each with bias and the fused epilogue
// relu((acc + bias) * scale + offset) (folded BatchNorm, and the int8
// weights' dequant scale), fp32 accumulation over weights widened to fp32;
// the segment may end in the fused 1x1x1 head. Positions outside the true
// volume are set to zero after every layer but the last. With a narrower
// valid Z interval [z_lo, z_hi) in the geometry it is K2r-z, as K2z is K2's
// (megakernel.cu): rows outside it are treated as outside the volume.
//
// Replaces the TPU kernel src/repro/kernels/megakernel.py::_segment_kernel
// at the reference's bf16 and int8w policies (its compute_dtype scratch,
// deq_in and quant_out). What it computes, from the reference's code:
//  - Input: the segment's staging array, bf16 or int8. Under int8w the
//    first segment reads the conformed volume's int8 codes; their fixed
//    scale rides the first layer's epilogue scale, so the codes are taken
//    as they are. A later segment reading int8 staging multiplies each tap
//    value by its channel's dequant scale (deq), in fp32, in its first
//    layer only. The wrapper passes deq = 1 where there is none (x * 1 is
//    x exactly).
//  - Every layer's output is rounded to bf16 (round to nearest even): the
//    reference's ping/pong scratch is at the compute dtype, bf16, so it
//    rounds after every layer, inside a segment too.
//  - The last layer writes a bf16 tile, or, with an int8 output,
//    clip(rint(out / qscale), -127, 127) from its fp32 output: a true IEEE
//    division (__fdiv_rn, never a multiply by the reciprocal) and rintf,
//    which rounds half to even as jnp.round does. With the head fused, the
//    bf16 activations times the head's bf16 weights summed in fp32, plus
//    the fp32 bias, then one round to bf16.
//
// Design, simple first. K2's block of 4 warps per (tile, batch member) and
// K2's item structure: a warp computes M output rows d apart of a chunk of
// up to 32 R voxels along x, each lane R voxels x C channels in fp32
// registers. Every layer's weights are widened once per block into shared
// memory as fp32 (row stride C rounded up to 4), with the bias, scale and
// offset vectors, the head and the scales. The hidden activations are held
// as fp32 values already rounded to bf16, ping and pong at channel stride
// C | 1, so the hidden layers run K2's conv tile core (conv_tile.cuh)
// unchanged. The first layer differs from K2's: its taps are 1- or 2-byte
// values in rows of W * Cin elements, rarely 16-byte aligned, so there is
// no cp.async box; each lane loads its taps from device memory through L1
// (__ldg), widens them in a register (bf16: a shift; int8: a convert) and
// scales them by deq, predicated on the volume's coordinates, so the
// staging array's border is never read, whatever it holds. The sum order
// per voxel is K1's: taps tz, ty, tx from -1 to 1, input channels
// innermost.
//
// What bounds it on the card: the operations. A 5 -> 5 layer does 27 * 25
// multiply-adds a voxel against 20 bytes at 2-byte activations; on the
// bf16 tensor cores that work is below the byte bound, but this kernel runs
// it as fp32 FMAs on the CUDA cores (67 TFLOP/s), like K2, and its first
// layer issues a load, a widening and a deq multiply per R x C FMAs
// besides, as K1r does. A tensor-core K2r is later work; its outline is
// that of K1r's (dilated_conv3d_lp.cu).
//
// Plain C entry points (bound from Python with ctypes); the launch goes on
// the caller's stream, does not synchronise and allocates nothing.

#include <cuda_bf16.h>

#include "conv_tile.cuh"

namespace {

using conv_tile::Blocking;
using conv_tile::ceil4;

constexpr int kMaxLayers = 16;
constexpr int kGeomFixed = 25;  // ints before the dilations in the geometry array
constexpr int kSmemLimit = 232448;

struct Geom {
  int B, cin, k, classes;
  int vol[3], tile[3], ntiles[3];
  int in_dims[3], in_halo;
  int out_dims[3], out_halo;
  int n_params, ping, pong, ring;  // shared-memory floats
  int z_lo, z_hi;  // the valid Z interval, within [0, vol[0]) (K2z: narrower)
  int dil[kMaxLayers];
};

// The layout K2r allocates for g (kernels/megakernel.py::_smem_layout at
// reduced widths): params, ping, pong in floats, and no ring.
template <int C>
bool layout_matches(const Geom& g) {
  constexpr int CP = Blocking<C>::CP;
  int params = 0, ping = 0, pong = 0, r = 0;
  for (int l = 0; l < g.k; ++l) {
    params += 27 * (l == 0 ? g.cin : C) * CP + ceil4(3 * C);
    r += g.dil[l];
  }
  if (g.classes > 0) params += ceil4(C * g.classes + g.classes);
  params += ceil4(g.cin + C);  // deq, qscale
  const int hidden_cs = conv_tile::odd_stride(C);
  for (int l = 0; l + 1 < g.k; ++l) {
    r -= g.dil[l];
    const int vox = ceil4((g.tile[0] + 2 * r) * (g.tile[1] + 2 * r) * (g.tile[2] + 2 * r) * hidden_cs);
    int& buf = (l & 1) ? pong : ping;
    if (vox > buf) buf = vox;
  }
  return params == g.n_params && ping == g.ping && pong == g.pong && g.ring == 0;
}

__device__ __forceinline__ float widen_bf16(uint16_t bits) {
  return __uint_as_float((uint32_t)bits << 16);  // bf16 -> fp32, exact
}
__device__ __forceinline__ float load_tap(const uint16_t* p) { return widen_bf16(__ldg(p)); }
__device__ __forceinline__ float load_tap(const int8_t* p) { return (float)__ldg(p); }
__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

__device__ __forceinline__ float affine_relu(float a, const float* bias, const float* scale, const float* offset,
                                             int co) {
  return fmaxf((a + bias[co]) * scale[co] + offset[co], 0.0f);
}

// The first layer's input row J (-1 .. M) of a warp's group, read from
// device memory: row points at the row's x = 0 (channel 0), gx[k] is lane
// k's output voxel along x, W the volume's x extent. For each x tap and
// input channel ci a lane loads its R taps (zero outside the volume, never
// read there), widens them and scales them by deq[ci], then for each output
// row the row feeds (as conv_tile.cuh's accumulate_rows_j) does R * C FMAs
// with the tap's C weights, read as float4 broadcasts.
template <int R, int C, int CP, int M, int J, typename XT>
__device__ __forceinline__ void accumulate_global_j(float (&acc)[M][R][C], const XT* __restrict__ row,
                                                    const int (&gx)[R], int d, int W, const float* w_tz, int cin,
                                                    const float* deq) {
  constexpr int M_LO = J - 1 > 0 ? J - 1 : 0, M_HI = J + 1 < M - 1 ? J + 1 : M - 1;
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    int off[R];
    bool ok[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int xx = gx[k] + (t - 1) * d;
      ok[k] = xx >= 0 && xx < W;
      off[k] = ok[k] ? xx * cin : 0;
    }
#pragma unroll 1
    for (int ci = 0; ci < cin; ++ci) {
      const float dq = deq[ci];
      float v[R];
#pragma unroll
      for (int k = 0; k < R; ++k) v[k] = ok[k] ? load_tap(row + off[k] + ci) * dq : 0.0f;
#pragma unroll
      for (int m = M_LO; m <= M_HI; ++m) {
        const float* pw = w_tz + ((J - m + 1) * 3 + t) * cin * CP + ci * CP;  // tap row ty = J - m
        float wv[CP];
#pragma unroll
        for (int q = 0; q < CP / 4; ++q) {
          const float4 f = *reinterpret_cast<const float4*>(pw + 4 * q);
          wv[4 * q] = f.x;
          wv[4 * q + 1] = f.y;
          wv[4 * q + 2] = f.z;
          wv[4 * q + 3] = f.w;
        }
#pragma unroll
        for (int k = 0; k < R; ++k)
#pragma unroll
          for (int co = 0; co < C; ++co) acc[m][k][co] = fmaf(v[k], wv[co], acc[m][k][co]);
      }
    }
  }
}

template <int R, int C, int CP, int M, typename XT>
__device__ __forceinline__ void accumulate_global(float (&acc)[M][R][C], const XT* __restrict__ row,
                                                  const int (&gx)[R], int d, int W, const float* w_tz, int cin,
                                                  const float* deq, int j) {
  static_assert(M == 1 || M == 2, "rows a warp: 1 or 2");
  switch (j) {
    case -1:
      accumulate_global_j<R, C, CP, M, -1>(acc, row, gx, d, W, w_tz, cin, deq);
      break;
    case 0:
      accumulate_global_j<R, C, CP, M, 0>(acc, row, gx, d, W, w_tz, cin, deq);
      break;
    case 1:
      accumulate_global_j<R, C, CP, M, 1>(acc, row, gx, d, W, w_tz, cin, deq);
      break;
    default:
      if (M == 2) accumulate_global_j<R, C, CP, M, M == 2 ? 2 : 1>(acc, row, gx, d, W, w_tz, cin, deq);
      break;
  }
}

// XT: the input staging array's element, uint16_t (bf16 bits) or int8_t.
// w_int8: the conv weights are int8 codes (else bf16); out_int8: the last
// layer writes int8 codes (else bf16). At least one block an SM, as K2.
template <int C, typename XT>
__global__ void __launch_bounds__(conv_tile::kThreads, 1)
segment_lp_kernel(const XT* __restrict__ x, const void* __restrict__ wq, const uint16_t* __restrict__ hw,
                  const float* __restrict__ vec, void* __restrict__ out, int w_int8, int out_int8, const Geom g) {
  constexpr int R = Blocking<C>::R, CP = Blocking<C>::CP, X = Blocking<C>::X, M = Blocking<C>::M;
  constexpr int kSteps = 3 * (M + 2);  // (tz, input row j) steps an item
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_par = smem;
  float* s_ping = smem + g.n_params;
  float* s_pong = s_ping + g.ping;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int hcs = conv_tile::odd_stride(C);  // hidden activations' channel stride

  // stage every layer's weights widened to fp32 (row stride CP), its bias,
  // scale, offset (3 C floats, padded to 4), then the head's weights
  // (widened) and biases, then deq (cin) and qscale (C)
  float* s_head = nullptr;
  const float* s_deq;
  const float* s_qs;
  {
    const float* v = vec;
    const int8_t* w8 = static_cast<const int8_t*>(wq);
    const uint16_t* w16 = static_cast<const uint16_t*>(wq);
    float* dst = s_par;
    for (int l = 0; l < g.k; ++l) {
      const int rows = 27 * (l == 0 ? g.cin : C);
      for (int i = tid; i < rows * CP; i += conv_tile::kThreads) {
        const int r = i / CP, co = i - r * CP;
        float val = 0.0f;
        if (co < C) val = w_int8 ? (float)w8[r * C + co] : widen_bf16(w16[r * C + co]);
        dst[i] = val;
      }
      w8 += rows * C;
      w16 += rows * C;
      dst += rows * CP;
      for (int i = tid; i < ceil4(3 * C); i += conv_tile::kThreads) dst[i] = i < 3 * C ? v[i] : 0.0f;
      v += 3 * C;
      dst += ceil4(3 * C);
    }
    if (g.classes > 0) {
      s_head = dst;
      const int nw = C * g.classes;
      for (int i = tid; i < nw; i += conv_tile::kThreads) dst[i] = widen_bf16(hw[i]);
      for (int i = tid; i < g.classes; i += conv_tile::kThreads) dst[nw + i] = v[i];
      v += g.classes;
      dst += ceil4(nw + g.classes);
    }
    for (int i = tid; i < g.cin + C; i += conv_tile::kThreads) dst[i] = v[i];
    s_deq = dst;
    s_qs = dst + g.cin;
  }
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
    const float* bias = w + 27 * cin * CP;
    const float* scale = bias + C;
    const float* offset = scale + C;
    lp = bias + ceil4(3 * C);
    const int s0 = g.tile[0] + 2 * ro, s1 = g.tile[1] + 2 * ro, s2 = g.tile[2] + 2 * ro;
    const int groups = conv_tile::row_groups(s1, d, M);
    const bool last = l == g.k - 1;
    float* dst = (l & 1) ? s_pong : s_ping;

    // the outputs of lane k's voxels in the rows (j0, j1 + m d), chunk at x0
    auto store = [&](float (&acc)[M][R][C], int j0, int j1, int x0) {
      const int gz = o0 - ro + j0;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int jm = j1 + m * d;
        if (jm >= s1) continue;
        const int gy = o1 - ro + jm;
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const int j2 = x0 + lane + 32 * k;
          if (j2 >= s2) continue;
          const int gx = o2 - ro + j2;
          float v[C];
#pragma unroll
          for (int co = 0; co < C; ++co) v[co] = affine_relu(acc[m][k][co], bias, scale, offset, co);
          if (!last) {
            const bool inside = gz >= g.z_lo && gz < g.z_hi && gy >= 0 && gy < g.vol[1] && gx >= 0 && gx < g.vol[2];
            float* pd = dst + ((j0 * s1 + jm) * s2 + j2) * hcs;
#pragma unroll
            for (int co = 0; co < C; ++co) pd[co] = inside ? round_bf16(v[co]) : 0.0f;
          } else {
            const int64_t at = (((int64_t)b * g.out_dims[0] + gz + g.out_halo) * g.out_dims[1] + gy + g.out_halo) *
                                   g.out_dims[2] + gx + g.out_halo;
            if (g.classes > 0) {
              const float* hb = s_head + C * g.classes;
              __nv_bfloat16* po = static_cast<__nv_bfloat16*>(out) + at * g.classes;
#pragma unroll
              for (int co = 0; co < C; ++co) v[co] = round_bf16(v[co]);
              for (int cls = 0; cls < g.classes; ++cls) {
                float sum = 0.0f;
#pragma unroll
                for (int co = 0; co < C; ++co) sum = fmaf(v[co], s_head[co * g.classes + cls], sum);
                po[cls] = __float2bfloat16_rn(sum + hb[cls]);
              }
            } else if (out_int8) {
              int8_t* po = static_cast<int8_t*>(out) + at * C;
#pragma unroll
              for (int co = 0; co < C; ++co) {
                const float q = fminf(fmaxf(rintf(__fdiv_rn(v[co], s_qs[co])), -127.0f), 127.0f);
                po[co] = (int8_t)(int)q;
              }
            } else {
              __nv_bfloat16* po = static_cast<__nv_bfloat16*>(out) + at * C;
#pragma unroll
              for (int co = 0; co < C; ++co) po[co] = __float2bfloat16_rn(v[co]);
            }
          }
        }
      }
    };

    float acc[M][R][C];
    const int nch = (s2 + X - 1) / X;
    const int n_items = s0 * groups * nch;
    if (l == 0) {
      // from the input staging array in device memory; items (z row, row
      // group, chunk) dealt to the warps
      for (int item = warp; item < n_items; item += conv_tile::kWarps) {
        const int zr = item / nch, x0 = (item % nch) * X;
        const int j0 = zr / groups, j1 = conv_tile::group_row(zr % groups, d, M);
        int gx[R];
#pragma unroll
        for (int k = 0; k < R; ++k) gx[k] = o2 - ro + x0 + lane + 32 * k;
        conv_tile::zero(acc);
        for (int s = 0; s < kSteps; ++s) {
          const int tz = s / (M + 2), j = s % (M + 2) - 1;
          const int z = o0 - ro + j0 + (tz - 1) * d;
          const int y = o1 - ro + j1 + j * d;
          if (z < g.z_lo || z >= g.z_hi || y < 0 || y >= g.vol[1]) continue;  // a tap row outside the volume
          const XT* row =
              x + (((int64_t)b * g.in_dims[0] + z + g.in_halo) * g.in_dims[1] + y + g.in_halo) * g.in_dims[2] * cin +
              (int64_t)g.in_halo * cin;
          accumulate_global<R, C, CP, M>(acc, row, gx, d, g.vol[2], w + tz * 9 * cin * CP, cin, s_deq, j);
        }
        store(acc, j0, j1, x0);
      }
    } else {
      // prev holds the previous layer over this region grown by d a side
      for (int item = warp; item < n_items; item += conv_tile::kWarps) {
        const int zr = item / nch, x0 = (item % nch) * X;
        const int j0 = zr / groups, j1 = conv_tile::group_row(zr % groups, d, M);
        int xo[R];
#pragma unroll
        for (int k = 0; k < R; ++k) xo[k] = min(x0 + lane + 32 * k, s2 - 1) * hcs;
        conv_tile::zero(acc);
        for (int s = 0; s < kSteps; ++s) {
          const int tz = s / (M + 2), j = s % (M + 2) - 1;
          const int py = j1 + (j + 1) * d;  // prev's row: past it only rows outside the region read
          if (py >= p1) continue;
          const float* in = prev + ((j0 + tz * d) * p1 + py) * p2 * hcs;
          conv_tile::accumulate_rows<R, C, CP, M, C == 5 ? C : 0>(acc, in, xo, d * hcs, w + tz * 9 * C * CP, C, j);
        }
        store(acc, j0, j1, x0);
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
int occupancy(int x_int8, int smem) {
  if (smem > kSmemLimit) return -1;
  int n = 0;
  if (x_int8) {
    if (cudaFuncSetAttribute(segment_lp_kernel<C, int8_t>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemLimit) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, segment_lp_kernel<C, int8_t>, conv_tile::kThreads,
                                                      (size_t)smem) != cudaSuccess)
      return -1;
  } else {
    if (cudaFuncSetAttribute(segment_lp_kernel<C, uint16_t>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemLimit) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, segment_lp_kernel<C, uint16_t>, conv_tile::kThreads,
                                                      (size_t)smem) != cudaSuccess)
      return -1;
  }
  return n;
}

template <int C, typename XT>
cudaError_t launch_typed(const void* x, const void* w, const void* hw, const float* vec, void* out, int w_int8,
                         int out_int8, const Geom& g, size_t smem, cudaStream_t stream) {
  const auto kernel = segment_lp_kernel<C, XT>;
  if (smem > 48 * 1024) {  // raise the cap to the most, never lower it
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (e != cudaSuccess) return e;
  }
  const int64_t blocks = (int64_t)g.ntiles[0] * g.ntiles[1] * g.ntiles[2] * g.B;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, conv_tile::kThreads, smem, stream>>>(
      static_cast<const XT*>(x), w, static_cast<const uint16_t*>(hw), vec, out, w_int8, out_int8, g);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch(const void* x, int x_int8, const void* w, const void* hw, const float* vec, void* out,
                   int w_int8, int out_int8, const Geom& g, cudaStream_t stream) {
  if (!layout_matches<C>(g)) return cudaErrorInvalidValue;
  if (g.classes > 0 && (hw == nullptr || out_int8)) return cudaErrorInvalidValue;  // the head writes bf16 logits
  const size_t smem = (size_t)(g.n_params + g.ping + g.pong) * sizeof(float);
  if (smem > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  if (x_int8) return launch_typed<C, int8_t>(x, w, hw, vec, out, w_int8, out_int8, g, smem, stream);
  return launch_typed<C, uint16_t>(x, w, hw, vec, out, w_int8, out_int8, g, smem, stream);
}

int parse_geom(const int* geom, int n, Geom& g, int& c) {
  if (n < kGeomFixed) return (int)cudaErrorInvalidValue;
  const int* p = geom;
  g.B = *p++;
  g.cin = *p++;
  c = *p++;
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
  g.ring = *p++;
  g.z_lo = *p++;
  g.z_hi = *p++;
  if (g.k < 1 || g.k > kMaxLayers || n != kGeomFixed + g.k || g.z_lo < 0 || g.z_hi < g.z_lo || g.z_hi > g.vol[0])
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < g.k; ++l) g.dil[l] = *p++;
  for (int a = 0; a < 3; ++a) {
    if (g.tile[a] < 1) return (int)cudaErrorInvalidValue;
    g.ntiles[a] = (g.vol[a] + g.tile[a] - 1) / g.tile[a];
  }
  return 0;
}

int segment(const void* x, int x_int8, const void* w, int w_int8, const void* hw, const float* vec, void* out,
            int out_int8, const int* geom, int n, void* stream) {
  Geom g;
  int c = 0;
  const int e = parse_geom(geom, n, g, c);
  if (e != 0) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 5:
      return (int)launch<5>(x, x_int8, w, hw, vec, out, w_int8, out_int8, g, s);
    case 10:
      return (int)launch<10>(x, x_int8, w, hw, vec, out, w_int8, out_int8, g, s);
    case 18:
      return (int)launch<18>(x, x_int8, w, hw, vec, out, w_int8, out_int8, g, s);
    case 21:
      return (int)launch<21>(x, x_int8, w, hw, vec, out, w_int8, out_int8, g, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Hidden widths this library is instantiated for (PAPER_MODELS use 5, 10,
// 18 and 21), as K2's.
int repro_megakernel_lp_supports(int c) { return c == 5 || c == 10 || c == 18 || c == 21; }

// Blocks of width c, an int8 (x_int8 != 0) or bf16 input staging array,
// with smem bytes of shared memory one SM holds at once (the runtime's
// occupancy calculator); -1 for a width not instantiated or a layout over
// the limit.
int repro_megakernel_lp_blocks_per_sm(int c, int x_int8, int smem) {
  switch (c) {
    case 5:
      return occupancy<5>(x_int8, smem);
    case 10:
      return occupancy<10>(x_int8, smem);
    case 18:
      return occupancy<18>(x_int8, smem);
    case 21:
      return occupancy<21>(x_int8, smem);
    default:
      return -1;
  }
}

// x: input staging (B, in_dims, cin), int8 when x_int8 != 0 else bf16,
// contiguous, the volume at offset in_halo on each axis; w: every layer's
// conv weights (3, 3, 3, cin_l, C), concatenated, bf16 (this entry point)
// or int8 (repro_megakernel_segment_int8w); hw: the head's weights (C,
// classes) bf16 when classes > 0, else null; vec: fp32, every layer's
// bias, scale and offset (C each), the head's bias (classes, when fused),
// the first layer's dequant scales (cin; ones where there are none), the
// last layer's quantisation scales (C; read only when out_int8 != 0);
// out: (B, out_dims, classes or C), int8 codes when out_int8 != 0 else
// bf16, written at offset out_halo. geom as repro_megakernel_segment_f32's
// (ring 0, z_lo and z_hi included). Returns a cudaError_t (0 on success).
int repro_megakernel_segment_bf16(const void* x, int x_int8, const void* w, const void* hw, const float* vec,
                                  void* out, int out_int8, const int* geom, int n, void* stream) {
  return segment(x, x_int8, w, 0, hw, vec, out, out_int8, geom, n, stream);
}

int repro_megakernel_segment_int8w(const void* x, int x_int8, const void* w, const void* hw, const float* vec,
                                   void* out, int out_int8, const int* geom, int n, void* stream) {
  return segment(x, x_int8, w, 1, hw, vec, out, out_int8, geom, n, stream);
}

const char* repro_megakernel_lp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
