// K2 for Hopper: one segment of the depth-first MeshNet forward, fp32.
// For each output tile and batch member, the segment's k dilated 3x3x3
// conv layers run back to back, each with bias, the folded inference
// BatchNorm (scale, offset) and ReLU; the segment may end in the fused
// 1x1x1 head. Positions outside the true volume are set to zero after
// every layer but the last, which reproduces per-layer 'same' padding.
// K2z is this kernel with a narrower valid Z interval [z_lo, z_hi) in the
// geometry (the reference's has_z_bounds): the sharded executor's window of
// a slab and its halo holds the true volume's Z edges inside it, and rows
// outside the interval are read and written as rows outside the volume. The
// full interval [0, vol[0]) is plain K2. A band [band_lo, band_hi) of output
// rows (the rows a sharded window's later segments read) narrows the launch:
// its grid covers only the Z tiles that meet the band, it reads no input row
// farther than the segment's halo from the band, and it writes only the
// band's rows; the default band is the whole tile-padded region.
//
// Replaces the TPU kernel src/repro/kernels/megakernel.py::_segment_kernel.
// That kernel DMAs the tile's haloed input window into VMEM and keeps every
// layer's activation there. On Hopper a d = 16 layer's window alone is
// (t + 32)^3 * 5 * 4 bytes, over 700 KB at any tile, against 227 KB of
// shared memory a block. So here one block of 4 warps takes one (tile,
// batch member), and every layer runs on the conv tile core that K1 uses
// (conv_tile.cuh): a warp computes a chunk of M rows d apart of the
// layer's output region, each lane R voxels x C channels a row in
// registers.
//  - The first layer stages its taps from the input staging array: per
//    (tz, input row) one box through cp.async into the warp's
//    double-buffered ring (one for each warp that has rows, at most 4),
//    the copies predicated on the true volume's
//    coordinates, so the staging array's halo border is never read,
//    whatever it holds (zero fill outside the volume).
//  - Each hidden layer's output, over the tile plus the halo the rest of
//    the segment still needs, goes to dynamic shared memory, ping and pong
//    in turn (channel stride C | 1, odd, so the next layer's 32 lanes read
//    32 banks), out-of-volume positions selected to 0 (never multiplied:
//    the value may be anything). The next layer reads it through the same
//    register-blocked loop.
//  - The last layer writes the tile into the output staging array at the
//    next segment's halo offset, or, with the head fused, the head's
//    logits, looping over the classes (104 for atlas_104).
// Every voxel sums its taps in K1's order (tz, ty, tx, input channels
// innermost). The segment's weights (row stride C rounded up to 4),
// biases, scales, offsets and head are staged in shared memory first.
//
// What bounds it on the card: fp32 FMAs, about 1350 operations per voxel
// and layer at C = 5 against 40 bytes, above the fp32 CUDA-core ridge (about
// 20 op/byte on an H100 SXM), plus the halo each multi-layer segment
// recomputes. The core issues 44 shared-memory loads per 240 FFMAs at
// C = 5, and the first layer copies each input value from L2 6 times (one
// box per (tz, input row), two output rows a warp; conv_tile.cuh has the
// counts for every width). The planner (kernels/megakernel.py) prices each
// segment's time: its multiply-adds as the warps issue them (idle lanes and
// warps included) over the FMA rate, against its bytes, both scaled by the
// wave quantisation of its blocks on the 132 SMs; so it keeps one-layer
// segments wherever the halo recompute costs more than the device memory
// it saves. Its _smem_layout prices exactly what a block allocates; this
// file checks every launch's geometry against the same layout.
//
// Plain C entry points (bound from Python with ctypes); the launch goes on
// the caller's stream, does not synchronise and allocates nothing.

#include "conv_tile.cuh"

namespace {

using conv_tile::Blocking;
using conv_tile::Box;

constexpr int kMaxLayers = 16;
constexpr int kGeomFixed = 27;  // ints before the dilations in the geometry array
constexpr int kSmemLimit = 232448;

using conv_tile::ceil4;

struct Geom {
  int B, cin, k, classes;
  int vol[3], tile[3], ntiles[3];
  int in_dims[3], in_halo;
  int out_dims[3], out_halo;
  int n_params, ping, pong, ring;  // shared-memory floats
  int z_lo, z_hi;  // the valid Z interval, within [0, vol[0]) (K2z: narrower)
  int band_lo, band_hi;  // the output rows written, within the tile-padded region
  int t0_lo;             // the first Z tile that meets the band
  int dil[kMaxLayers];
};

// The first layer's chunk: its output region's x extent, at most 32 R.
__host__ __device__ inline Box first_box(int x_max, int s2, int d, int cin) {
  return conv_tile::make_box(s2 < x_max ? s2 : x_max, d, cin);
}

// The layout K2 allocates for g (what kernels/megakernel.py::_smem_layout
// prices): params, ping, pong, ring in floats.
template <int C>
bool layout_matches(const Geom& g) {
  constexpr int CP = Blocking<C>::CP, M = Blocking<C>::M;
  int params = 0, ping = 0, pong = 0, r = 0;
  for (int l = 0; l < g.k; ++l) {
    params += 27 * (l == 0 ? g.cin : C) * CP + ceil4(3 * C);
    r += g.dil[l];
  }
  if (g.classes > 0) params += ceil4(C * g.classes + g.classes);
  const int hidden_cs = conv_tile::odd_stride(C);
  for (int l = 0; l + 1 < g.k; ++l) {
    r -= g.dil[l];
    const int vox = ceil4((g.tile[0] + 2 * r) * (g.tile[1] + 2 * r) * (g.tile[2] + 2 * r) * hidden_cs);
    int& buf = (l & 1) ? pong : ping;
    if (vox > buf) buf = vox;
  }
  int ro0 = 0;  // the first layer's output halo
  for (int l = 1; l < g.k; ++l) ro0 += g.dil[l];
  const int s1 = g.tile[1] + 2 * ro0, s2 = g.tile[2] + 2 * ro0;
  const Box box = first_box(Blocking<C>::X, s2, g.dil[0], g.cin);
  const int items = (g.tile[0] + 2 * ro0) * conv_tile::row_groups(s1, g.dil[0], M) * ((s2 + box.tx - 1) / box.tx);
  const int stagers = items < conv_tile::kWarps ? items : conv_tile::kWarps;  // warps that have a first-layer item
  const int ring = stagers * conv_tile::kStages * conv_tile::slot_floats(box.width, conv_tile::odd_stride(g.cin));
  return params == g.n_params && ping == g.ping && pong == g.pong && ring == g.ring;
}

__device__ __forceinline__ float affine_relu(float a, const float* bias, const float* scale, const float* offset,
                                             int co) {
  return fmaxf((a + bias[co]) * scale[co] + offset[co], 0.0f);
}

// CIN: the first layer's input channels when the compiler may know them
// (1 or 5, at C = 5), else 0 (read at run time).
// At least one block an SM: left to its default, ptxas holds K2 to 168
// registers (3 blocks an SM) and spills; with the bound it takes 204-228
// and spills nothing (2 blocks an SM).
template <int C, int CIN>
__global__ void __launch_bounds__(conv_tile::kThreads, 1)
segment_kernel(const float* __restrict__ x, const float* __restrict__ params,
               float* __restrict__ out, const Geom g) {
  constexpr int R = Blocking<C>::R, CP = Blocking<C>::CP, X = Blocking<C>::X, M = Blocking<C>::M;
  constexpr int kSteps = 3 * (M + 2);  // (tz, input row j) boxes an item
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_par = smem;
  float* s_ping = smem + g.n_params;
  float* s_pong = s_ping + g.ping;
  float* s_ring = s_pong + g.pong;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int hcs = conv_tile::odd_stride(C);  // hidden activations' channel stride

  // stage every layer's weights (row stride CP), bias, scale, offset
  // (3 C floats, padded to 4), then the head's weights and biases
  {
    const float* src = params;
    float* dst = s_par;
    for (int l = 0; l < g.k; ++l) {
      const int rows = 27 * (l == 0 ? g.cin : C);
      conv_tile::stage_weights<C, CP>(dst, src, rows, tid, conv_tile::kThreads);
      src += rows * C;
      dst += rows * CP;
      for (int i = tid; i < ceil4(3 * C); i += conv_tile::kThreads) dst[i] = i < 3 * C ? src[i] : 0.0f;
      src += 3 * C;
      dst += ceil4(3 * C);
    }
    const int head = g.classes > 0 ? C * g.classes + g.classes : 0;
    for (int i = tid; i < head; i += conv_tile::kThreads) dst[i] = src[i];
  }
  __syncthreads();

  // block -> (tile z, y, x, batch member), batch innermost
  int64_t blk = blockIdx.x;
  const int b = (int)(blk % g.B);
  blk /= g.B;
  const int t2 = (int)(blk % g.ntiles[2]);
  blk /= g.ntiles[2];
  const int t1 = (int)(blk % g.ntiles[1]);
  const int t0 = g.t0_lo + (int)(blk / g.ntiles[1]);
  const int o0 = t0 * g.tile[0], o1 = t1 * g.tile[1], o2 = t2 * g.tile[2];

  int r = 0;  // halo the layers from here on still need
  for (int l = 0; l < g.k; ++l) r += g.dil[l];
  // the input rows read: the valid interval within the segment's halo of the band
  const int zin_lo = max(g.z_lo, g.band_lo - r), zin_hi = min(g.z_hi, g.band_hi + r);

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
    auto store = [&](float (&acc)[M][R][C], int j0, int j1, int x0, int tx) {
      const int gz = o0 - ro + j0;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int jm = j1 + m * d;
        if (jm >= s1) continue;
        const int gy = o1 - ro + jm;
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const int xl = lane + 32 * k, j2 = x0 + xl;
          if (xl >= tx || j2 >= s2) continue;
          const int gx = o2 - ro + j2;
          float v[C];
#pragma unroll
          for (int co = 0; co < C; ++co) v[co] = affine_relu(acc[m][k][co], bias, scale, offset, co);
          if (!last) {
            const bool inside = gz >= g.z_lo && gz < g.z_hi && gy >= 0 && gy < g.vol[1] && gx >= 0 && gx < g.vol[2];
            float* pd = dst + ((j0 * s1 + jm) * s2 + j2) * hcs;
#pragma unroll
            for (int co = 0; co < C; ++co) pd[co] = inside ? v[co] : 0.0f;
          } else if (gz >= g.band_lo && gz < g.band_hi) {
            const int64_t at = (((int64_t)b * g.out_dims[0] + gz + g.out_halo) * g.out_dims[1] + gy + g.out_halo) *
                                   g.out_dims[2] + gx + g.out_halo;
            if (g.classes > 0) {
              const float* hw = lp;  // (C, classes), then the classes' biases
              const float* hb = hw + C * g.classes;
              float* po = out + at * g.classes;
              for (int cls = 0; cls < g.classes; ++cls) {
                float sum = 0.0f;
#pragma unroll
                for (int co = 0; co < C; ++co) sum = fmaf(v[co], hw[co * g.classes + cls], sum);
                po[cls] = sum + hb[cls];
              }
            } else {
              float* po = out + at * C;
#pragma unroll
              for (int co = 0; co < C; ++co) po[co] = v[co];
            }
          }
        }
      }
    };

    float acc[M][R][C];
    if (l == 0) {
      // from the input staging array, one box per (tz, input row) through
      // the warp's ring; items (z row, row group, chunk) dealt to the warps
      const Box box = first_box(X, s2, d, cin);
      const int cs = conv_tile::odd_stride(cin);
      const int slot = conv_tile::slot_floats(box.width, cs);
      float* ring = s_ring + warp * conv_tile::kStages * slot;
      const int nch = (s2 + box.tx - 1) / box.tx;
      const int n_items = s0 * groups * nch;
      int xo[R];
#pragma unroll
      for (int k = 0; k < R; ++k) xo[k] = min(lane + 32 * k, box.tx - 1) * cs;
      // item -> region z row, first row of its group, first x of its chunk
      struct Item {
        int j0, j1, x0;
      };
      auto decode = [&](int item) {
        const int zr = item / nch;
        return Item{zr / groups, conv_tile::group_row(zr % groups, d, M), item % nch * box.tx};
      };
      // step s of item c reads the input row (z + tz d, y + j d), or null
      // outside the volume
      auto row_of = [&](const Item& c, int s) -> const float* {
        const int z = o0 - ro + c.j0 + (s / (M + 2) - 1) * d;
        const int y = o1 - ro + c.j1 + (s % (M + 2) - 1) * d;
        if (z < zin_lo || z >= zin_hi || y < 0 || y >= g.vol[1]) return nullptr;
        return x + ((((int64_t)b * g.in_dims[0] + z + g.in_halo) * g.in_dims[1] + y + g.in_halo) * g.in_dims[2] +
                    g.in_halo) * cin;
      };
      // this warp's step q: step q % kSteps of its item warp + (q / kSteps) kWarps
      const int n_steps = warp < n_items ? ((n_items - 1 - warp) / conv_tile::kWarps + 1) * kSteps : 0;
      Item ahead = decode(warp);  // the item of the newest copy
      int ahead_round = 0;
      auto issue = [&](int q) {
        if (q < n_steps) {
          if (q / kSteps != ahead_round) {
            ahead_round = q / kSteps;
            ahead = decode(warp + ahead_round * conv_tile::kWarps);
          }
          const float* row = row_of(ahead, q % kSteps);
          if (row)
            conv_tile::stage_box(ring + q % conv_tile::kStages * slot, row, cin, cs, o2 - ro + ahead.x0, d, box,
                                 g.vol[2], lane);
        }
        conv_tile::cp_async_commit();  // an empty group past the end keeps the count
      };
      if (n_steps > 0) {
        for (int q = 0; q + 1 < conv_tile::kStages; ++q) issue(q);
        Item cur = ahead;
        conv_tile::zero(acc);
        for (int q = 0; q < n_steps; ++q) {
          const int s = q % kSteps;
          if (s == 0 && q > 0)
            cur = ahead_round * kSteps <= q ? ahead : decode(warp + q / kSteps * conv_tile::kWarps);
          issue(q + conv_tile::kStages - 1);
          conv_tile::cp_async_wait<conv_tile::kStages - 1>();
          __syncwarp();
          const float* row = row_of(cur, s);
          if (row) {
            const float* in =
                ring + q % conv_tile::kStages * slot + conv_tile::box_shift(row, cin, o2 - ro + cur.x0, d, box);
            conv_tile::accumulate_rows<R, C, CP, M, CIN>(acc, in, xo, box.sx * cs, w + (s / (M + 2)) * 9 * cin * CP, cin,
                                                         s % (M + 2) - 1);
          }
          __syncwarp();  // this box is read before a later copy refills it
          if (s == kSteps - 1) {
            store(acc, cur.j0, cur.j1, cur.x0, box.tx);
            conv_tile::zero(acc);
          }
        }
        conv_tile::cp_async_wait<0>();
      }
    } else {
      // prev holds the previous layer over this region grown by d a side
      const int nch = (s2 + X - 1) / X;
      const int n_items = s0 * groups * nch;
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
        store(acc, j0, j1, x0, X);
      }
    }
    __syncthreads();
    prev = dst;
    p1 = s1;
    p2 = s2;
    r = ro;
  }
}

// The instantiation for a first layer of cin input channels: CIN = 1 or
// 5 at C = 5 where cin is one of them, else 0 (as K1's kernel_for).
template <int C>
auto kernel_for(int cin) {
  if (C != 5) return segment_kernel<C, 0>;
  return cin == 1 ? segment_kernel<C, C == 5 ? 1 : 0> : cin == 5 ? segment_kernel<C, C == 5 ? 5 : 0> : segment_kernel<C, 0>;
}

template <int C>
cudaError_t launch(const float* x, const float* params, float* out,
                   const Geom& g, cudaStream_t stream) {
  if (!layout_matches<C>(g)) return cudaErrorInvalidValue;
  const size_t smem = (size_t)(g.n_params + g.ping + g.pong + g.ring) * sizeof(float);
  if (smem > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  const auto kernel = kernel_for<C>(g.cin);
  if (smem > 48 * 1024) {  // raise the cap to the most, never lower it
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (e != cudaSuccess) return e;
  }
  const int64_t blocks =
      (int64_t)g.ntiles[0] * g.ntiles[1] * g.ntiles[2] * g.B;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, conv_tile::kThreads, smem, stream>>>(x, params, out, g);
  return cudaGetLastError();
}

template <int C>
int occupancy(int cin, int smem) {
  if (smem > kSmemLimit) return -1;
  const auto kernel = kernel_for<C>(cin);
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit) != cudaSuccess)
    return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, conv_tile::kThreads, (size_t)smem) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace

extern "C" {

// Hidden widths this library is instantiated for (PAPER_MODELS use 5, 10,
// 18 and 21).
int repro_megakernel_supports(int c) {
  return c == 5 || c == 10 || c == 18 || c == 21;
}

// Blocks of width c, first-layer input channels cin, with smem bytes of
// shared memory one SM holds at once (the runtime's occupancy calculator:
// shared memory, threads and registers); -1 for a width not instantiated
// or a layout over the limit.
int repro_megakernel_blocks_per_sm(int c, int cin, int smem) {
  switch (c) {
    case 5:
      return occupancy<5>(cin, smem);
    case 10:
      return occupancy<10>(cin, smem);
    case 18:
      return occupancy<18>(cin, smem);
    case 21:
      return occupancy<21>(cin, smem);
    default:
      return -1;
  }
}

// x: input staging (B, in_dims, cin) fp32 contiguous, the volume at offset
// in_halo on each axis; params: every layer's w (3, 3, 3, cin_l, C), bias,
// scale and offset (C each), then the head's w (C, classes) and bias when
// classes > 0; out: (B, out_dims, classes or C), written at offset
// out_halo. geom, n ints: B, cin, C, k, classes, vol[3], tile[3],
// in_dims[3], in_halo, out_dims[3], out_halo, n_params, ping, pong, ring
// (the shared-memory layout in floats, which must be the one K2 allocates
// for this geometry), z_lo, z_hi (the valid Z interval, 0 <= z_lo <= z_hi
// <= vol[0]), band_lo, band_hi (the output rows written, 0 <= band_lo <=
// band_hi <= the tile-padded depth), then the k dilations. Returns a
// cudaError_t (0 on success).
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
  g.ring = *p++;
  g.z_lo = *p++;
  g.z_hi = *p++;
  g.band_lo = *p++;
  g.band_hi = *p++;
  if (g.k < 1 || g.k > kMaxLayers || n != kGeomFixed + g.k || g.z_lo < 0 || g.z_hi < g.z_lo || g.z_hi > g.vol[0])
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < g.k; ++l) g.dil[l] = *p++;
  for (int a = 0; a < 3; ++a) {
    if (g.tile[a] < 1) return (int)cudaErrorInvalidValue;
    g.ntiles[a] = (g.vol[a] + g.tile[a] - 1) / g.tile[a];
  }
  if (g.band_lo < 0 || g.band_hi < g.band_lo || g.band_hi > g.ntiles[0] * g.tile[0]) return (int)cudaErrorInvalidValue;
  // the grid: the Z tiles that meet the band
  g.t0_lo = g.band_lo / g.tile[0];
  g.ntiles[0] = g.band_hi > g.band_lo ? (g.band_hi + g.tile[0] - 1) / g.tile[0] - g.t0_lo : 0;
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
