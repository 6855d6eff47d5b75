// K1 for Hopper: 'same'-padded 3x3x3 dilated conv, channels-last, fp32,
// + bias, with the optional fused epilogue relu(acc * scale + offset) that
// carries MeshNet's folded inference BatchNorm and ReLU.
//
// Replaces the TPU kernel src/repro/kernels/dilated_conv3d.py::_halo_kernel.
// That kernel DMAs one haloed (block + 2d)^3 window per output block into
// VMEM. At d = 16 the window alone is over 2 MB at C = 5, against 227 KB
// of shared memory a Hopper block, so the window design does not carry
// over. Here each warp computes a chunk of M output rows d apart in y (up
// to 32 R voxels along x; 256 at C = 5, M = 2) on the conv tile core
// (conv_tile.cuh): for each tap plane tz it stages the M + 2 input rows
// its rows read, one box each, through cp.async into a double-buffered
// ring, and runs every (ty, tx) tap that reads a box from it, R voxels x
// C channels a row in registers per lane. Warps work alone (no block
// barrier after the weights are staged); a block of 4 warps shares the
// weights, bias, scale and offset in shared memory.
//
// What bounds it on the card: MeshNet's hidden layers (5 -> 5) do 27*2*25
// = 1350 fp32 operations per voxel against 40 bytes of compulsory traffic,
// above the fp32 CUDA-core ridge (67 TFLOP/s over 3.35 TB/s, about 20
// op/byte on an H100 SXM), so the bound is the fp32 FMA rate. What this
// design does about it: the FFMAs share the SM's L1/shared-memory data
// path with the loads and copies, so it moves few bytes per FFMA there:
// 44 shared-memory load instructions per 240 FFMAs at C = 5, each input
// loaded once for the up to 3 output rows it feeds (the counts for every
// width are in conv_tile.cuh), the boxes copied in 16-byte chunks from L2,
// each input value 6 times a layer at M = 2 (one box per (tz, j)), not 27.
// The 1 -> 5 layer is bound by its bytes. A 256^3 layer at C = 5 is 32,768
// two-row chunks, 8,192 blocks of 4 warps.
//
// Layout (the wrapper's k1_layout mirrors it): weights 27 * Cin * CP
// floats (CP = Cout rounded up to 4, the padding zero), bias, scale and
// offset (3 Cout, rounded up to 4), then the ring: warps x 2 slots of
// ceil4(WB (Cin | 1)) + 4 floats (the +4 for the alignment shift), WB =
// 32 R + 32 positions. Where it does not fit, the block has 2 or 1 warps,
// and then WB shrinks; the chunk is as wide as WB leaves room for
// (t_x + 2 d <= WB while d < t_x, 3 t_x <= WB beyond).
//
// Plain C entry points (bound from Python with ctypes); the launch goes on
// the caller's stream, does not synchronise and allocates nothing.

#include "conv_tile.cuh"

namespace {

using conv_tile::Blocking;
using conv_tile::Box;

constexpr int kSmemLimit = 232448;  // shared memory one sm_90a block can use

struct Layout {
  int warps;   // warps a block
  int wb;      // ring positions a box
  int floats;  // shared memory, floats
};

// The block's shared-memory layout for cin -> cout: kWarps warps and
// 32 R + 32 positions a box where that fits; else fewer warps, then a
// narrower box. A layout over kSmemLimit cannot launch.
Layout layout(int cin, int cout) {
  const int r = cout <= 5 ? 8 : 4;
  const int cp = conv_tile::ceil4(cout);
  const int cs = conv_tile::odd_stride(cin);
  const int fixed = 27 * cin * cp + conv_tile::ceil4(3 * cout);
  const int limit = kSmemLimit / 4;
  int wb = 32 * r + 32;
  constexpr int S = conv_tile::kStages;
  for (int warps = conv_tile::kWarps; warps >= 1; warps /= 2) {
    const int floats = fixed + warps * S * conv_tile::slot_floats(wb, cs);
    if (floats <= limit) return Layout{warps, wb, floats};
  }
  wb = ((limit - fixed) / S - 4) / 4 * 4 / cs;  // the widest box the slots leave room for
  if (wb < 3) wb = 3;
  return Layout{1, wb, fixed + S * conv_tile::slot_floats(wb, cs)};
}

// The chunk a warp computes for dilation d on rows of width W: as wide as
// the box allows, at most the warp's 32 R voxels and at most the row.
Box chunk_box(int x_max, int wb, int d, int W, int cin) {
  int tx = wb - 2 * d < x_max ? wb - 2 * d : x_max;
  if (tx < wb / 3) tx = wb / 3;
  if (tx > W) tx = W;
  return conv_tile::make_box(tx, d, cin);
}

// CIN: the input channels when the compiler may know them (1 or 5, at
// C = 5), else 0 (read at run time).
template <int C, int CIN>
__global__ void __launch_bounds__(conv_tile::kThreads)
dilated_conv3d_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias,
                      const float* __restrict__ scale,
                      const float* __restrict__ offset, float* __restrict__ out,
                      int B, int D, int H, int W, int cin, int dilation,
                      int fuse, Box box, int nchunks, int slot) {
  constexpr int R = Blocking<C>::R, CP = Blocking<C>::CP, M = Blocking<C>::M;
  constexpr int kSteps = 3 * (M + 2);  // (tz, input row j) boxes an item
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_w = smem;
  float* s_b = s_w + 27 * cin * CP;
  float* s_scale = s_b + C;
  float* s_offset = s_scale + C;
  float* s_ring = s_b + conv_tile::ceil4(3 * C);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  conv_tile::stage_weights<C, CP>(s_w, w, 27 * cin, tid, nthreads);
  for (int i = tid; i < C; i += nthreads) {
    s_b[i] = bias[i];
    s_scale[i] = fuse ? scale[i] : 1.0f;
    s_offset[i] = fuse ? offset[i] : 0.0f;
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
  const int cs = conv_tile::odd_stride(cin);
  float* ring = s_ring + warp * conv_tile::kStages * slot;  // kStages slots
  const int groups = conv_tile::row_groups(H, dilation, M);
  const int n_items = B * D * groups * nchunks;  // the launch keeps every count here in range
  const int stride = gridDim.x * nwarps;
  const int first = blockIdx.x * nwarps + warp;  // this warp's items: first + r stride
  if (first >= n_items) return;
  const int n_steps = ((n_items - 1 - first) / stride + 1) * kSteps;

  // item -> (batch, z, first row y of the group, first x of the chunk)
  struct Item {
    int b, z, y, x0;
  };
  auto decode = [&](int i) {
    Item r;
    r.x0 = i % nchunks * box.tx;
    i /= nchunks;
    r.y = conv_tile::group_row(i % groups, dilation, M);
    i /= groups;
    r.z = i % D;
    r.b = i / D;
    return r;
  };
  // step s = (tz + 1) * (M + 2) + (j + 1) of item c reads input row
  // (z + tz d, y + j d); null when it lies outside the volume
  auto row_of = [&](const Item& c, int s) -> const float* {
    const int z = c.z + (s / (M + 2) - 1) * dilation, y = c.y + (s % (M + 2) - 1) * dilation;
    if (z < 0 || z >= D || y < 0 || y >= H) return nullptr;
    return x + (((int64_t)c.b * D + z) * H + y) * W * cin;
  };
  // step g of this warp: step g % kSteps of its item first + (g / kSteps) stride
  Item ahead = decode(first);  // the item of the newest copy
  int ahead_round = 0;
  auto issue = [&](int g) {
    if (g < n_steps) {
      if (g / kSteps != ahead_round) {
        ahead_round = g / kSteps;
        ahead = decode(first + ahead_round * stride);
      }
      const float* row = row_of(ahead, g % kSteps);
      if (row) conv_tile::stage_box(ring + g % conv_tile::kStages * slot, row, cin, cs, ahead.x0, dilation, box, W, lane);
    }
    conv_tile::cp_async_commit();  // an empty group past the end keeps the count
  };

  int xo[R];  // lane k's position in the box, times the channel stride
#pragma unroll
  for (int k = 0; k < R; ++k) xo[k] = min(lane + 32 * k, box.tx - 1) * cs;

  for (int q = 0; q + 1 < conv_tile::kStages; ++q) issue(q);
  Item cur = ahead;
  float acc[M][R][C];
  conv_tile::zero(acc);
  for (int g = 0; g < n_steps; ++g) {
    const int s = g % kSteps;
    if (s == 0 && g > 0) cur = ahead_round * kSteps <= g ? ahead : decode(first + g / kSteps * stride);
    issue(g + conv_tile::kStages - 1);
    conv_tile::cp_async_wait<conv_tile::kStages - 1>();
    __syncwarp();
    const float* row = row_of(cur, s);
    if (row) {
      const float* in = ring + g % conv_tile::kStages * slot + conv_tile::box_shift(row, cin, cur.x0, dilation, box);
      conv_tile::accumulate_rows<R, C, CP, M, CIN>(acc, in, xo, box.sx * cs, s_w + (s / (M + 2)) * 9 * cin * CP, cin,
                                                   s % (M + 2) - 1);
    }
    __syncwarp();  // this box is read before a later copy refills it
    if (s == kSteps - 1) {
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int y = cur.y + m * dilation;
        if (y >= H) continue;
        float* po = out + (((int64_t)cur.b * D + cur.z) * H + y) * W * C;
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const int xl = lane + 32 * k, xi = cur.x0 + xl;
          if (xl < box.tx && xi < W) {
#pragma unroll
            for (int co = 0; co < C; ++co) {
              float o = acc[m][k][co] + s_b[co];
              if (fuse) o = fmaxf(o * s_scale[co] + s_offset[co], 0.0f);
              po[(int64_t)xi * C + co] = o;
            }
          }
        }
      }
      conv_tile::zero(acc);
    }
  }
  conv_tile::cp_async_wait<0>();
}

// The instantiation for cin input channels: at C = 5 (gwm_light's and the
// mask models' width) CIN = 1 or 5 where cin is one of them; else CIN = 0,
// the channel loop at run time (unrolling it at the wider widths costs
// minutes of ptxas and registers).
template <int C>
auto kernel_for(int cin) {
  if (C != 5) return dilated_conv3d_kernel<C, 0>;
  return cin == 1 ? dilated_conv3d_kernel<C, C == 5 ? 1 : 0>
                  : cin == 5 ? dilated_conv3d_kernel<C, C == 5 ? 5 : 0> : dilated_conv3d_kernel<C, 0>;
}

template <int C>
int occupancy(int cin) {
  const Layout lay = layout(cin, C);
  const size_t smem = (size_t)lay.floats * sizeof(float);
  if (smem > (size_t)kSmemLimit) return -1;
  const auto kernel = kernel_for<C>(cin);
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit) != cudaSuccess) return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, 32 * lay.warps, smem) != cudaSuccess) return -1;
  return n;
}

// Items (row groups x chunks) and the chunk's box of one launch.
struct Grid {
  Box box;
  int nchunks;
  int64_t items;
};

Grid grid(int x_max, int m, const Layout& lay, int B, int D, int H, int W, int cin, int dilation) {
  Grid g;
  g.box = chunk_box(x_max, lay.wb, dilation, W, cin);
  g.nchunks = (W + g.box.tx - 1) / g.box.tx;
  g.items = (int64_t)B * D * conv_tile::row_groups(H, dilation, m) * g.nchunks;
  return g;
}

template <int C>
cudaError_t launch(const float* x, const float* w, const float* bias,
                   const float* scale, const float* offset, float* out, int B,
                   int D, int H, int W, int cin, int dilation, int fuse,
                   cudaStream_t stream) {
  const Layout lay = layout(cin, C);
  const size_t smem = (size_t)lay.floats * sizeof(float);
  if (smem > (size_t)kSmemLimit || dilation < 1) return cudaErrorInvalidValue;
  const auto kernel = kernel_for<C>(cin);
  if (smem > 48 * 1024) {  // raise the cap to the most, never lower it
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (e != cudaSuccess) return e;
  }
  if ((int64_t)B * D * H * W == 0) return cudaSuccess;
  const Grid g = grid(Blocking<C>::X, Blocking<C>::M, lay, B, D, H, W, cin, dilation);
  const int64_t blocks = (g.items + lay.warps - 1) / lay.warps;
  if (g.items * 3 * (Blocking<C>::M + 2) > 0x7fffffff)
    return cudaErrorInvalidConfiguration;  // the kernel counts items and steps in 32 bits
  kernel<<<(unsigned)blocks, 32 * lay.warps, smem, stream>>>(
      x, w, bias, scale, offset, out, B, D, H, W, cin, dilation, fuse, g.box,
      g.nchunks, conv_tile::slot_floats(lay.wb, conv_tile::odd_stride(cin)));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Output channel counts this library is instantiated for: MeshNet's hidden
// widths (PAPER_MODELS use 5, 10, 18 and 21).
int repro_dilated_conv3d_supports(int cout) {
  return cout == 5 || cout == 10 || cout == 18 || cout == 21;
}

// Bytes of shared memory one block of cin -> cout allocates (above 232,448
// it cannot launch).
long long repro_dilated_conv3d_smem_bytes(int cin, int cout) {
  return (long long)layout(cin, cout).floats * 4;
}

// Blocks one launch of cin -> cout over (B, D, H, W) at this dilation
// takes, and how many of them one SM holds at once (by the runtime's
// occupancy calculator: shared memory, threads and registers); -1 if the
// width is not instantiated or the layout does not fit.
long long repro_dilated_conv3d_blocks(int B, int D, int H, int W, int cin,
                                      int cout, int dilation) {
  if (!repro_dilated_conv3d_supports(cout)) return -1;
  const Layout lay = layout(cin, cout);
  const int r = cout <= 5 ? 8 : 4, m = cout <= 10 ? 2 : 1;  // Blocking<cout>::R and M
  return (grid(32 * r, m, lay, B, D, H, W, cin, dilation).items + lay.warps - 1) / lay.warps;
}

int repro_dilated_conv3d_blocks_per_sm(int cin, int cout) {
  switch (cout) {
    case 5:
      return occupancy<5>(cin);
    case 10:
      return occupancy<10>(cin);
    case 18:
      return occupancy<18>(cin);
    case 21:
      return occupancy<21>(cin);
    default:
      return -1;
  }
}

// x: (B, D, H, W, cin) fp32 contiguous; w: (3, 3, 3, cin, cout); bias,
// scale, offset: (cout,) (scale/offset read only when fuse != 0);
// out: (B, D, H, W, cout). Returns a cudaError_t (0 on success).
int repro_dilated_conv3d_f32(const float* x, const float* w, const float* bias,
                             const float* scale, const float* offset,
                             float* out, int B, int D, int H, int W, int cin,
                             int cout, int dilation, int fuse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cout) {
    case 5:
      return launch<5>(x, w, bias, scale, offset, out, B, D, H, W, cin,
                       dilation, fuse, s);
    case 10:
      return launch<10>(x, w, bias, scale, offset, out, B, D, H, W, cin,
                        dilation, fuse, s);
    case 18:
      return launch<18>(x, w, bias, scale, offset, out, B, D, H, W, cin,
                        dilation, fuse, s);
    case 21:
      return launch<21>(x, w, bias, scale, offset, out, B, D, H, W, cin,
                        dilation, fuse, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
