// K5 for Hopper: K1's function ('same'-padded 3x3x3 dilated conv,
// channels-last, fp32, + bias, optional relu(acc * scale + offset)) on the
// 27-shifted-tile schedule.
//
// Replaces the TPU kernel src/repro/kernels/dilated_conv3d.py::
// _views_kernel. That kernel reads 27 offset (b, b, b, Cin) views of a
// block-padded copy of the input and assembles them into a (3b)^3
// neighbourhood in VMEM; the reference keeps it as the bit-exact oracle of
// K1's haloed schedule. Here one block computes one b^3 output tile
// (b = 8: 512 threads, one output voxel each, all Cout accumulators in
// registers). The weights, bias, scale and offset stay in shared memory.
// For each of the 27 taps, in the reference's order (tz, ty, tx from -1 to
// 1), the block stages the b^3 x Cin input tile shifted by t * d into
// shared memory, zero outside the volume: one warp an x-row of b * Cin
// contiguous floats, its lanes on neighbouring addresses, the row's
// in-volume span found once, so no index is divided per element; after a
// __syncthreads every thread accumulates its voxel's Cin values in the
// same fmaf order as K1 (csrc/dilated_conv3d.cu), Cin innermost. A tap
// whose source voxel lies outside the volume adds nothing, as K1 skips
// it, so K5 and K1 are bit-equal and K5 is K1's oracle on the card.
//
// No padded copy of the input is made: the staging masks the edges.
// Shared memory at b = 8: 512 * Cin floats of tile plus 27 * Cin * Cout +
// 3 * Cout of parameters, 13 KB at 5 -> 5 and 91 KB at 21 -> 21.
//
// What bounds it on the card: the same work as K1 (fp32 FMAs above the
// ridge for 5 -> 5), so K1's bound; every tap reloads its tile (27x the
// compulsory input bytes, served in part by L2).
//
// Plain C entry points (bound from Python with ctypes); the launch goes on
// the caller's stream, does not synchronise and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 8;
constexpr int kThreads = kTile * kTile * kTile;

template <int COUT>
__global__ void __launch_bounds__(kThreads)
dilated_conv3d_views_kernel(const float* __restrict__ x,
                            const float* __restrict__ w,
                            const float* __restrict__ bias,
                            const float* __restrict__ scale,
                            const float* __restrict__ offset,
                            float* __restrict__ out, int D, int H, int W,
                            int cin, int dilation, int fuse, int tiles_y,
                            int tiles_x) {
  extern __shared__ float smem[];
  const int nw = 27 * cin * COUT;
  float* s_w = smem;
  float* s_b = s_w + nw;
  float* s_scale = s_b + COUT;
  float* s_offset = s_scale + COUT;
  float* s_tile = s_offset + COUT;  // (kTile, kTile, kTile, cin)
  const int tid = threadIdx.x;
  for (int i = tid; i < nw; i += kThreads) s_w[i] = w[i];
  for (int i = tid; i < COUT; i += kThreads) {
    s_b[i] = bias[i];
    s_scale[i] = fuse ? scale[i] : 1.0f;
    s_offset[i] = fuse ? offset[i] : 0.0f;
  }

  // blockIdx.x walks the x tiles, then y tiles; blockIdx.y the z tiles;
  // blockIdx.z the batch.
  const int bi = blockIdx.z;
  const int z0 = blockIdx.y * kTile;
  const int y0 = (blockIdx.x / tiles_x) * kTile;
  const int x0 = (blockIdx.x % tiles_x) * kTile;
  const int lx = tid % kTile, ly = (tid / kTile) % kTile, lz = tid / (kTile * kTile);
  const int zi = z0 + lz, yi = y0 + ly, xi = x0 + lx;
  const bool in_out = zi < D && yi < H && xi < W;
  const float* xb = x + (int64_t)bi * D * H * W * cin;
  const int row = kTile * cin;  // floats in one staged x-row
  const int warp = tid >> 5, lane = tid & 31;

  float acc[COUT];
#pragma unroll
  for (int co = 0; co < COUT; ++co) acc[co] = 0.0f;

  for (int tz = -1; tz <= 1; ++tz) {
    for (int ty = -1; ty <= 1; ++ty) {
      for (int tx = -1; tx <= 1; ++tx) {
        const int oz = z0 + tz * dilation, oy = y0 + ty * dilation, ox = x0 + tx * dilation;
        // the row's in-volume floats: x in [max(0, ox), min(W, ox + kTile))
        const int e_lo = max(0, -ox) * cin, e_hi = min(kTile, W - ox) * cin;
        __syncthreads();  // the previous tap's tile is read; the weights are staged
        // one warp a row of the tile (16 warps, 64 rows), lanes along it
        for (int r = warp; r < kTile * kTile; r += kThreads / 32) {
          const int z = oz + r / kTile, y = oy + r % kTile;
          const bool row_in = z >= 0 && z < D && y >= 0 && y < H;
          const int64_t base = (((int64_t)z * H + y) * W + ox) * cin;
          for (int e = lane; e < row; e += 32)
            s_tile[r * row + e] = (row_in && e >= e_lo && e < e_hi) ? __ldg(xb + (base + e)) : 0.0f;
        }
        __syncthreads();
        const int z = zi + tz * dilation, y = yi + ty * dilation, xx = xi + tx * dilation;
        if (!in_out || z < 0 || z >= D || y < 0 || y >= H || xx < 0 || xx >= W) continue;
        const float* px = s_tile + tid * cin;
        const float* pw =
            s_w + (((tz + 1) * 3 + (ty + 1)) * 3 + (tx + 1)) * cin * COUT;
        for (int ci = 0; ci < cin; ++ci) {
          const float xv = px[ci];
#pragma unroll
          for (int co = 0; co < COUT; ++co)
            acc[co] = fmaf(xv, pw[ci * COUT + co], acc[co]);
        }
      }
    }
  }
  if (!in_out) return;
  float* po = out + ((((int64_t)bi * D + zi) * H + yi) * W + xi) * COUT;
#pragma unroll
  for (int co = 0; co < COUT; ++co) {
    float o = acc[co] + s_b[co];
    if (fuse) o = fmaxf(o * s_scale[co] + s_offset[co], 0.0f);
    po[co] = o;
  }
}

size_t smem_bytes(int cin, int cout) {
  return (size_t)(27 * cin * cout + 3 * cout + kThreads * cin) * sizeof(float);
}

template <int COUT>
cudaError_t launch(const float* x, const float* w, const float* bias,
                   const float* scale, const float* offset, float* out, int B,
                   int D, int H, int W, int cin, int dilation, int fuse,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(cin, COUT);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dilated_conv3d_views_kernel<COUT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  if ((int64_t)B * D * H * W == 0) return cudaSuccess;
  const int tz = (D + kTile - 1) / kTile, ty = (H + kTile - 1) / kTile,
            tx = (W + kTile - 1) / kTile;
  dilated_conv3d_views_kernel<COUT><<<dim3(ty * tx, tz, B), kThreads, smem, stream>>>(
      x, w, bias, scale, offset, out, D, H, W, cin, dilation, fuse, ty, tx);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Output channel counts this library is instantiated for: MeshNet's hidden
// widths, as K1's.
int repro_dilated_conv3d_views_supports(int cout) {
  return cout == 5 || cout == 10 || cout == 18 || cout == 21;
}

// Bytes of shared memory one block stages: parameters and one input tile.
long long repro_dilated_conv3d_views_smem_bytes(int cin, int cout) {
  return (long long)smem_bytes(cin, cout);
}

// x: (B, D, H, W, cin) fp32 contiguous; w: (3, 3, 3, cin, cout); bias,
// scale, offset: (cout,) (scale/offset read only when fuse != 0);
// out: (B, D, H, W, cout). Returns a cudaError_t (0 on success).
int repro_dilated_conv3d_views_f32(const float* x, const float* w,
                                   const float* bias, const float* scale,
                                   const float* offset, float* out, int B,
                                   int D, int H, int W, int cin, int cout,
                                   int dilation, int fuse, void* stream) {
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
