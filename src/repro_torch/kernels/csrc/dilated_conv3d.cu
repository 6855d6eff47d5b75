// K1 for Hopper: 'same'-padded 3x3x3 dilated conv, channels-last, fp32,
// + bias, with the optional fused epilogue relu(acc * scale + offset) that
// carries MeshNet's folded inference BatchNorm and ReLU.
//
// Replaces the TPU kernel src/repro/kernels/dilated_conv3d.py::_halo_kernel.
// That kernel DMAs one haloed (block + 2d)^3 window per output block into
// VMEM. At d = 16 the window alone is over 2 MB at C = 5, and one Hopper
// block has 227 KB of shared memory, so the window design does not carry
// over. This kernel instead gives each thread one output voxel (b, z, y, x)
// and all Cout fp32 accumulators in registers (Cout is a template
// parameter: a runtime-indexed local array would spill to local memory).
// It walks the 27 taps in the reference's order (tz, ty, tx from -1 to 1,
// Cin innermost) and reads x[p + t*d] straight from device memory through
// the read-only cache; a tap outside the volume contributes zero, which
// replaces the reference's zero-padded copy of the input. Each block first
// stages the weights (27*Cin*Cout floats, 47.6 KB at 21 -> 21), bias,
// scale and offset in shared memory, where every thread of a warp reads
// the same word (a broadcast).
//
// What bounds it on the card: MeshNet's hidden layers (5 -> 5) do 27*2*25
// = 1350 fp32 operations per voxel against 40 bytes of compulsory traffic,
// above the fp32 CUDA-core ridge (67 TFLOP/s over 3.35 TB/s, about 20
// op/byte on an H100 SXM), so the bound is the fp32 FMA rate. Every tap
// re-reads its inputs (27x the compulsory bytes), which L1/L2 absorb only
// in part at large dilations. A later version would stage shared-memory
// halo tiles through TMA so each input byte leaves device memory once, and
// would move the Cin x Cout products onto the tensor cores (TF32 or bf16
// wgmma) for the wide models.
//
// Plain C entry points (bound from Python with ctypes); the launch goes on
// the caller's stream, does not synchronise and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int COUT>
__global__ void __launch_bounds__(kThreads)
dilated_conv3d_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias,
                      const float* __restrict__ scale,
                      const float* __restrict__ offset, float* __restrict__ out,
                      int B, int D, int H, int W, int cin, int dilation,
                      int fuse) {
  extern __shared__ float smem[];
  const int nw = 27 * cin * COUT;
  float* s_w = smem;
  float* s_b = s_w + nw;
  float* s_scale = s_b + COUT;
  float* s_offset = s_scale + COUT;
  for (int i = threadIdx.x; i < nw; i += blockDim.x) s_w[i] = w[i];
  for (int i = threadIdx.x; i < COUT; i += blockDim.x) {
    s_b[i] = bias[i];
    s_scale[i] = fuse ? scale[i] : 1.0f;
    s_offset[i] = fuse ? offset[i] : 0.0f;
  }
  __syncthreads();

  const int64_t n = (int64_t)B * D * H * W;
  const int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n) return;
  int64_t t = v;
  const int xi = (int)(t % W);
  t /= W;
  const int yi = (int)(t % H);
  t /= H;
  const int zi = (int)(t % D);
  const int64_t bi = t / D;

  float acc[COUT];
#pragma unroll
  for (int co = 0; co < COUT; ++co) acc[co] = 0.0f;

  const float* xb = x + bi * D * H * W * cin;
  for (int tz = -1; tz <= 1; ++tz) {
    const int z = zi + tz * dilation;
    if (z < 0 || z >= D) continue;
    for (int ty = -1; ty <= 1; ++ty) {
      const int y = yi + ty * dilation;
      if (y < 0 || y >= H) continue;
      for (int tx = -1; tx <= 1; ++tx) {
        const int xx = xi + tx * dilation;
        if (xx < 0 || xx >= W) continue;
        const float* px = xb + (((int64_t)z * H + y) * W + xx) * cin;
        const float* pw =
            s_w + (((tz + 1) * 3 + (ty + 1)) * 3 + (tx + 1)) * cin * COUT;
        for (int ci = 0; ci < cin; ++ci) {
          const float xv = __ldg(px + ci);
#pragma unroll
          for (int co = 0; co < COUT; ++co)
            acc[co] = fmaf(xv, pw[ci * COUT + co], acc[co]);
        }
      }
    }
  }

  float* po = out + v * COUT;
#pragma unroll
  for (int co = 0; co < COUT; ++co) {
    float o = acc[co] + s_b[co];
    if (fuse) o = fmaxf(o * s_scale[co] + s_offset[co], 0.0f);
    po[co] = o;
  }
}

template <int COUT>
cudaError_t launch(const float* x, const float* w, const float* bias,
                   const float* scale, const float* offset, float* out, int B,
                   int D, int H, int W, int cin, int dilation, int fuse,
                   cudaStream_t stream) {
  const size_t smem = (size_t)(27 * cin * COUT + 3 * COUT) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dilated_conv3d_kernel<COUT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int64_t n = (int64_t)B * D * H * W;
  if (n == 0) return cudaSuccess;
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  dilated_conv3d_kernel<COUT><<<grid, kThreads, smem, stream>>>(
      x, w, bias, scale, offset, out, B, D, H, W, cin, dilation, fuse);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Output channel counts this library is instantiated for: MeshNet's hidden
// widths (PAPER_MODELS use 5, 10, 18 and 21).
int repro_dilated_conv3d_supports(int cout) {
  return cout == 5 || cout == 10 || cout == 18 || cout == 21;
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
