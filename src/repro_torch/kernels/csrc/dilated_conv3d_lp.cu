// K1r for Hopper: K1's function at reduced widths. 'Same'-padded 3x3x3
// dilated conv, channels-last, bf16 activations with bf16 or int8 weights,
// fp32 accumulation, + bias, with the optional fused epilogue
// relu((acc + bias) * scale + offset) that carries MeshNet's folded
// inference BatchNorm, the int8 dequant scale and the ReLU; the result is
// rounded once to bf16 (__float2bfloat16_rn, round to nearest even).
//
// Replaces the TPU kernel src/repro/kernels/dilated_conv3d.py::_halo_kernel
// at the reference's bf16 and int8w policies: there the haloed window and
// the weights are cast to fp32 in VMEM, the 27 taps accumulate in fp32 and
// the block is written at the activation dtype. The window design does not
// carry over (at d = 16 the window is over 1 MB at C = 5, against 227 KB
// of shared memory a Hopper block). Here the weights are widened to fp32
// once per block into shared memory (int8 -> fp32 is exact), at a row
// stride of Cout rounded up to 4 so a lane reads 4 of them in one
// broadcast load; each lane computes R voxels 32 apart along x of one
// output row, R x Cout fp32 accumulators in registers, and reads its bf16
// taps straight from device memory (through L1), widening each in a
// register; taps tz, ty, tx from -1 to 1 with the input channel innermost,
// K1's order. A tap outside the volume reads zero (fmaf(0, w, acc) is
// acc). A warp is one row chunk of 32 R voxels, a block 4 warps on 4
// neighbouring rows; 32 lanes read 32 neighbouring voxels, so each load
// instruction touches 32 Cin contiguous bf16 values.
//
// What bounds it on the card: the operations. A 5 -> 5 layer does 27 * 25
// multiply-adds a voxel against 20 bytes of compulsory traffic at 2 bytes
// an element. On the bf16 tensor cores (989 TFLOP/s dense) that work would
// take about 0.023 ms at 256^3 and its bytes 0.100 ms, so the bound is the
// bytes; this kernel runs it on the fp32 CUDA cores (67 TFLOP/s), where the
// same FMAs take 0.34 ms, K1's floor, and issues one 2-byte load and one
// widening per R x Cout FMAs besides. It is simple first: no cp.async ring,
// no shared-memory staging of the taps.
//
// A tensor-core version (wgmma, or mma.sync m16n8k16 bf16 with fp32
// accumulators) would take the GEMM view of the conv: per tap, a tile of
// voxels (M) times Cin (K, padded to 16) times Cout (N, padded to 8); the
// taps would be staged through shared memory in the swizzled layout wgmma
// reads, the int8 weights widened to bf16 there (exact), and the epilogue
// kept as it is. Its work then falls to the byte bound (0.1 ms a layer at
// 256^3) and the padding of Cin = 5 to 16 wastes 2/3 of the MMA rate, which
// the bound still leaves room for.
//
// Plain C entry points (bound from Python with ctypes); the launch goes on
// the caller's stream, does not synchronise and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kSmemLimit = 232448;  // shared memory one sm_90a block can use

constexpr int ceil4(int v) { return (v + 3) / 4 * 4; }

// R: voxels a lane computes along x, as K1's blocking (conv_tile.cuh).
template <int COUT>
struct Blocking {
  static constexpr int R = COUT <= 5 ? 8 : 4;
  static constexpr int CP = ceil4(COUT);
};

size_t smem_bytes(int cin, int cout) {
  return (size_t)(27 * cin * ceil4(cout) + 3 * cout) * sizeof(float);
}

__device__ __forceinline__ float widen(uint16_t bits) {
  return __uint_as_float((uint32_t)bits << 16);  // bf16 -> fp32, exact
}
__device__ __forceinline__ float widen_w(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen_w(int8_t v) { return (float)v; }

template <int COUT, typename WT>
__global__ void __launch_bounds__(kThreads)
dilated_conv3d_lp_kernel(const uint16_t* __restrict__ x, const WT* __restrict__ w,
                         const float* __restrict__ bias,
                         const float* __restrict__ scale,
                         const float* __restrict__ offset,
                         __nv_bfloat16* __restrict__ out, int D, int H, int W,
                         int cin, int dilation, int fuse, int chunks_x) {
  constexpr int R = Blocking<COUT>::R;
  constexpr int CP = Blocking<COUT>::CP;
  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);  // (27, cin, CP), padding 0
  float* s_b = s_w + 27 * cin * CP;
  float* s_scale = s_b + COUT;
  float* s_offset = s_scale + COUT;
  for (int i = threadIdx.x; i < 27 * cin * CP; i += kThreads) {
    const int row = i / CP, co = i - row * CP;
    s_w[i] = co < COUT ? widen_w(w[row * COUT + co]) : 0.0f;
  }
  for (int i = threadIdx.x; i < COUT; i += kThreads) {
    s_b[i] = bias[i];
    s_scale[i] = fuse ? scale[i] : 1.0f;
    s_offset[i] = fuse ? offset[i] : 0.0f;
  }
  __syncthreads();

  // blockIdx.x walks the x chunks, then groups of kWarps rows in y;
  // blockIdx.y is z, blockIdx.z the batch.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int yi = (blockIdx.x / chunks_x) * kWarps + warp;
  const int x0 = (blockIdx.x % chunks_x) * 32 * R + lane;
  const int zi = blockIdx.y, bi = blockIdx.z;
  if (yi >= H) return;
  const uint16_t* xb = x + (int64_t)bi * D * H * W * cin;

  float acc[R][COUT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int co = 0; co < COUT; ++co) acc[r][co] = 0.0f;

  for (int tz = -1; tz <= 1; ++tz) {
    const int z = zi + tz * dilation;
    if (z < 0 || z >= D) continue;
    for (int ty = -1; ty <= 1; ++ty) {
      const int y = yi + ty * dilation;
      if (y < 0 || y >= H) continue;
      const uint16_t* row = xb + ((int64_t)z * H + y) * W * cin;
      for (int tx = -1; tx <= 1; ++tx) {
        const float* pw = s_w + (((tz + 1) * 3 + (ty + 1)) * 3 + (tx + 1)) * cin * CP;
        int off[R];
        bool in[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int xx = x0 + 32 * r + tx * dilation;
          in[r] = xx >= 0 && xx < W;
          off[r] = in[r] ? xx * cin : 0;
        }
        for (int ci = 0; ci < cin; ++ci) {
          float v[R];
#pragma unroll
          for (int r = 0; r < R; ++r) v[r] = in[r] ? widen(__ldg(row + off[r] + ci)) : 0.0f;
          const float4* pw4 = reinterpret_cast<const float4*>(pw + ci * CP);
#pragma unroll
          for (int q = 0; q < CP / 4; ++q) {
            const float4 wv = pw4[q];
            const float wq[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              if (4 * q + k < COUT) {
#pragma unroll
                for (int r = 0; r < R; ++r) acc[r][4 * q + k] = fmaf(v[r], wq[k], acc[r][4 * q + k]);
              }
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int xx = x0 + 32 * r;
    if (xx >= W) continue;
    __nv_bfloat16* po = out + ((((int64_t)bi * D + zi) * H + yi) * W + xx) * COUT;
#pragma unroll
    for (int co = 0; co < COUT; ++co) {
      float o = acc[r][co] + s_b[co];
      if (fuse) o = fmaxf(o * s_scale[co] + s_offset[co], 0.0f);
      po[co] = __float2bfloat16_rn(o);
    }
  }
}

template <int COUT, typename WT>
cudaError_t launch(const void* x, const void* w, const float* bias,
                   const float* scale, const float* offset, void* out, int B,
                   int D, int H, int W, int cin, int dilation, int fuse,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(cin, COUT);
  if (smem > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dilated_conv3d_lp_kernel<COUT, WT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  if ((int64_t)B * D * H * W == 0) return cudaSuccess;
  constexpr int R = Blocking<COUT>::R;
  const int chunks_x = (W + 32 * R - 1) / (32 * R);
  const int groups_y = (H + kWarps - 1) / kWarps;
  dilated_conv3d_lp_kernel<COUT, WT><<<dim3(chunks_x * groups_y, D, B), kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const WT*>(w), bias, scale,
      offset, static_cast<__nv_bfloat16*>(out), D, H, W, cin, dilation, fuse,
      chunks_x);
  return cudaGetLastError();
}

template <typename WT>
cudaError_t dispatch(const void* x, const void* w, const float* bias,
                     const float* scale, const float* offset, void* out, int B,
                     int D, int H, int W, int cin, int cout, int dilation,
                     int fuse, cudaStream_t s) {
  switch (cout) {
    case 5:
      return launch<5, WT>(x, w, bias, scale, offset, out, B, D, H, W, cin, dilation, fuse, s);
    case 10:
      return launch<10, WT>(x, w, bias, scale, offset, out, B, D, H, W, cin, dilation, fuse, s);
    case 18:
      return launch<18, WT>(x, w, bias, scale, offset, out, B, D, H, W, cin, dilation, fuse, s);
    case 21:
      return launch<21, WT>(x, w, bias, scale, offset, out, B, D, H, W, cin, dilation, fuse, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int COUT, typename WT>
int occupancy(int cin) {
  int blocks = 0;
  const size_t smem = smem_bytes(cin, COUT);
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(dilated_conv3d_lp_kernel<COUT, WT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, dilated_conv3d_lp_kernel<COUT, WT>, kThreads, smem) != cudaSuccess)
    return -1;
  return blocks;
}

}  // namespace

extern "C" {

// Output channel counts this library is instantiated for: MeshNet's hidden
// widths, as K1's.
int repro_dilated_conv3d_lp_supports(int cout) {
  return cout == 5 || cout == 10 || cout == 18 || cout == 21;
}

// Bytes of shared memory one block of cin -> cout allocates: the fp32
// weights at row stride Cout rounded up to 4, then bias, scale and offset.
long long repro_dilated_conv3d_lp_smem_bytes(int cin, int cout) {
  return (long long)smem_bytes(cin, cout);
}

// Blocks of cin -> cout one SM holds at once (the runtime's occupancy
// calculator), int8 weights when w_int8 != 0; -1 if not instantiated.
int repro_dilated_conv3d_lp_blocks_per_sm(int cin, int cout, int w_int8) {
  switch (cout * 2 + (w_int8 != 0)) {
    case 10: return occupancy<5, __nv_bfloat16>(cin);
    case 11: return occupancy<5, int8_t>(cin);
    case 20: return occupancy<10, __nv_bfloat16>(cin);
    case 21: return occupancy<10, int8_t>(cin);
    case 36: return occupancy<18, __nv_bfloat16>(cin);
    case 37: return occupancy<18, int8_t>(cin);
    case 42: return occupancy<21, __nv_bfloat16>(cin);
    case 43: return occupancy<21, int8_t>(cin);
    default: return -1;
  }
}

// x: (B, D, H, W, cin) bf16 contiguous; w: (3, 3, 3, cin, cout), int8 when
// w_int8 != 0, else bf16; bias, scale, offset: (cout,) fp32 (scale/offset
// read only when fuse != 0); out: (B, D, H, W, cout) bf16. Returns a
// cudaError_t (0 on success).
int repro_dilated_conv3d_lp(const void* x, const void* w, int w_int8,
                            const float* bias, const float* scale,
                            const float* offset, void* out, int B, int D,
                            int H, int W, int cin, int cout, int dilation,
                            int fuse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_int8)
    return (int)dispatch<int8_t>(x, w, bias, scale, offset, out, B, D, H, W, cin, cout, dilation, fuse, s);
  return (int)dispatch<__nv_bfloat16>(x, w, bias, scale, offset, out, B, D, H, W, cin, cout, dilation, fuse, s);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
