// K2r for Hopper: K2's segment at the bf16 and int8w policies, on the bf16
// tensor cores. For each output tile and batch member, the segment's k
// dilated 3x3x3 conv layers run back to back, each with bias and the fused
// epilogue relu((acc + bias) * scale + offset) (folded BatchNorm, and the
// int8 weights' dequant scale); the segment may end in the fused 1x1x1
// head. Positions outside the true volume are set to zero after every layer
// but the last. With a narrower valid Z interval [z_lo, z_hi) in the
// geometry it is K2r-z, as K2z is K2's (megakernel.cu): rows outside it are
// treated as outside the volume. A band [band_lo, band_hi) of output rows
// narrows a launch as K2's does: only the Z tiles that meet it, no input row
// farther than the segment's halo from it, only its rows written.
//
// Replaces the TPU kernel src/repro/kernels/megakernel.py::_segment_kernel
// at the reference's bf16 and int8w policies (its compute_dtype scratch,
// deq_in and quant_out). What it computes, from the reference's code:
//  - Input: the segment's staging array, bf16 or int8. Under int8w the
//    first segment reads the conformed volume's int8 codes; their fixed
//    scale rides the first layer's epilogue scale, so the codes are taken
//    as they are. A later segment reading int8 staging multiplies each tap
//    value by its channel's dequant scale (deq) in its first layer.
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
// Design. Each layer is an implicit GEMM on mma.sync m16n8k16 (bf16 in,
// fp32 sums): M is 16 output voxels along x, N the C output channels padded
// to 8 (5 -> 8, 10 -> 16, 18 and 21 -> 24), K one input row's three x taps
// times its channels padded to a multiple of 8 (cin 1 or 5 -> 8: 24, two
// k16 steps a tap row). Every operand is exact in bf16 (bf16 activations
// and weights, int8 codes |c| <= 127), so the products are exact in fp32
// and only the order of the sums differs from the plain version's. The one
// inexact operand is a code times its dequant scale: deq is folded into the
// first layer's weights in fp32, split into a bf16 hi and lo (w deq = hi +
// lo + O(2^-16) relative), and each such product is two mmas. A block of 4
// warps takes one (tile, batch member). A warp's item is up to 2 output
// rows (3 at C = 10, 4 at C > 16) d apart in y of one z row (as K2's row groups; rows past the region
// are not issued) over NX = 16 MT voxels along x (64 at C = 5); its 3 (rows
// + 2) input rows are each laid out once in the warp's A buffer, every
// position's channels padded to 8 (16 bytes a group, an odd number of
// groups a position), so that one ldmatrix.x4 fetches a 16 x 16 A operand
// (8 positions' rows of 16 bytes a matrix); each row then feeds the mmas
// of every output row of the item it reaches, up to 3 (B fragments in
// shared memory in fragment order, 8 bytes a lane, staged once per block).
//  - The first layer reads its input rows from device memory: each warp
//    keeps a ring of 3 row spans (NX + 2 d positions) in flight by
//    cp.async.cg 16-byte copies, so the next rows' copies overlap this
//    row's mmas. A bf16 staging array of several channels holds each
//    position at 8 channels a group (megakernel.staging_empty): each group
//    is one copy of its channels' bytes with the rest zero-filled, straight
//    into the A layout, and positions outside the volume read nothing. Any
//    other staging array (int8, or one channel) is packed with each x row's
//    pitch padded to 16 bytes, so a span is copied in whole granules of its
//    own row and then laid out into the warp's A buffer with its positions
//    outside the volume set to zero. Rows outside the volume or the valid
//    interval are skipped: nothing of the border or of a pad is read as
//    data.
//  - Hidden layers (multi-layer segments) keep their outputs in shared
//    memory as bf16 (ping, pong; exact, since they are bf16-rounded) in the
//    same padded layout, and the next layer fetches its A operands from
//    them directly.
//  - The last layer's bf16 rows of several channels go out in the same
//    padded layout, each lane's two channels of a voxel one 4-byte store (a
//    warp's store covers 8 positions, 128 contiguous bytes: no staging in
//    shared memory is needed to coalesce them). int8 rows and the head's
//    logits go out through a per-warp row buffer in shared memory, placed
//    at the row's own alignment, as 16-byte stores (the partial granules at
//    a row's ends byte by byte). The fused head is one more mma a 16
//    voxels: the bf16 activations' accumulator fragments are the A operand
//    of the head's k16 steps.
//
// What bounds it on the card: a 5 -> 5 layer does 27 x 25 multiply-adds a
// voxel against 20 bytes at 2-byte activations, under the memory rate's
// ridge on the bf16 tensor cores (295 operations a byte), so device bytes
// bound the function. This kernel issues 18 m16n8k16 a 16 voxels (135 of
// every 512 MACs useful) and a few dozen instructions an input row; the
// instructions a row (the copy, the layout, the loop) and their latency,
// not the tensor cores, are its cost (kernels/megakernel.py::
// _lp_segment_work). At 4 blocks of 4 warps an SM (128 registers a thread)
// 16 warps cover the copies' latency.
//
// Plain C entry points (bound from Python with ctypes); the launch goes on
// the caller's stream, does not synchronise and allocates nothing.

#include <cuda_bf16.h>
#include <stdint.h>

#include "conv_tile.cuh"

namespace {

constexpr int kMaxLayers = 16;
constexpr int kGeomFixed = 27;  // ints before the dilations in the geometry array
constexpr int kSmemLimit = 232448;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;  // input row spans a warp keeps in flight

// Tensor-core blocking for C output channels.
template <int C>
struct Tc {
  static constexpr int M = C <= 8 ? 2 : C <= 16 ? 3 : 4;   // output rows of an item, d apart in y
  static constexpr int MT = C <= 8 ? 4 : C <= 16 ? 2 : 1;  // m16 tiles along x an item
  static constexpr int NT = (C + 7) / 8;                   // n8 tiles of output channels
  static constexpr int NX = 16 * MT;                       // voxels along x an item
  static constexpr int KH = (NT + 1) / 2;                  // k16 steps of the fused head
};

__host__ __device__ inline int ceil16(int v) { return (v + 15) & ~15; }
// groups of 8 channels of cin; bytes a position in an A buffer (an odd
// number of 16-byte groups, so 8 positions' rows fall in distinct banks);
// k16 steps of one input row (3 x taps x the groups, two groups a step)
__host__ __device__ inline int cgroups(int cin) { return (cin + 7) / 8; }
__host__ __device__ inline int pos_bytes(int cin) { return (cgroups(cin) | 1) * 16; }
__host__ __device__ inline int ksteps(int cin) { return (3 * cgroups(cin) + 1) / 2; }

struct Geom {
  int B, cin, k, classes;
  int vol[3], tile[3], ntiles[3];
  int in_dims[3], in_halo;
  int out_dims[3], out_halo;
  int n_params, ping, pong, ring;  // shared memory in 4-byte units
  int z_lo, z_hi;                  // the valid Z interval, within [0, vol[0]) (K2r-z: narrower)
  int band_lo, band_hi;            // the output rows written, within the tile-padded region
  int t0_lo;                       // the first Z tile that meets the band
  int dil[kMaxLayers];
};

// The layout one block allocates, in bytes (kernels/megakernel.py::
// _smem_layout_lp): params (16 zero bytes; per layer its B fragments, twice
// for the first layer when it dequantises, its A-offset table and its bias,
// scale and offset; the head's fragments and bias; deq and qscale), ping,
// pong (the hidden layers' bf16 outputs in the A layout), ring (per warp
// kStages row spans, copied into the A layout when direct, else packed and
// then laid out in an A buffer, and an output row buffer when the output is
// int8 or the head's logits; sized for the first layer's and the tile's x
// extents, each at most NX).
struct Layout {
  int params, ping, pong, ring, slot, abuf, obuf;
};

// The first layer's output halo: the dilations after it.
__host__ __device__ inline int r0_of(const Geom& g) {
  int r = 0;
  for (int l = 1; l < g.k; ++l) r += g.dil[l];
  return r;
}

template <int C>
__host__ __device__ Layout layout_of(const Geom& g, int has_deq, bool direct, bool row_buffer) {
  Layout L{16, 0, 0, 0, 0, 0, 0};
  for (int l = 0; l < g.k; ++l) {
    const int ks = ksteps(l == 0 ? g.cin : C);
    L.params += 9 * ks * Tc<C>::NT * 256 * (l == 0 && has_deq ? 2 : 1) + ceil16(8 * ks) + ceil16(12 * C);
  }
  if (g.classes > 0) L.params += Tc<C>::KH * ((g.classes + 7) / 8) * 256 + ceil16(4 * g.classes);
  L.params += ceil16(4 * g.cin) + ceil16(4 * C);
  int r = 0;
  for (int l = 0; l < g.k; ++l) r += g.dil[l];
  for (int l = 0; l + 1 < g.k; ++l) {
    r -= g.dil[l];
    const int bytes = (g.tile[0] + 2 * r) * (g.tile[1] + 2 * r) * (g.tile[2] + 2 * r) * pos_bytes(C);
    int& buf = (l & 1) ? L.pong : L.ping;
    if (bytes > buf) buf = bytes;
  }
  const int span = min(Tc<C>::NX, g.tile[2] + 2 * r0_of(g)) + 2 * g.dil[0], xl = min(Tc<C>::NX, g.tile[2]);
  L.slot = direct ? span * pos_bytes(g.cin) : ceil16(span * g.cin * 2) + 32;
  L.abuf = direct ? 0 : span * pos_bytes(g.cin);
  L.obuf = row_buffer ? ceil16(xl * (g.classes > 0 ? g.classes : C) * 2) + 16 : 0;
  L.ring = kWarps * (kStages * L.slot + L.abuf + L.obuf);
  return L;
}

template <int C>
bool layout_matches(const Geom& g, int has_deq, bool direct, bool row_buffer) {
  const Layout L = layout_of<C>(g, has_deq, direct, row_buffer);
  return 4 * g.n_params == L.params && 4 * g.ping == L.ping && 4 * g.pong == L.pong && 4 * g.ring == L.ring;
}

__device__ __forceinline__ float widen_bf16(uint16_t bits) {
  return __uint_as_float((uint32_t)bits << 16);  // bf16 -> fp32, exact
}
__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
__device__ __forceinline__ uint32_t pack_bits(uint16_t lo, uint16_t hi) { return (uint32_t)lo | ((uint32_t)hi << 16); }

// One element as bf16 bits: a bf16 value as it is, an int8 code converted
// exactly.
__device__ __forceinline__ uint16_t elem_bits(const uint16_t* p) { return *p; }
__device__ __forceinline__ uint16_t elem_bits(const int8_t* p) { return bf16_bits((float)*p); }

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// Four 8 x 8 bf16 matrices from shared memory (this lane's row address
// for matrix lane / 8, row lane % 8): the A operand of one m16n8k16.
__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

// 16 bytes to shared memory, of which the first src_bytes come from src
// and the rest are zero (src_bytes 0: nothing is read).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// A warp's item: z row j0 of the layer's output region, the row group whose
// first row is j1 (rows j1 + m d, m < meff), the x chunk at x0 of nv voxels
// (none: an item outside the band).
struct Item {
  int j0, j1, x0, meff, nv;
};

// One input row (tap plane tz, row j of the item's group: -1 .. meff), laid
// out at shared address rows[mt] for m16 tile mt (this lane's ldmatrix row:
// its position's first byte), into every output row m it reaches through
// tap row ty = j + 1 - m: per k16 step the A operands once (aoff: this
// lane's offset of the step's group from its position, -1 for the zero
// group), then per output row and n8 tile one B fragment (two with deq: hi
// and lo) and MT mmas.
template <int C>
__device__ __forceinline__ void row_mmas(float (&acc)[Tc<C>::M][Tc<C>::MT][Tc<C>::NT][4], const unsigned (&rows)[Tc<C>::MT],
                                         unsigned zero, int ks, const int* aoff, const uint2* frag,
                                         const uint2* frag_lo, int tz, int j, int meff, int lane) {
  constexpr int MT = Tc<C>::MT, NT = Tc<C>::NT, M = Tc<C>::M;
  const int half = lane >> 4;
  for (int s = 0; s < ks; ++s) {
    const int off = aoff[2 * s + half];
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) ldsm_x4(a[mt], off >= 0 ? rows[mt] + off : zero);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int ty = j + 1 - m;
      if (m >= meff || ty < 0 || ty > 2) continue;
      const int f = ((tz * 3 + ty) * ks + s) * NT;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint2 b = frag[(f + nt) * 32 + lane];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma16816(acc[m][mt][nt], a[mt], b);
        if (frag_lo != nullptr) {
          const uint2 bl = frag_lo[(f + nt) * 32 + lane];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma16816(acc[m][mt][nt], a[mt], bl);
        }
      }
    }
  }
}

// Lay a staged span of n_span positions (x = gx_lo ..) out in the A
// buffer: each position's channels as bf16 in groups of 8 (16 bytes), zero
// past cin and outside the volume [0, W). CIN: the channels when the
// compiler may know them (1, or the segment's width), else 0 (cin).
template <int CIN, typename XT>
__device__ __forceinline__ void lay_out(unsigned char* abuf, const XT* span, int n_span, int gx_lo, int W, int cin_rt,
                                        int lane) {
  const int cin = CIN > 0 ? CIN : cin_rt;
  const int cg = cgroups(cin), pb = pos_bytes(cin);
  for (int p = lane; p < n_span; p += 32) {
    const bool in = gx_lo + p >= 0 && gx_lo + p < W;
    const XT* src = span + p * cin;
    for (int grp = 0; grp < cg; ++grp) {
      uint32_t w4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c0 = grp * 8 + 2 * e;
        w4[e] = pack_bits(in && c0 < cin ? elem_bits(src + c0) : 0, in && c0 + 1 < cin ? elem_bits(src + c0 + 1) : 0);
      }
      *reinterpret_cast<uint4*>(abuf + p * pb + grp * 16) = make_uint4(w4[0], w4[1], w4[2], w4[3]);
    }
  }
}

// XT: the input staging array's element, uint16_t (bf16 bits) or int8_t.
// w_int8: the conv weights are int8 codes (else bf16); out_int8: the last
// layer writes int8 codes (else bf16); has_deq: the first layer's taps are
// dequantised by deq (else taken as they are).
template <int C, typename XT>
__global__ void __launch_bounds__(kThreads, 4)
segment_tc_kernel(const XT* __restrict__ x, const void* __restrict__ wq, const uint16_t* __restrict__ hw,
                  const float* __restrict__ vec, void* __restrict__ out, int w_int8, int out_int8, int has_deq,
                  const Geom g) {
  constexpr int MT = Tc<C>::MT, NT = Tc<C>::NT, NX = Tc<C>::NX, KH = Tc<C>::KH, M = Tc<C>::M;
  extern __shared__ __align__(16) unsigned char smem[];
  // a bf16 staging array of several channels holds each position at a
  // multiple of 8 channels: copied straight into the A layout ("direct")
  const bool direct = sizeof(XT) == 2 && g.cin > 1;
  const bool row_buffer = g.classes > 0 || out_int8;
  const Layout L = layout_of<C>(g, has_deq, direct, row_buffer);
  unsigned char* s_ping = smem + L.params;
  unsigned char* s_pong = s_ping + L.ping;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g8 = lane >> 2, q = lane & 3;
  const int NH = (g.classes + 7) / 8;
  const float* g_hb = vec + 3 * C * g.k;  // the head's bias, then deq, then qscale
  const float* g_deq = g_hb + g.classes;
  const float* g_qs = g_deq + g.cin;

  // stage the parameters: 16 zero bytes (the zero group of A operands);
  // per layer its B fragments (lane-major words {B[2q][g], B[2q+1][g]},
  // {B[2q+8][g], B[2q+9][g]}; row k of a tap row (tz, ty) is group k / 8,
  // i.e. x tap gi / cg and channel (gi % cg) 8 + k % 8 with cg groups of 8
  // channels, column n the output channel; the first layer's with deq as hi
  // and lo), its A-offset table (per k16 step and half of the lanes: the
  // byte offset of its group from a voxel's tap -1 position, -1 for the
  // zero group) and bias, scale, offset; then the head's fragments and
  // bias, deq and qscale
  const unsigned char* s_head = nullptr;
  const float* s_hb = nullptr;
  const float* s_qs = nullptr;
  {
    if (tid < 4) reinterpret_cast<uint32_t*>(smem)[tid] = 0;
    unsigned char* p = smem + 16;
    int64_t woff = 0;
    for (int l = 0; l < g.k; ++l) {
      const int cin = l == 0 ? g.cin : C, ks = ksteps(cin), d = g.dil[l];
      const int cg = cgroups(cin), pb = pos_bytes(cin);
      const int nfrag = 9 * ks * NT;
      const bool split = l == 0 && has_deq;
      uint32_t* hi = reinterpret_cast<uint32_t*>(p);
      uint32_t* lo = hi + nfrag * 64;
      for (int i = tid; i < nfrag * 64; i += kThreads) {
        const int f = i >> 6, word = i & 63, ln = word >> 1, reg = word & 1;
        const int tr = f / (ks * NT), rest = f - tr * ks * NT, st = rest / NT, nt = rest - st * NT;
        const int n = nt * 8 + (ln >> 2);
        uint16_t h2[2], l2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = st * 16 + 2 * (ln & 3) + e + 8 * reg;
          const int gi = k >> 3, tx = gi / cg, ci = (gi - tx * cg) * 8 + (k & 7);
          float w = 0.0f;
          if (tx < 3 && ci < cin && n < C) {
            const int64_t at = woff + ((int64_t)(tr * 3 + tx) * cin + ci) * C + n;
            w = w_int8 ? (float)static_cast<const int8_t*>(wq)[at] : widen_bf16(static_cast<const uint16_t*>(wq)[at]);
            if (split) w *= g_deq[ci];
          }
          h2[e] = bf16_bits(w);
          l2[e] = bf16_bits(w - widen_bf16(h2[e]));
        }
        hi[i] = pack_bits(h2[0], h2[1]);
        if (split) lo[i] = pack_bits(l2[0], l2[1]);
      }
      p += nfrag * 256 * (split ? 2 : 1);
      int* table = reinterpret_cast<int*>(p);
      for (int i = tid; i < 2 * ks; i += kThreads) {
        const int tx = i / cg;
        table[i] = i < 3 * cg ? tx * d * pb + (i - tx * cg) * 16 : -1;
      }
      p += ceil16(8 * ks);
      float* v = reinterpret_cast<float*>(p);
      for (int i = tid; i < ceil16(12 * C) / 4; i += kThreads) v[i] = i < 3 * C ? vec[3 * C * l + i] : 0.0f;
      p += ceil16(12 * C);
      woff += 27 * (int64_t)cin * C;
    }
    if (g.classes > 0) {
      uint32_t* hf = reinterpret_cast<uint32_t*>(p);
      for (int i = tid; i < KH * NH * 64; i += kThreads) {
        const int f = i >> 6, word = i & 63, ln = word >> 1, reg = word & 1;
        const int kh = f / NH, nh = f - kh * NH, n = nh * 8 + (ln >> 2);
        uint16_t h2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = kh * 16 + 2 * (ln & 3) + e + 8 * reg;
          h2[e] = k < C && n < g.classes ? hw[k * g.classes + n] : 0;
        }
        hf[i] = pack_bits(h2[0], h2[1]);
      }
      s_head = p;
      p += KH * NH * 256;
      float* hb = reinterpret_cast<float*>(p);
      for (int i = tid; i < g.classes; i += kThreads) hb[i] = g_hb[i];
      s_hb = hb;
      p += ceil16(4 * g.classes);
    }
    p += ceil16(4 * g.cin);  // deq: folded into the first layer's fragments
    float* qs = reinterpret_cast<float*>(p);
    for (int i = tid; i < C; i += kThreads) qs[i] = g_qs[i];
    s_qs = qs;
  }
  __syncthreads();

  // block -> (tile z, y, x, batch member), batch innermost; the Z tiles
  // those that meet the band
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
  // bytes a position and an x row of the input and output staging arrays
  // (megakernel.staging_strides; the head's logits packed)
  const int xpb = direct ? 16 * cgroups(g.cin) : g.cin * (int)sizeof(XT);
  const int64_t in_pitch = direct ? (int64_t)g.in_dims[2] * xpb : ceil16(g.in_dims[2] * xpb);
  const int oes = g.classes > 0 ? 2 : (out_int8 ? 1 : 2);
  const int cout = g.classes > 0 ? g.classes : C;
  const int opos = row_buffer ? cout * oes : 16 * cgroups(C);
  const int64_t out_pitch = g.classes > 0 ? (int64_t)g.out_dims[2] * opos
                            : out_int8   ? ceil16(g.out_dims[2] * opos)
                                         : (int64_t)g.out_dims[2] * opos;
  // this warp's ring, A buffer and row buffer, as offsets into smem
  const int ring_at = L.params + L.ping + L.pong + warp * (kStages * L.slot + L.abuf + L.obuf);
  const int abuf_at = ring_at + kStages * L.slot, obuf_at = abuf_at + L.abuf;

  const unsigned zero = (unsigned)__cvta_generic_to_shared(smem);
  const int vo = ((lane >> 3) & 1) * 8 + (lane & 7);  // this lane's ldmatrix row: a voxel of an m16 tile

  const unsigned char* lp = smem + 16;  // this layer's parameters
  const unsigned char* prev = nullptr;  // the previous layer's bf16 output, this region grown by d a side
  int p1 = 0, p2 = 0;                   // Y and X extents of prev
  for (int l = 0; l < g.k; ++l) {
    const int d = g.dil[l];
    const int ro = r - d;  // halo of this layer's output
    const int cin = l == 0 ? g.cin : C, ks = ksteps(cin), pb = pos_bytes(cin);
    const uint2* frag = reinterpret_cast<const uint2*>(lp);
    const uint2* frag_lo = (l == 0 && has_deq) ? frag + 9 * ks * NT * 32 : nullptr;
    lp += 9 * ks * NT * 256 * (frag_lo != nullptr ? 2 : 1);
    const int* aoff = reinterpret_cast<const int*>(lp);
    lp += ceil16(8 * ks);
    const float* bias = reinterpret_cast<const float*>(lp);
    const float* scale = bias + C;
    const float* offset = scale + C;
    lp += ceil16(12 * C);
    const int s0 = g.tile[0] + 2 * ro, s1 = g.tile[1] + 2 * ro, s2 = g.tile[2] + 2 * ro;
    const int groups = conv_tile::row_groups(s1, d, M);
    const int nch = (s2 + NX - 1) / NX;
    const int n_items = s0 * groups * nch;
    const bool last = l == g.k - 1;
    unsigned char* dst = (l & 1) ? s_pong : s_ping;
    const int opb = pos_bytes(C);  // bytes a position of this layer's hidden output

    auto decode = [&](int item) {
      Item it;
      const int zr = item / nch;
      it.x0 = (item - zr * nch) * NX;
      it.j0 = zr / groups;
      it.j1 = conv_tile::group_row(zr - it.j0 * groups, d, M);
      it.meff = min(M, (s1 - 1 - it.j1) / d + 1);
      it.nv = min(NX, s2 - it.x0);
      const int gz = o0 - ro + it.j0;
      if (last && (gz < g.band_lo || gz >= g.band_hi)) it.nv = 0;
      return it;
    };
    // this lane's ldmatrix rows of an item whose voxel 0 sits at buf
    auto lane_rows = [&](unsigned (&rows)[MT], const unsigned char* buf, int nv) {
      const unsigned base = (unsigned)__cvta_generic_to_shared(buf);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) rows[mt] = base + min(16 * mt + vo, nv - 1) * pb;
    };

    float acc[M][MT][NT][4];
    auto zero_acc = [&]() {
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][mt][nt][e] = 0.0f;
    };

    // the outputs of an item: a hidden layer's, masked outside the volume
    // and the valid interval, into dst (its padded channels zero); the last
    // layer's row by row through the warp's row buffer to device memory
    // the epilogue of this lane's channel n (zero past C: relu(0) = 0)
    auto epi = [&](float a, int nt, int k2) {
      const int n = nt * 8 + 2 * q + k2;
      return n < C ? fmaxf((a + bias[n]) * scale[n] + offset[n], 0.0f) : 0.0f;
    };

    // one output row of an item (row m of its group), from acc[0]
    auto out_row = [&](const Item& it, int gz, int m) {
        const int jm = it.j1 + m * d;
        const int gy = o1 - ro + jm;
        if (!last) {
          const bool zy = gz >= g.z_lo && gz < g.z_hi && gy >= 0 && gy < g.vol[1];
          unsigned char* pd = dst + ((int64_t)(it.j0 * s1 + jm) * s2 + it.x0) * opb;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int hr = 0; hr < 2; ++hr) {
                const int v = 16 * mt + g8 + 8 * hr, n = nt * 8 + 2 * q;
                if (v >= it.nv) continue;
                const int gx = o2 - ro + it.x0 + v;
                const bool inside = zy && gx >= 0 && gx < g.vol[2];
                const uint16_t v0 = inside ? bf16_bits(epi(acc[0][mt][nt][2 * hr], nt, 0)) : 0;
                const uint16_t v1 = inside ? bf16_bits(epi(acc[0][mt][nt][2 * hr + 1], nt, 1)) : 0;
                *reinterpret_cast<uint32_t*>(pd + v * opb + n * 2) = pack_bits(v0, v1);
              }
          return;
        }
        // the row's bytes in device memory
        unsigned char* gdst = static_cast<unsigned char*>(out) +
                              (((int64_t)b * g.out_dims[0] + gz + g.out_halo) * g.out_dims[1] + gy + g.out_halo) *
                                  out_pitch +
                              (int64_t)(g.out_halo + o2 + it.x0) * opos;
        if (!row_buffer) {
          // bf16 positions of 8 channels a group: each lane's two channels
          // of a voxel are one 4-byte store, 8 voxels' 128 bytes a warp's
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int hr = 0; hr < 2; ++hr) {
                const int v = 16 * mt + g8 + 8 * hr;
                if (v >= it.nv) continue;
                *reinterpret_cast<uint32_t*>(gdst + v * opos + (nt * 8 + 2 * q) * 2) =
                    pack_bits(bf16_bits(epi(acc[0][mt][nt][2 * hr], nt, 0)), bf16_bits(epi(acc[0][mt][nt][2 * hr + 1], nt, 1)));
              }
          return;
        }
        // through the row buffer, at the row's own alignment
        const int sh = (int)(reinterpret_cast<uintptr_t>(gdst) & 15);
        if (g.classes > 0) {
          uint16_t* ob = reinterpret_cast<uint16_t*>(smem + obuf_at + sh);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t ah[KH][4];
#pragma unroll
            for (int kh = 0; kh < KH; ++kh)
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int nt = 2 * kh + half;
                uint16_t h[4] = {0, 0, 0, 0};
                if (nt < NT) {
#pragma unroll
                  for (int e = 0; e < 4; ++e) {
                    h[e] = bf16_bits(epi(acc[0][mt][nt][e], nt, e & 1));
                  }
                }
                ah[kh][2 * half] = pack_bits(h[0], h[1]);
                ah[kh][2 * half + 1] = pack_bits(h[2], h[3]);
              }
            const uint2* hf = reinterpret_cast<const uint2*>(s_head);
            for (int nh = 0; nh < NH; ++nh) {
              float ch[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
              for (int kh = 0; kh < KH; ++kh) mma16816(ch, ah[kh], hf[(kh * NH + nh) * 32 + lane]);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int v = 16 * mt + g8 + 8 * (e >> 1), cls = nh * 8 + 2 * q + (e & 1);
                if (v < it.nv && cls < g.classes) ob[v * g.classes + cls] = bf16_bits(ch[e] + s_hb[cls]);
              }
            }
          }
        } else {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int v = 16 * mt + g8 + 8 * (e >> 1), n = nt * 8 + 2 * q + (e & 1);
                if (v >= it.nv || n >= C) continue;
                const float val = epi(acc[0][mt][nt][e], nt, e & 1);
                if (out_int8) {
                  const float qv = fminf(fmaxf(rintf(__fdiv_rn(val, s_qs[n])), -127.0f), 127.0f);
                  reinterpret_cast<int8_t*>(smem + obuf_at + sh)[v * C + n] = (int8_t)(int)qv;
                } else {
                  reinterpret_cast<uint16_t*>(smem + obuf_at + sh)[v * C + n] = bf16_bits(val);
                }
              }
        }
        __syncwarp();
        // 16-byte stores of the granules wholly inside the row, bytes at its ends
        const uintptr_t lo = reinterpret_cast<uintptr_t>(gdst), hi = lo + (uintptr_t)it.nv * opos;
        const uintptr_t a0 = lo & ~(uintptr_t)15;
        const int ng = (int)((hi - a0 + 15) >> 4);
        for (int i = lane; i < ng; i += 32) {
          const uintptr_t ga = a0 + 16 * (uintptr_t)i;
          const unsigned char* src = smem + obuf_at + 16 * i;
          if (ga >= lo && ga + 16 <= hi) {
            *reinterpret_cast<uint4*>(ga) = *reinterpret_cast<const uint4*>(src);
          } else {
            for (uintptr_t a = ga < lo ? lo : ga; a < ga + 16 && a < hi; ++a)
              *reinterpret_cast<unsigned char*>(a) = src[a - ga];
          }
        }
        __syncwarp();
    };
    // an item's rows one at a time, each from acc[0], the rows after it
    // moved down: one copy of the row's code, not one a row
    auto epilogue = [&](const Item& it) {
      const int gz = o0 - ro + it.j0;
#pragma unroll 1
      for (int m = 0; m < it.meff; ++m) {
        out_row(it, gz, m);
#pragma unroll
        for (int mm = 0; mm + 1 < M; ++mm)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[mm][mt][nt][e] = acc[mm + 1][mt][nt][e];
      }
    };

    if (l == 0) {
      // from the input staging array in device memory: the warp's items in
      // turn, their input rows (tap plane tz, group row j) through the
      // warp's ring, kStages - 1 copies ahead of the row being multiplied
      struct Cursor {
        int item, tz, j;
        Item it;
      };
      auto settle = [&](Cursor& c) {  // at the first step of an item that has any
        c.tz = 0;
        c.j = -1;
        while (c.item < n_items) {
          c.it = decode(c.item);
          if (c.it.nv > 0) break;
          c.item += kWarps;
        }
      };
      auto advance = [&](Cursor& c) {
        if (++c.j > c.it.meff) {
          c.j = -1;
          if (++c.tz == 3) {
            c.item += kWarps;
            settle(c);
          }
        }
      };
      // the row a step reads, or null outside the volume or the rows read
      auto row_of = [&](const Cursor& c) -> const unsigned char* {
        const int z = o0 - ro + c.it.j0 + (c.tz - 1) * d;
        const int y = o1 - ro + c.it.j1 + c.j * d;
        if (z < zin_lo || z >= zin_hi || y < 0 || y >= g.vol[1]) return nullptr;
        return reinterpret_cast<const unsigned char*>(x) +
               (((int64_t)b * g.in_dims[0] + z + g.in_halo) * g.in_dims[1] + y + g.in_halo) * in_pitch +
               (int64_t)(g.in_halo + o2 - ro + c.it.x0 - d) * xpb;
      };
      auto issue = [&](const Cursor& c, int slot) {
        if (c.item < n_items) {
          const unsigned char* s_lo = row_of(c);
          if (s_lo != nullptr) {
            unsigned char* dstp = smem + ring_at + slot * L.slot;
            const int n_span = c.it.nv + 2 * d;
            if (direct) {
              // position by position, group by group, into the A layout: only
              // the channels' bytes are read, the rest zero-filled, and
              // positions outside the volume read nothing
              const int cg = cgroups(cin), gx_lo = o2 - ro + c.it.x0 - d;
              for (int i = lane; i < n_span * cg; i += 32) {
                const int pos = i / cg, grp = i - pos * cg;
                const bool in = gx_lo + pos >= 0 && gx_lo + pos < g.vol[2];
                const int bytes = in ? 2 * min(8, cin - 8 * grp) : 0;
                cp_async16_zfill(dstp + pos * pb + 16 * grp, in ? s_lo + pos * xpb + 16 * grp : s_lo, bytes);
              }
            } else {
              const uintptr_t a0 = reinterpret_cast<uintptr_t>(s_lo) & ~(uintptr_t)15;
              const uintptr_t s_hi = reinterpret_cast<uintptr_t>(s_lo) + (uintptr_t)n_span * xpb;
              const int ng = (int)((s_hi - a0 + 15) >> 4);
              for (int i = lane; i < ng; i += 32) cp_async16(dstp + 16 * i, reinterpret_cast<const void*>(a0 + 16 * (uintptr_t)i));
            }
          }
        }
        conv_tile::cp_async_commit();  // an empty group past the end keeps the count
      };
      Cursor cur{warp, 0, -1, Item{}};
      settle(cur);
      {
        Cursor ahead = cur;
        for (int p = 0; p + 1 < kStages; ++p) {
          issue(ahead, p);
          if (ahead.item < n_items) advance(ahead);
        }
      }
      unsigned rows[MT];
      int qn = 0;
      while (cur.item < n_items) {
        if (cur.tz == 0 && cur.j == -1) {
          zero_acc();
          if (!direct) lane_rows(rows, smem + abuf_at, cur.it.nv);
        }
        {
          // the step kStages - 1 ahead, from this one (not kept across the
          // step: registers)
          Cursor ahead = cur;
          for (int p = 0; p + 1 < kStages && ahead.item < n_items; ++p) advance(ahead);
          issue(ahead, (qn + kStages - 1) % kStages);
        }
        conv_tile::cp_async_wait<kStages - 1>();
        __syncwarp();
        const unsigned char* s_lo = row_of(cur);
        if (s_lo != nullptr && direct) {
          lane_rows(rows, smem + ring_at + (qn % kStages) * L.slot, cur.it.nv);
          row_mmas<C>(acc, rows, zero, ks, aoff, frag, frag_lo, cur.tz, cur.j, cur.it.meff, lane);
        } else if (s_lo != nullptr) {
          // lay the span out in the A buffer
          const XT* span = reinterpret_cast<const XT*>(smem + ring_at + (qn % kStages) * L.slot +
                                                       (reinterpret_cast<uintptr_t>(s_lo) & 15));
          const int gx_lo = o2 - ro + cur.it.x0 - d, n_span = cur.it.nv + 2 * d;
          if (cin == 1)
            lay_out<1>(smem + abuf_at, span, n_span, gx_lo, g.vol[2], cin, lane);
          else if (cin == C)
            lay_out<C>(smem + abuf_at, span, n_span, gx_lo, g.vol[2], cin, lane);
          else
            lay_out<0>(smem + abuf_at, span, n_span, gx_lo, g.vol[2], cin, lane);
          __syncwarp();
          row_mmas<C>(acc, rows, zero, ks, aoff, frag, frag_lo, cur.tz, cur.j, cur.it.meff, lane);
        }
        __syncwarp();  // the span and the A buffer are read before they are refilled
        if (cur.tz == 2 && cur.j == cur.it.meff) epilogue(cur.it);
        advance(cur);
        ++qn;
      }
      conv_tile::cp_async_wait<0>();
    } else {
      // prev holds the previous layer over this region grown by d a side,
      // in the A layout
      for (int item = warp; item < n_items; item += kWarps) {
        const Item it = decode(item);
        if (it.nv == 0) continue;
        zero_acc();
        for (int tz = 0; tz < 3; ++tz)
          for (int j = -1; j <= it.meff; ++j) {
            unsigned rows[MT];
            lane_rows(rows, prev + ((int64_t)(it.j0 + tz * d) * p1 + it.j1 + (j + 1) * d) * p2 * pb + it.x0 * pb, it.nv);
            row_mmas<C>(acc, rows, zero, ks, aoff, frag, nullptr, tz, j, it.meff, lane);
          }
        epilogue(it);
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
    if (cudaFuncSetAttribute(segment_tc_kernel<C, int8_t>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, segment_tc_kernel<C, int8_t>, kThreads, (size_t)smem) !=
            cudaSuccess)
      return -1;
  } else {
    if (cudaFuncSetAttribute(segment_tc_kernel<C, uint16_t>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemLimit) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, segment_tc_kernel<C, uint16_t>, kThreads, (size_t)smem) !=
            cudaSuccess)
      return -1;
  }
  return n;
}

template <int C, typename XT>
cudaError_t launch_typed(const void* x, const void* w, const void* hw, const float* vec, void* out, int w_int8,
                         int out_int8, int has_deq, const Geom& g, size_t smem, cudaStream_t stream) {
  const auto kernel = segment_tc_kernel<C, XT>;
  if (smem > 48 * 1024) {  // raise the cap to the most, never lower it
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (e != cudaSuccess) return e;
  }
  const int64_t blocks = (int64_t)g.ntiles[0] * g.ntiles[1] * g.ntiles[2] * g.B;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(static_cast<const XT*>(x), w, static_cast<const uint16_t*>(hw),
                                                       vec, out, w_int8, out_int8, has_deq, g);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch(const void* x, int x_int8, const void* w, const void* hw, const float* vec, void* out, int w_int8,
                   int out_int8, int has_deq, const Geom& g, cudaStream_t stream) {
  if (!layout_matches<C>(g, has_deq, !x_int8 && g.cin > 1, g.classes > 0 || out_int8)) return cudaErrorInvalidValue;
  if (g.classes > 0 && (hw == nullptr || out_int8)) return cudaErrorInvalidValue;  // the head writes bf16 logits
  const size_t smem = (size_t)(g.n_params + g.ping + g.pong + g.ring) * 4;
  if (smem > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  if (x_int8) return launch_typed<C, int8_t>(x, w, hw, vec, out, w_int8, out_int8, has_deq, g, smem, stream);
  return launch_typed<C, uint16_t>(x, w, hw, vec, out, w_int8, out_int8, has_deq, g, smem, stream);
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
  g.t0_lo = g.band_lo / g.tile[0];
  g.ntiles[0] = g.band_hi > g.band_lo ? (g.band_hi + g.tile[0] - 1) / g.tile[0] - g.t0_lo : 0;
  return 0;
}

int segment(const void* x, int x_int8, const void* w, int w_int8, const void* hw, const float* vec, void* out,
            int out_int8, int has_deq, const int* geom, int n, void* stream) {
  Geom g;
  int c = 0;
  const int e = parse_geom(geom, n, g, c);
  if (e != 0) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 5:
      return (int)launch<5>(x, x_int8, w, hw, vec, out, w_int8, out_int8, has_deq, g, s);
    case 10:
      return (int)launch<10>(x, x_int8, w, hw, vec, out, w_int8, out_int8, has_deq, g, s);
    case 18:
      return (int)launch<18>(x, x_int8, w, hw, vec, out, w_int8, out_int8, has_deq, g, s);
    case 21:
      return (int)launch<21>(x, x_int8, w, hw, vec, out, w_int8, out_int8, has_deq, g, s);
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
// the volume at offset in_halo on each axis, channels-last in K2r's
// staging layout, 16-byte aligned (megakernel.staging_strides: bf16 of
// several channels at 8 channels a position group, else packed with each
// x row's pitch padded to a multiple of 16 bytes); w: every layer's conv
// weights (3, 3, 3, cin_l, C), concatenated, bf16 (this entry point) or
// int8 (repro_megakernel_segment_int8w); hw: the head's weights (C,
// classes) bf16 when classes > 0, else null; vec: fp32, every layer's
// bias, scale and offset (C each), the head's bias (classes, when fused),
// the first layer's dequant scales (cin; read only when has_deq != 0),
// the last layer's quantisation scales (C; read only when out_int8 != 0);
// out: (B, out_dims, classes or C), int8 codes when out_int8 != 0 else
// bf16, written at offset out_halo, in K2r's staging layout (the head's
// logits packed). geom as repro_megakernel_segment_f32's (its layout in
// 4-byte units, K2r's; z_lo, z_hi, band_lo, band_hi included). Returns a
// cudaError_t (0 on success).
int repro_megakernel_segment_bf16(const void* x, int x_int8, const void* w, const void* hw, const float* vec,
                                  void* out, int out_int8, int has_deq, const int* geom, int n, void* stream) {
  return segment(x, x_int8, w, 0, hw, vec, out, out_int8, has_deq, geom, n, stream);
}

int repro_megakernel_segment_int8w(const void* x, int x_int8, const void* w, const void* hw, const float* vec,
                                   void* out, int out_int8, int has_deq, const int* geom, int n, void* stream) {
  return segment(x, x_int8, w, 1, hw, vec, out, out_int8, has_deq, geom, n, stream);
}

const char* repro_megakernel_lp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
