// K1r for Hopper: K1's function at reduced widths, on the bf16 tensor
// cores. 'Same'-padded 3x3x3 dilated conv, channels-last, bf16 activations
// with bf16 or int8 weights, fp32 accumulation, + bias, with the optional
// fused epilogue relu((acc + bias) * scale + offset) that carries MeshNet's
// folded inference BatchNorm, the int8 dequant scale and the ReLU; the
// result is rounded once to bf16 (round to nearest even).
//
// Replaces the TPU kernel src/repro/kernels/dilated_conv3d.py::_halo_kernel
// at the reference's bf16 and int8w policies: there the haloed window and
// the weights are cast to fp32 in VMEM, the 27 taps accumulate in fp32 and
// the block is written at the activation dtype. The window design does not
// carry over (at d = 16 the window is over 1 MB at C = 5, against 227 KB
// of shared memory a Hopper block).
//
// Design. An implicit GEMM on mma.sync (bf16 in, fp32 sums), the tile
// math of K2r (megakernel_lp.cu): M is 16 output voxels along x, N the C
// output channels padded to 8 (5 -> 8, 10 -> 16, 18 and 21 -> 24), K one
// input row's three x taps times its channels padded to a multiple of 8.
// Every operand is exact in bf16 (bf16 activations and weights; int8 codes
// |c| <= 127 widen to bf16 exactly, once per block), so the products are
// exact in fp32 and only the order of the sums differs from the plain
// version's.
//  - Tile. A block of MZ warps (4, fewer where shared memory is short) owns
//    MZ x MY output rows of one batch member, d apart in z and in y (the row
//    groups of conv_tile.cuh), over NX = 16 MT voxels along x (C = 5: 4 x 2
//    rows x 64 voxels). Blocks are persistent (as many as the SMs hold) and
//    walk the tiles, so the weights are widened into B fragments (fragment
//    order, 8 bytes a lane) once per block, not once per tile.
//  - Staging. The block copies the (MZ + 2)(MY + 2) input rows its tile
//    reads once, each a span of NX + 2 d positions (three windows of NX
//    when d > NX), and lays them out in shared memory with every position's
//    channels padded to 8 (16 bytes a group, an odd number of groups a
//    position, so that ldmatrix's 8 rows fall in distinct banks); every
//    warp whose output rows read a row takes its A fragments from it by
//    ldmatrix. So each input row crosses from L2 to shared memory (MZ +
//    2)(MY + 2) / (MZ MY) times a layer (3 at C = 5; 2.6-3.0 at 256^3 with
//    the rows outside the volume skipped), against 9 loads per output row
//    in the first K1r and about 6 in K2r's per-warp streaming. Warp w
//    copies and lays out the staged rows w, w + MZ, ...: the contiguous
//    (B, D, H, W, Cin) rows go into a raw buffer as whole groups of 8
//    positions (16 Cin bytes) by TMA bulk copies (cp.async.bulk, one a row,
//    on the warp's mbarrier), issued during the previous tile's mmas; a
//    lane then lays out two positions from their 2 Cin words (Cin 1 and 5:
//    its loads and 16-byte stores conflict-free), or one position element
//    by element (other Cin). Cin a multiple of 8 is copied straight into the
//    layout by cp.async with zero fill, and rows or bases that are not so
//    aligned (test shapes such as W = 14 at Cin = 5) are laid out element by
//    element from device memory. Positions outside the volume are zeros;
//    rows outside it are neither copied nor multiplied.
//  - Math at C <= 8 from Cin <= 8 (every gwm_light layer): warp w computes
//    z rows 2 (w / 2) and 2 (w / 2) + 1 of the tile, both y rows, over the
//    32 voxels at 32 (w % 2): each staged row it loads feeds up to 2 z x 2
//    y output rows (4 planes of 4 rows for 4 output rows). Per staged row,
//    ldmatrix.x4 fetches the x taps -1 and 0 (one m16n8k16) and
//    ldmatrix.x2 tap +1 (one m16n8k8), so the padding group is never read;
//    the 9 tap rows' B fragments sit in registers during the mmas. Other
//    widths: warp w computes z row w, its MY rows (3 at C = 10, 4 at C >
//    16), 3 Cin groups a tap row in k16 steps, the fourth group (odd counts)
//    the 16 zero bytes at the start of shared memory, B fragments from
//    shared memory; past Cin 8 each tap's channels are summed apart and
//    added in fp32 (tap_mmas), so long chains of tensor-core steps do not
//    carry their truncations into the result.
//  - Epilogue. bias, scale, offset and ReLU in fp32 from the accumulator
//    fragments (the lane's channels' parameters in registers), one round to
//    bf16, each output row segment laid out contiguously in a buffer of the
//    warp at the row's own alignment, then written as 16-byte stores of the
//    contiguous row (the partial granules at a row's ends byte by byte).
//
// What bounds it on the card: a 5 -> 5 layer does 27 x 25 multiply-adds a
// voxel against 20 bytes of compulsory traffic at 2 bytes an element,
// under the bf16 tensor cores' ridge (295 operations a byte), so device
// bytes bound the function (0.100 ms a layer at 256^3). This kernel issues
// 9 m16n8k16 and 9 m16n8k8 a 16 voxels (675 of 1,728 MACs a voxel useful); its
// time goes to shared-memory traffic and instructions a position (the
// layout, ldmatrix, the epilogue's row buffer), not to MACs
// (tools/k1r_variants.py).
//
// Plain C entry points (bound from Python with ctypes); the launch goes on
// the caller's stream, does not synchronise and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSmemLimit = 232448;  // shared memory one sm_90a block can use
constexpr int kMaxWarps = 4;

// How the input rows reach the layout: cp.async straight into it (Cin a
// multiple of 8), cp.async of whole groups of 8 positions (16 Cin bytes,
// 16-byte aligned) into the raw buffer and then laid out (W a multiple of
// 8), or element by element from device memory (rows or base not so
// aligned).
enum Mode { kDirect = 0, kRaw = 1, kElem = 2 };

// Tensor-core blocking for C output channels: the output rows a warp
// computes (d apart in y) and the m16 tiles along x of the widest tile.
template <int C>
struct Tc {
  static constexpr int MY = C <= 8 ? 2 : C <= 16 ? 3 : 4;
  static constexpr int MT = C <= 8 ? 4 : C <= 16 ? 2 : 1;
  static constexpr int NT = (C + 7) / 8;
};

__host__ __device__ inline int ceil16(int v) { return (v + 15) & ~15; }
__host__ __device__ inline int cgroups(int cin) { return (cin + 7) / 8; }
__host__ __device__ inline int pos_bytes(int cin) { return (cgroups(cin) | 1) * 16; }
__host__ __device__ inline int ksteps(int cin) { return (3 * cgroups(cin) + 1) / 2; }

struct Tile {
  int mz, my, mt;  // z rows (warps), y rows a warp, m16 tiles along x
};

// The shared memory of one block, in bytes (kernels/dilated_conv3d.py::
// lp_layout): 16 zero bytes (the zero group of A operands), the B
// fragments (9 tap rows x k16 steps x n8 tiles, 256 bytes each), the
// A-offset table (per k16 step and half of the lanes the byte offset of
// its group from a voxel's position, -1 for the zero group), bias, scale
// and offset, one mbarrier a warp (its raw rows' bulk copies); the staged rows ((mz + 2)(my + 2) slots of nsl positions of
// pb bytes); the raw buffer (a tile's rows as copied, when Cin is not a
// multiple of 8); the output rows (my a warp).
struct Layout {
  int frag, table, vec, mbar, rows, raw, obuf, total;
  int sx;        // positions between an x tap's windows: d, or NX when d > NX
  int nsl, pb;   // positions and bytes a position of a staged row
  int raw_slot;  // raw bytes a staged row (its spans' groups of 8 positions), 0 when Cin is a multiple of 8
  int obuf_row;  // bytes of one output row in the buffer
};

__host__ inline Layout layout_of(int cin, int C, int d, Tile t) {
  Layout L{};
  const int ks = ksteps(cin), nt = (C + 7) / 8, nx = 16 * t.mt;
  const int slots = (t.mz + 2) * (t.my + 2);
  L.frag = 16;
  L.table = L.frag + 9 * ks * nt * 256;
  L.vec = L.table + ceil16(8 * ks);
  L.mbar = L.vec + ceil16(12 * C);
  L.rows = L.mbar + 8 * kMaxWarps;
  L.sx = d < nx ? d : nx;
  L.nsl = nx + 2 * L.sx;
  L.pb = pos_bytes(cin);
  L.raw = L.rows + slots * L.nsl * L.pb;
  if (cin % 8 != 0) {
    const bool one = L.sx == d;  // one span of nx + 2d positions, else three of nx
    L.raw_slot = one ? 16 * cin * ((nx + 2 * d + 7) / 8 + 1) : 3 * 16 * cin * (nx / 8 + 1);
  }
  L.obuf = L.raw + slots * L.raw_slot;
  L.obuf_row = ceil16(2 * nx * C) + 32;  // a row, or two halves of ceil16(nx C) + 16 (C = 5: 672 bytes)
  L.total = L.obuf + t.mz * t.my * L.obuf_row;
  return L;
}

// The tile a launch of cin -> C at dilation d takes: the widest that fits
// (4 warps, the width's rows and m16 tiles), narrowed first along x (one
// m16 tile), then in z (2 warps, 1), then to one row a warp. False if even
// the narrowest does not fit.
__host__ inline bool choose_tile(int cin, int C, int d, Tile* out) {
  const int my = C <= 8 ? 2 : C <= 16 ? 3 : 4, mt0 = C <= 8 ? 4 : C <= 16 ? 2 : 1;
  const int mzs[3] = {4, 2, 1};
  for (int i = 0; i < 3; ++i) {
    for (int mt = mt0;; mt = 1) {
      const Tile t{mzs[i], my, mt};
      if (layout_of(cin, C, d, t).total <= kSmemLimit) {
        *out = t;
        return true;
      }
      if (mt == 1) break;
    }
  }
  *out = Tile{1, 1, 1};
  return layout_of(cin, C, d, *out).total <= kSmemLimit;
}

// The first row of row group g (groups of m rows d apart) and the number
// of row groups over n rows, as conv_tile.cuh's.
__host__ __device__ inline int row_groups(int n, int d, int m) {
  const int rest = n % (m * d);
  return n / (m * d) * d + (rest < d ? rest : d);
}
__host__ __device__ inline int group_row(int g, int d, int m) { return g / d * (m * d) + g % d; }

struct Geom {
  int B, D, H, W, cin, d, fuse, mode;
  int mz, my, mt, zgroups, ygroups, xchunks;
  int tiles;
  Layout L;
};

__device__ __forceinline__ uint16_t bf16_bits(float v) { return __bfloat16_as_ushort(__float2bfloat16_rn(v)); }
__device__ __forceinline__ uint32_t pack_bits(uint16_t lo, uint16_t hi) { return (uint32_t)lo | ((uint32_t)hi << 16); }
__device__ __forceinline__ uint16_t weight_bits(const __nv_bfloat16* p) { return __bfloat16_as_ushort(*p); }
__device__ __forceinline__ uint16_t weight_bits(const int8_t* p) { return bf16_bits((float)*p); }  // exact

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// Four 8 x 8 bf16 matrices from shared memory (this lane's row address for
// matrix lane / 8, row lane % 8): the A operand of one m16n8k16.
__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

// Two 8 x 8 bf16 matrices (rows from lanes 0-15): the A operand of one
// m16n8k8, whose B operand is one register.
__device__ __forceinline__ void ldsm_x2(uint32_t (&a)[2], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(a[0]), "=r"(a[1])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void mma1688(float (&c)[4], const uint32_t (&a)[2], uint32_t b) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(b));
}

// 16 bytes to shared memory, of which the first src_bytes come from src
// and the rest are zero (src_bytes 0: nothing is read).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// Wait until at most the N newest commit groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// One position of a staged row: its channels (src, null for a position
// outside the volume) as bf16 in groups of 8, zero past cin.
__device__ __forceinline__ void lay_position(unsigned char* dst, const uint16_t* src, int cin) {
  for (int grp = 0; grp < cgroups(cin); ++grp) {
    uint32_t w4[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c0 = grp * 8 + 2 * e;
      const uint16_t lo = src != nullptr && c0 < cin ? src[c0] : 0;
      const uint16_t hi = src != nullptr && c0 + 1 < cin ? src[c0 + 1] : 0;
      w4[e] = pack_bits(lo, hi);
    }
    *reinterpret_cast<uint4*>(dst + grp * 16) = make_uint4(w4[0], w4[1], w4[2], w4[3]);
  }
}

// The mbarrier at shared address bar: initialised for one arrival; an
// arrival that expects tx bytes of bulk copies; a poll of the phase of
// parity ph. The bulk copy of bytes (a multiple of 16, both addresses
// 16-byte aligned) from src to shared address dst, counted on bar.
__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned tx) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(bar), "r"(tx)
               : "memory");
}
__device__ __forceinline__ bool mbar_done(unsigned bar, unsigned ph) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(ph)
      : "memory");
  return ok != 0;
}
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src, unsigned bytes, unsigned bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}
// Orders this thread's generic accesses to shared memory before later bulk copies into it.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// The mmas of one staged row (tap plane tz, row r of the tile's row
// group; base: this lane's ldmatrix row, its voxel's position) into every
// output row j of the warp that it reaches (tap row ty = r - j): KS k16
// steps from step s0 of ks, the A operands at base + off[s] (the zero
// group where off < 0), all loaded before the mmas that use them.
template <int C, int MT, int KS>
__device__ __forceinline__ void row_mmas(float (&acc)[Tc<C>::MY][MT][Tc<C>::NT][4], unsigned base,
                                         const int (&off)[KS], unsigned zero, int s0, int ks, const uint2* frag,
                                         int tz, int r, int mye, int pb, int lane) {
  constexpr int NT = Tc<C>::NT, MY = Tc<C>::MY;
  uint32_t a[KS][MT][4];
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) ldsm_x4(a[s][mt], off[s] >= 0 ? base + 16 * mt * pb + off[s] : zero);
#pragma unroll
  for (int j = 0; j < MY; ++j) {
    const int ty = r - j;
    if (j >= mye || ty < 0 || ty > 2) continue;
    const uint2* fb = frag + ((tz * 3 + ty) * ks + s0) * NT * 32 + lane;
#pragma unroll
    for (int s = 0; s < KS; ++s)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint2 b = fb[(s * NT + nt) * 32];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma16816(acc[j][mt][nt], a[s][mt], b);
      }
  }
}

// The mmas of one staged row for Cin > 8 (ks k16 steps a tap row) into
// every output row j of the warp that it reaches: each tap's steps (per of
// them: cg / 2 when the channel groups cg are even, else the whole tap row)
// summed by the tensor cores from zero, then added to acc[j] in fp32 in
// the plain version's order of taps. A chain of 108 tensor-core steps into
// one accumulator (Cin 64) would carry each step's truncation of its sum
// into the result; this keeps the sum of each tap's channels, as the plain
// version has it, apart.
template <int C, int MT>
__device__ __forceinline__ void tap_mmas(float (&acc)[Tc<C>::MY][MT][Tc<C>::NT][4], unsigned base, const int* table,
                                         unsigned zero, int ks, int per, const uint2* frag, int tz, int r, int mye,
                                         int pb, int lane) {
  constexpr int NT = Tc<C>::NT, MY = Tc<C>::MY;
  const int half = lane >> 4;
#pragma unroll
  for (int j = 0; j < MY; ++j) {
    const int ty = r - j;
    if (j >= mye || ty < 0 || ty > 2) continue;
    const uint2* fb = frag + (tz * 3 + ty) * ks * NT * 32 + lane;
    for (int s0 = 0; s0 < ks; s0 += per) {
      float t[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) t[mt][nt][e] = 0.0f;
      for (int s = s0; s < s0 + per && s < ks; ++s) {
        const int off = table[2 * s + half];
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) ldsm_x4(a[mt], off >= 0 ? base + 16 * mt * pb + off : zero);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint2 b = fb[(s * NT + nt) * 32];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma16816(t[mt][nt], a[mt], b);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][mt][nt][e] += t[mt][nt][e];
    }
  }
}

// The epilogue of one output row segment of nv voxels whose MTS m16 tiles
// are in a (this lane's accumulator fragments): relu((acc + bias) * scale +
// offset) in fp32 (unfused: scale 1, offset 0, clamped at -inf), one round
// to bf16, the segment laid out contiguously in its buffer ob at the
// alignment of its place in device memory (dst), then written there as
// 16-byte stores (the partial granules at its ends byte by byte).
template <int C, int MTS, int NT>
__device__ __forceinline__ void store_row(const float (&a)[MTS][NT][4], __nv_bfloat16* dst, int nv,
                                          unsigned char* ob, const float (&eb)[NT][2], const float (&es)[NT][2],
                                          const float (&eo)[NT][2], float clamp_lo, int lane) {
  const int g8 = lane >> 2, q = lane & 3;
  const uintptr_t lo = reinterpret_cast<uintptr_t>(dst), hi = lo + (uintptr_t)(2 * nv * C), a0 = lo & ~(uintptr_t)15;
  uint16_t* o16 = reinterpret_cast<uint16_t*>(ob + (lo & 15));
#pragma unroll
  for (int mt = 0; mt < MTS; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int v = 16 * mt + g8 + 8 * (e >> 1), n = nt * 8 + 2 * q + (e & 1);
        if (v >= nv || n >= C) continue;
        o16[v * C + n] = bf16_bits(fmaxf((a[mt][nt][e] + eb[nt][e & 1]) * es[nt][e & 1] + eo[nt][e & 1], clamp_lo));
      }
  __syncwarp();
  const int ng = (int)((hi - a0 + 15) >> 4);
  for (int i = lane; i < ng; i += 32) {
    const uintptr_t ga = a0 + 16 * (uintptr_t)i;
    const unsigned char* src = ob + 16 * i;
    if (ga >= lo && ga + 16 <= hi) {
      *reinterpret_cast<uint4*>(ga) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (uintptr_t p = ga < lo ? lo : ga; p < ga + 16 && p < hi; ++p)
        *reinterpret_cast<unsigned char*>(p) = src[p - ga];
    }
  }
}

// At least 4 blocks an SM (128 registers a thread) at C <= 8, the main
// path's width; 3 (168 registers) at the wider widths, whose 48
// accumulators and per-tap sums would spill at 128.
template <int C, int MT, typename WT>
__global__ void __launch_bounds__(32 * kMaxWarps, C <= 8 ? 4 : 3)
k1r_kernel(const uint16_t* __restrict__ x, const WT* __restrict__ w, const float* __restrict__ bias,
           const float* __restrict__ scale, const float* __restrict__ offset, __nv_bfloat16* __restrict__ out,
           const Geom g) {
  constexpr int NT = Tc<C>::NT, MY = Tc<C>::MY, NX = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout& L = g.L;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, g8 = lane >> 2, q = lane & 3;
  const int cin = g.cin, d = g.d, cg = cgroups(cin), ks = ksteps(cin), pb = L.pb;

  // once per block: the zero group; the B fragments, lane-major words
  // {B[2q][g], B[2q+1][g]}, {B[2q+8][g], B[2q+9][g]} (row k of tap row
  // (tz, ty) is group k / 8, i.e. x tap gi / cg and channel (gi % cg) 8 +
  // k % 8, column n the output channel); the A-offset table; bias, scale
  // and offset (1 and 0 unfused)
  if (tid < 4) reinterpret_cast<uint32_t*>(smem)[tid] = 0;
  if ((tid & 31) == 0) {
    mbar_init((unsigned)__cvta_generic_to_shared(smem + L.mbar + 8 * (tid >> 5)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_proxy_async();
  }
  {
    uint32_t* frag = reinterpret_cast<uint32_t*>(smem + L.frag);
    for (int i = tid; i < 9 * ks * NT * 64; i += nthr) {
      const int f = i >> 6, word = i & 63, ln = word >> 1, reg = word & 1;
      const int tr = f / (ks * NT), rest = f - tr * ks * NT, st = rest / NT, nt = rest - st * NT;
      const int n = nt * 8 + (ln >> 2);
      uint16_t h2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = st * 16 + 2 * (ln & 3) + e + 8 * reg;
        const int gi = k >> 3, tx = gi / cg, ci = (gi - tx * cg) * 8 + (k & 7);
        h2[e] = tx < 3 && ci < cin && n < C ? weight_bits(w + ((int64_t)(tr * 3 + tx) * cin + ci) * C + n) : 0;
      }
      frag[i] = pack_bits(h2[0], h2[1]);
    }
    int* table = reinterpret_cast<int*>(smem + L.table);
    for (int i = tid; i < 2 * ks; i += nthr) {
      const int tx = i / cg;
      table[i] = i < 3 * cg ? tx * L.sx * pb + (i - tx * cg) * 16 : -1;
    }
    float* vec = reinterpret_cast<float*>(smem + L.vec);
    for (int i = tid; i < C; i += nthr) {
      vec[i] = bias[i];
      vec[C + i] = g.fuse ? scale[i] : 1.0f;
      vec[2 * C + i] = g.fuse ? offset[i] : 0.0f;
    }
  }
  __syncthreads();

  // this lane's channels' epilogue parameters (zero past C)
  float eb[NT][2], es[NT][2], eo[NT][2];
  {
    const float* vec = reinterpret_cast<const float*>(smem + L.vec);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
        const int n = nt * 8 + 2 * q + k2;
        eb[nt][k2] = n < C ? vec[n] : 0.0f;
        es[nt][k2] = n < C ? vec[C + n] : 0.0f;
        eo[nt][k2] = n < C ? vec[2 * C + n] : 0.0f;
      }
  }
  const uint2* frag = reinterpret_cast<const uint2*>(smem + L.frag);
  const int* table = reinterpret_cast<const int*>(smem + L.table);

  unsigned char* rows = smem + L.rows;
  const unsigned zero = (unsigned)__cvta_generic_to_shared(smem);
  const int vo = ((lane >> 3) & 1) * 8 + (lane & 7);  // this lane's ldmatrix row: a voxel of an m16 tile
  const int half = lane >> 4;                         // and its k half
  const int sy = g.my + 2, slots = (g.mz + 2) * sy, slot_bytes = L.nsl * pb;
  const bool one_span = L.sx == d;
  const int nspan = one_span ? 1 : 3, nsp = one_span ? NX + 2 * d : NX;  // spans a row, positions a span
  const int span_bytes = one_span ? L.raw_slot : L.raw_slot / 3;                // raw bytes a span
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);
  unsigned char* raw_buf = smem + L.raw;
  unsigned char* obuf = smem + L.obuf;

  // a tile: batch member, first z and y rows of its row groups, first x,
  // the z and y rows of its groups inside the volume, its voxels along x
  struct Tl {
    int b, z0, y0, x0, mze, mye, nv;
  };
  auto decode = [&](int t) {
    Tl T;
    const int xc = t % g.xchunks;
    t /= g.xchunks;
    const int yg = t % g.ygroups;
    t /= g.ygroups;
    const int zg = t % g.zgroups;
    T.b = t / g.zgroups;
    T.z0 = group_row(zg, d, g.mz), T.y0 = group_row(yg, d, g.my), T.x0 = xc * NX;
    T.mze = min(g.mz, (g.D - 1 - T.z0) / d + 1), T.mye = min(g.my, (g.H - 1 - T.y0) / d + 1);
    T.nv = min(NX, g.W - T.x0);
    return T;
  };
  // staged row s of tile T (plane p = s / sy, row r = s % sy): its first
  // element in x, or -1 when no output row of the tile reads it or it lies
  // outside the volume
  auto row_of = [&](const Tl& T, int s) -> int64_t {
    const int p = s / sy, r = s - p * sy;
    if (p >= T.mze + 2 || r >= T.mye + 2) return -1;
    const int z = T.z0 + (p - 1) * d, y = T.y0 + (r - 1) * d;
    if (z < 0 || z >= g.D || y < 0 || y >= g.H) return -1;
    return (((int64_t)T.b * g.D + z) * g.H + y) * g.W * cin;
  };
  // the x of span sp's first position
  auto span_x = [&](const Tl& T, int sp) { return one_span ? T.x0 - d : T.x0 + (sp - 1) * d; };
  // Warp w copies and lays out slots w, w + mz, ... of every tile, so a
  // __syncwarp, not a block barrier, orders its copies before its layout;
  // lane l holds the first element of the warp's slot w + l mz (-1 past the
  // slots or where row_of has none).
  auto lane_row = [&](const Tl& T) -> int64_t {
    const int s = warp + lane * g.mz;
    return s < slots ? row_of(T, s) : -1;
  };
  // the groups of 8 positions (x from 8 gs to 8 ge) that cover span sp's
  // positions inside the volume; ge <= gs when there are none
  auto span_groups = [&](const Tl& T, int sp, int& gs, int& ge) {
    const int xa = span_x(T, sp);
    gs = max(xa, 0) >> 3, ge = (min(xa + nsp, g.W) + 7) >> 3;
  };
  // kRaw: each lane copies its slot's rows, whole groups of 8 positions (16
  // Cin bytes, 16-byte aligned since W is a multiple of 8), into the raw
  // buffer by bulk copies, one a span, counted on the warp's mbarrier, which
  // lane 0 arms with the warp's bytes first (rows outside the volume copy
  // nothing; with none the phase completes on the arrival alone)
  const unsigned bar = (unsigned)__cvta_generic_to_shared(smem + L.mbar + 8 * warp);
  auto copy_raw = [&](const Tl& T, int64_t ro) {
    unsigned bytes = 0;
    if (ro >= 0)
      for (int sp = 0; sp < nspan; ++sp) {
        int gs, ge;
        span_groups(T, sp, gs, ge);
        bytes += ge > gs ? 16 * cin * (ge - gs) : 0;
      }
    const unsigned total = __reduce_add_sync(0xffffffffu, bytes);
    if (lane == 0) {
      fence_proxy_async();
      mbar_expect(bar, total);
    }
    __syncwarp();
    if (ro >= 0) {
      const int s = warp + lane * g.mz;
      for (int sp = 0; sp < nspan; ++sp) {
        int gs, ge;
        span_groups(T, sp, gs, ge);
        if (ge > gs)
          bulk_copy((unsigned)__cvta_generic_to_shared(raw_buf + s * L.raw_slot + sp * span_bytes),
                    xb + 2 * ro + 16 * cin * gs, 16 * cin * (ge - gs), bar);
      }
    }
  };
  const int nws = (slots - warp + g.mz - 1) / g.mz;  // the warp's slots
  int tile = blockIdx.x;
  Tl T{};
  int64_t ro_l = -1;
  if (tile < g.tiles) {
    T = decode(tile);
    ro_l = lane_row(T);
    if (g.mode == kRaw) copy_raw(T, ro_l);
  }
  unsigned phase = 0;  // parity of the warp's mbarrier phase this tile's copies complete
  for (; tile < g.tiles; tile += gridDim.x, phase ^= 1) {
    const int b = T.b, z0 = T.z0, y0 = T.y0, x0 = T.x0, mze = T.mze, mye = T.mye, nv = T.nv;

    // ---- stage the tile's input rows ----
    if (g.mode == kRaw) {
      while (!mbar_done(bar, phase)) {  // this tile's copies, issued during the previous tile's mmas
      }
    } else if (g.mode == kDirect) {
      // straight into the layout, zero-filled outside the volume
      for (int m = 0; m < nws; ++m) {
        const int64_t ro = __shfl_sync(0xffffffffu, ro_l, m);
        const int s = warp + m * g.mz;
        if (ro < 0) continue;
        for (int sp = 0; sp < nspan; ++sp) {
          const int xa = span_x(T, sp);
          unsigned char* dst = rows + s * slot_bytes + (one_span ? 0 : sp * NX) * pb;
          for (int i = lane; i < nsp * cg; i += 32) {
            const int kk = i / cg, grp = i - kk * cg, xx = xa + kk;
            const bool in = xx >= 0 && xx < g.W;
            cp_async16_zfill(dst + kk * pb + 16 * grp, in ? xb + 2 * (ro + (int64_t)xx * cin) + 16 * grp : xb,
                             in ? 16 : 0);
          }
        }
      }
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncwarp();
    if (g.mode == kRaw && (cin == 5 || cin == 1)) {
      // each position's channels in groups of 8 (16 bytes), zero outside the
      // volume: a lane lays out a pair of positions (x even, x + 1) from the
      // 2 CIN words that hold them in the raw copy (the pairs of all the
      // warp's slots in turn), so a warp's loads of the raw rows and its
      // 16-byte stores fall in distinct banks
      const unsigned valid = __ballot_sync(0xffffffffu, ro_l >= 0);  // the warp's slots that are staged
      for (int sp = 0; sp < nspan; ++sp) {
        const int xa = span_x(T, sp), xp = xa >> 1;  // the first pair holds x = 2 xp
        int gs, ge;
        span_groups(T, sp, gs, ge);
        const int np = ((xa + nsp + 1) >> 1) - xp;          // pairs that cover the span
        const unsigned magic = ((1u << 20) + np - 1) / np;  // i / np as (i magic) >> 20 for i < 8192
        for (int i = lane; i < nws * np; i += 32) {
          const int m = (int)((i * magic) >> 20), xx = 2 * (xp + i - m * np);
          if (!((valid >> m) & 1)) continue;
          const int s = warp + m * g.mz;
          unsigned char* dst = rows + s * slot_bytes + (one_span ? 0 : sp * NX) * pb;
          uint4 v0 = make_uint4(0, 0, 0, 0), v1 = v0;
          if (xx >= 0 && xx < g.W) {  // W even: both positions inside or both outside
            const uint32_t* w = reinterpret_cast<const uint32_t*>(raw_buf + s * L.raw_slot + sp * span_bytes) +
                                cin * ((xx - 8 * gs) >> 1);
            if (cin == 5) {
              const uint32_t w0 = w[0], w1 = w[1], w2 = w[2], w3 = w[3], w4 = w[4];
              v0 = make_uint4(w0, w1, w2 & 0xffffu, 0u);
              v1 = make_uint4(__byte_perm(w2, w3, 0x5432), __byte_perm(w3, w4, 0x5432), w4 >> 16, 0u);
            } else {
              const uint32_t w0 = w[0];
              v0.x = w0 & 0xffffu, v1.x = w0 >> 16;
            }
          }
          const int k = xx - xa;
          if (k >= 0) *reinterpret_cast<uint4*>(dst + k * pb) = v0;
          if (k + 1 < nsp) *reinterpret_cast<uint4*>(dst + (k + 1) * pb) = v1;
        }
      }
    } else if (g.mode != kDirect) {
      // each position's channels in groups of 8 (16 bytes), zero outside the
      // volume; the warp's own slots, a lane a position
      for (int m = 0; m < nws; ++m) {
        const int64_t ro = __shfl_sync(0xffffffffu, ro_l, m);
        const int s = warp + m * g.mz;
        if (ro < 0) continue;
        for (int sp = 0; sp < nspan; ++sp) {
          const int xa = span_x(T, sp);
          int gs, ge;
          span_groups(T, sp, gs, ge);
          const unsigned char* raw = raw_buf + s * L.raw_slot + sp * span_bytes;
          unsigned char* dst = rows + s * slot_bytes + (one_span ? 0 : sp * NX) * pb;
          for (int kk = lane; kk < nsp; kk += 32) {
            const int xx = xa + kk;
            const uint16_t* src = nullptr;
            if (xx >= 0 && xx < g.W)
              src = g.mode == kRaw ? reinterpret_cast<const uint16_t*>(raw + 2 * cin * (xx - 8 * gs))
                                   : x + ro + (int64_t)xx * cin;
            lay_position(dst + kk * pb, src, cin);
          }
        }
      }
    }
    // the next tile; in kRaw its copies go out now and land during this
    // tile's mmas (into the warp's own slots, whose layout reads are done at
    // the __syncwarp)
    Tl Tn{};
    int64_t ro_n = -1;
    if (tile + gridDim.x < g.tiles) {
      Tn = decode(tile + gridDim.x);
      ro_n = lane_row(Tn);
      __syncwarp();
      if (g.mode == kRaw) copy_raw(Tn, ro_n);
    }
    __syncthreads();

    const float clamp_lo = g.fuse ? 0.0f : __int_as_float(0xff800000u);  // -inf unfused
    // output row (z, y) of this batch member from voxel xs on
    auto out_row = [&](int z, int y, int xs) { return out + ((((int64_t)b * g.D + z) * g.H + y) * g.W + xs) * C; };
    bool paired = false;
    if constexpr (NT == 1 && MT == 4) {
      if (cg == 1 && g.mz == 4 && g.my == 2) {
        // C <= 8 from cin <= 8 (every gwm_light layer; the tile is always 4
        // warps x 2 y rows x 64 voxels): warp w computes z rows zp and zp + 1
        // (zp = 2 (w / 2)) and both y rows over the 32 voxels at xh = 32 (w %
        // 2), so each staged row it reads feeds up to 2 z x 2 y output rows
        // (4 planes of 4 rows for 4 output rows, against 3 planes for 2 with
        // a z row a warp). The B fragments are in registers for the tile's
        // mmas and the tap rows unrolled, so that each picks its own; per staged row the x taps -1
        // and 0 are one m16n8k16 and tap +1 one m16n8k8 (the zero group is
        // never read).
        paired = true;
        const int zp = 2 * (warp >> 1), xh = 32 * (warp & 1);
        if (zp < mze && xh < nv) {
          float acc[2][2][2][1][4];  // [z row][y row][m16 tile]
#pragma unroll
          for (int iz = 0; iz < 2; ++iz)
#pragma unroll
            for (int jy = 0; jy < 2; ++jy)
#pragma unroll
              for (int ml = 0; ml < 2; ++ml)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[iz][jy][ml][0][e] = 0.0f;
          const int off0 = table[half], off1 = table[2];
          // this lane's B fragments of the 9 tap rows: the first k16 step's
          // and the second's first half (tap +1)
          uint2 bw[9];
          uint32_t bw1[9];
#pragma unroll
          for (int tr = 0; tr < 9; ++tr) {
            bw[tr] = frag[(tr * 2) * 32 + lane];
            bw1[tr] = frag[(tr * 2 + 1) * 32 + lane].x;
          }
#pragma unroll
          for (int pr = 0; pr < 4; ++pr) {
            const int p = zp + pr, z = z0 + (p - 1) * d;
            if (p >= mze + 2 || z < 0 || z >= g.D) continue;
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int y = y0 + (r - 1) * d;
              if (r >= mye + 2 || y < 0 || y >= g.H) continue;
              const unsigned base =
                  (unsigned)__cvta_generic_to_shared(rows + (p * sy + r) * slot_bytes) + (xh + vo) * pb;
              uint32_t a0[2][4], a1[2][2];
#pragma unroll
              for (int ml = 0; ml < 2; ++ml) {
                ldsm_x4(a0[ml], base + 16 * ml * pb + off0);
                ldsm_x2(a1[ml], base + 16 * ml * pb + off1);
              }
#pragma unroll
              for (int iz = 0; iz < 2; ++iz) {
                const int tz = pr - iz;
                if (tz < 0 || tz > 2 || zp + iz >= mze) continue;
#pragma unroll
                for (int jy = 0; jy < 2; ++jy) {
                  const int ty = r - jy;
                  if (ty < 0 || ty > 2 || jy >= mye) continue;
#pragma unroll
                  for (int ml = 0; ml < 2; ++ml) {
                    mma16816(acc[iz][jy][ml][0], a0[ml], bw[tz * 3 + ty]);
                    mma1688(acc[iz][jy][ml][0], a1[ml], bw1[tz * 3 + ty]);
                  }
                }
              }
            }
          }
#pragma unroll
          for (int iz = 0; iz < 2; ++iz)
#pragma unroll
            for (int jy = 0; jy < 2; ++jy)
              if (zp + iz < mze && jy < mye)
                store_row<C, 2, NT>(acc[iz][jy], out_row(z0 + (zp + iz) * d, y0 + jy * d, x0 + xh), min(32, nv - xh),
                                    obuf + warp * g.my * L.obuf_row + (2 * iz + jy) * (L.obuf_row / 2), eb, es, eo,
                                    clamp_lo, lane);
        }
      }
    }
    // ---- otherwise warp w computes the tile's z row w: MY output rows x NX
    // voxels ----
    if (!paired && warp < mze) {
      float acc[MY][MT][NT][4];
#pragma unroll
      for (int j = 0; j < MY; ++j)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][mt][nt][e] = 0.0f;
      // the A-offset table in registers when a tap row is two k16 steps
      const int off2[2] = {table[half], table[2 + half]};
      for (int tz = 0; tz < 3; ++tz) {
        const int p = warp + tz, z = z0 + (p - 1) * d;
        if (z < 0 || z >= g.D) continue;
        for (int r = 0; r < mye + 2; ++r) {
          const int y = y0 + (r - 1) * d;
          if (y < 0 || y >= g.H) continue;
          const unsigned base = (unsigned)__cvta_generic_to_shared(rows + (p * sy + r) * slot_bytes) + vo * pb;
          if (ks == 2)
            row_mmas<C, MT, 2>(acc, base, off2, zero, 0, 2, frag, tz, r, mye, pb, lane);
          else
            tap_mmas<C, MT>(acc, base, table, zero, ks, cg % 2 == 0 ? cg / 2 : ks, frag, tz, r, mye, pb, lane);
        }
      }
#pragma unroll
      for (int j = 0; j < MY; ++j)
        if (j < mye)
          store_row<C, MT, NT>(acc[j], out_row(z0 + warp * d, y0 + j * d, x0), nv,
                               obuf + (warp * g.my + j) * L.obuf_row, eb, es, eo, clamp_lo, lane);
    }
    __syncthreads();  // the next tile's layout overwrites the rows
    T = Tn, ro_l = ro_n;
  }
}

template <int C, int MT, typename WT>
cudaError_t prepare(int smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(k1r_kernel<C, MT, WT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return cudaSuccess;
}

template <int C, int MT, typename WT>
int occupancy_of(int threads, int smem) {
  int blocks = 0;
  if (prepare<C, MT, WT>(smem) != cudaSuccess) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k1r_kernel<C, MT, WT>, threads, smem) != cudaSuccess)
    return -1;
  return blocks;
}

template <int C, int MT, typename WT>
cudaError_t launch_t(const void* x, const void* w, const float* bias, const float* scale, const float* offset,
                     void* out, Geom g, cudaStream_t stream) {
  const int threads = 32 * g.mz, smem = g.L.total;
  const int per_sm = occupancy_of<C, MT, WT>(threads, smem);
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int grid = min(g.tiles, sms * per_sm);
  k1r_kernel<C, MT, WT><<<grid, threads, smem, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const WT*>(w), bias, scale, offset,
      static_cast<__nv_bfloat16*>(out), g);
  return cudaGetLastError();
}

// The kernel instantiation of (C, tile, weights): f(MT) with MT the
// tile's m16 tiles (the width's widest, or 1).
template <typename WT, typename F>
auto with_kernel(int C, int mt, F f) {
  switch (C) {
    case 5: return mt == 4 ? f.template operator()<5, 4, WT>() : f.template operator()<5, 1, WT>();
    case 10: return mt == 2 ? f.template operator()<10, 2, WT>() : f.template operator()<10, 1, WT>();
    case 18: return f.template operator()<18, 1, WT>();
    default: return f.template operator()<21, 1, WT>();
  }
}

bool supports(int cout) { return cout == 5 || cout == 10 || cout == 18 || cout == 21; }

bool geometry(int B, int D, int H, int W, int cin, int cout, int dilation, int fuse, const void* x, Geom* g) {
  Tile t;
  if (!supports(cout) || cin < 1 || dilation < 1 || !choose_tile(cin, cout, dilation, &t)) return false;
  g->B = B, g->D = D, g->H = H, g->W = W, g->cin = cin, g->d = dilation, g->fuse = fuse;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  g->mode = cin % 8 == 0 ? (aligned ? kDirect : kElem) : (aligned && W % 8 == 0 ? kRaw : kElem);
  g->mz = t.mz, g->my = t.my, g->mt = t.mt;
  g->zgroups = row_groups(D, dilation, t.mz);
  g->ygroups = row_groups(H, dilation, t.my);
  g->xchunks = (W + 16 * t.mt - 1) / (16 * t.mt);
  const long long tiles = (long long)B * g->zgroups * g->ygroups * g->xchunks;
  if (tiles > 0x7fffffff) return false;
  g->tiles = (int)tiles;
  g->L = layout_of(cin, cout, dilation, t);
  return true;
}

struct Launch {
  const void *x, *w;
  const float *bias, *scale, *offset;
  void* out;
  Geom g;
  cudaStream_t s;
  template <int C, int MT, typename WT>
  cudaError_t operator()() const {
    return launch_t<C, MT, WT>(x, w, bias, scale, offset, out, g, s);
  }
};

struct Occupancy {
  Geom g;
  template <int C, int MT, typename WT>
  int operator()() const {
    return occupancy_of<C, MT, WT>(32 * g.mz, g.L.total);
  }
};

struct Attributes {
  template <int C, int MT, typename WT>
  cudaFuncAttributes operator()() const {
    cudaFuncAttributes a{};
    if (cudaFuncGetAttributes(&a, k1r_kernel<C, MT, WT>) != cudaSuccess) a.numRegs = -1;
    return a;
  }
};

}  // namespace

extern "C" {

// Output channel counts this library is instantiated for: MeshNet's hidden
// widths, as K1's.
int repro_dilated_conv3d_lp_supports(int cout) { return supports(cout); }

// The tile of cin -> cout at dilation d: tile[0..2] = warps (z rows), y rows
// a warp, m16 tiles along x. Returns 0, or -1 when no tile fits.
int repro_dilated_conv3d_lp_tile(int cin, int cout, int dilation, int* tile) {
  Tile t;
  const bool ok = choose_tile(cin, cout, dilation, &t);
  tile[0] = t.mz, tile[1] = t.my, tile[2] = t.mt;
  return ok ? 0 : -1;
}

// Bytes of shared memory one block of cin -> cout at dilation d allocates
// (the narrowest tile's when none fits).
long long repro_dilated_conv3d_lp_smem_bytes(int cin, int cout, int dilation) {
  Tile t;
  choose_tile(cin, cout, dilation, &t);
  return layout_of(cin, cout, dilation, t).total;
}

// Blocks of cin -> cout at dilation d one SM holds at once (the runtime's
// occupancy calculator), int8 weights when w_int8 != 0; -1 if it cannot
// launch.
int repro_dilated_conv3d_lp_blocks_per_sm(int cin, int cout, int dilation, int w_int8) {
  Geom g;
  if (!geometry(1, 1, 1, 16, cin, cout, dilation, 1, nullptr, &g)) return -1;
  return w_int8 ? with_kernel<int8_t>(cout, g.mt, Occupancy{g}) : with_kernel<__nv_bfloat16>(cout, g.mt, Occupancy{g});
}

// Registers a thread and local (spill) bytes a thread of the kernel that
// cin -> cout at dilation d launches: out[0], out[1]. Returns 0, or -1.
int repro_dilated_conv3d_lp_registers(int cin, int cout, int dilation, int w_int8, int* out) {
  Geom g;
  if (!geometry(1, 1, 1, 16, cin, cout, dilation, 1, nullptr, &g)) return -1;
  const cudaFuncAttributes a = w_int8 ? with_kernel<int8_t>(cout, g.mt, Attributes{})
                                      : with_kernel<__nv_bfloat16>(cout, g.mt, Attributes{});
  out[0] = a.numRegs, out[1] = (int)a.localSizeBytes;
  return a.numRegs < 0 ? -1 : 0;
}

// x: (B, D, H, W, cin) bf16 contiguous; w: (3, 3, 3, cin, cout), int8 when
// w_int8 != 0, else bf16; bias, scale, offset: (cout,) fp32 (scale/offset
// read only when fuse != 0); out: (B, D, H, W, cout) bf16. Returns a
// cudaError_t (0 on success).
int repro_dilated_conv3d_lp(const void* x, const void* w, int w_int8, const float* bias, const float* scale,
                            const float* offset, void* out, int B, int D, int H, int W, int cin, int cout,
                            int dilation, int fuse, void* stream) {
  Geom g;
  if (!geometry(B, D, H, W, cin, cout, dilation, fuse, x, &g)) return (int)cudaErrorInvalidValue;
  if (g.tiles == 0) return (int)cudaSuccess;
  const Launch l{x, w, bias, scale, offset, out, g, static_cast<cudaStream_t>(stream)};
  return (int)(w_int8 ? with_kernel<int8_t>(cout, g.mt, l) : with_kernel<__nv_bfloat16>(cout, g.mt, l));
}

const char* repro_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
