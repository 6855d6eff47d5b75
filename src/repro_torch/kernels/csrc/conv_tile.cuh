// The conv tile core that K1 (dilated_conv3d.cu) and K2 (megakernel.cu)
// share: one warp computes M output rows d apart in y (same z; M = 2 at
// C <= 10) over a chunk of up to 32 R voxels along x, each lane R voxels
// of each row x all C output channels in registers, over the 3x3x3
// dilated taps; fp32 in, fp32 accumulation.
//
// Register blocking. Lane l computes the voxels x0 + l + 32 k, k < R
// (R = 8 at C = 5, 4 at C = 10, 18 and 21), of each of its M rows, so the
// 32 lanes of a warp read 32 neighbouring input positions at every step.
// For each tap row (tz, ty) the warp walks the M + 2 input rows y0 + j d
// (j = -1 .. M) of its group; input row j feeds output row m = j - ty for
// each ty in {-1, 0, 1} with 0 <= m < M. For each x tap and input channel
// a lane loads its R inputs once (scalar loads; the channel stride of the
// staged activations is odd, so the 32 addresses fall in 32 banks) and,
// for each output row the input feeds, the tap's C weights as float4
// loads (row stride CP = C rounded up to 4; every lane reads the same
// words, a broadcast), then does R * C FFMAs per row.
// Shared-memory load instructions per FFMA, for one input row feeding
// r_used output rows: (R + r_used CP / 4) / (r_used R C). Over a group the
// M + 2 input rows feed 3 M (row, tap-row) pairs:
//   C = 5  (R 8, M 2): (4 x 8 + 6 x 2) / (6 x 40)  = 44 / 240 (0.18)
//   C = 10 (R 4, M 2): (4 x 4 + 6 x 3) / (6 x 40)  = 34 / 240 (0.14)
//   C = 18 (R 4, M 1): (3 x 4 + 3 x 5) / (3 x 72)  = 27 / 216 (0.13)
//   C = 21 (R 4, M 1): (3 x 4 + 3 x 6) / (3 x 84)  = 30 / 252 (0.12)
// Each input value loaded is used up to 3 C times (3 M / (M + 2) C on
// average: 7.5 at C = 5) and each weight R times.
//
// Summation order, per output voxel, exactly the first K1's and K5's:
// taps tz, ty, tx from -1 to 1, input channels innermost, fmaf into
// acc[co]. The walk over j in increasing order gives each output row its
// tap rows in increasing ty. A tap outside the volume either is skipped (a
// whole input row outside it in z or y) or reads a zero that the copy
// filled in (x outside it): fmaf(0, w, acc) returns acc's value for
// finite w, so K5, which skips every tap outside the volume, stays equal
// to K1 value for value.
//
// Staging through asynchronous copies (stage_box). For each (tz, j) the
// warp copies one box of the input row: the chunk's t_x voxels plus the
// two side windows the x taps reach, t_x + 2 d positions when d < t_x (the
// windows overlap), 3 t_x when d >= t_x (three disjoint windows); all Cin
// channels of each position. A channels-last row is contiguous, so at an
// odd Cin the box is one contiguous span: 16-byte cp.async.cg copies (4
// floats), neighbouring lanes on neighbouring chunks, placed at the shift
// that keeps source and destination 16-byte aligned alike, 4-byte copies
// at the ragged ends, src-size 0 outside the volume (the zero fill is the
// 'same' padding, so the inner loop tests no bound). Three disjoint
// windows are three contiguous spans of 4-byte copies. At an even Cin the
// copy pads every position to Cin + 1 floats (4-byte copies). A warp keeps
// a double-buffered ring of two boxes, so the copy of the next box, the
// next item's first included, overlaps the FFMAs of this one (a third
// slot measured no faster on the H100). Each input value is copied from L2 once
// per (tz, j) box that holds it: 3 (M + 2) / M times a layer (6 at M = 2,
// 9 at M = 1), times (t_x + 2 d) / t_x for the side windows, not 27.
//
// Two compile-time switches build the ablations chip_smoke.py times to
// split a launch's time: CONV_TILE_NO_COPY drops every copy (the FFMAs read
// whatever the ring holds), CONV_TILE_NO_FMA drops every FFMA (the copies
// and the loop remain). Neither is set in the kernels the port runs.
//
// TMA would need every global stride to be a multiple of 16 bytes; a
// channels-last row is W * Cin * 4 bytes (280 at W = 14, Cin = 5), and one
// kernel takes every shape, so the copies are cp.async.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace conv_tile {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;  // boxes a warp keeps: the one it reads and the copy in flight

// Register blocking for C output channels.
template <int C>
struct Blocking {
  static constexpr int R = C <= 5 ? 8 : 4;    // voxels a lane computes along x, per row
  static constexpr int M = C <= 10 ? 2 : 1;   // output rows a warp computes, d apart in y
  static constexpr int CP = (C + 3) / 4 * 4;  // weight row stride (floats)
  static constexpr int X = 32 * R;            // x extent of one warp's chunk
};

__host__ __device__ inline int ceil4(int v) { return (v + 3) / 4 * 4; }

// Channel stride of staged activations: odd, so 32 lanes reading 32
// neighbouring positions hit 32 banks.
__host__ __device__ inline int odd_stride(int c) { return c | 1; }

// Floats one staged box takes in shared memory: its positions at the
// channel stride, rounded up to 4, and 4 more for the alignment shift.
__host__ __device__ inline int slot_floats(int width, int cs) { return ceil4(width * cs) + 4; }

// Groups of m rows d apart that cover n rows: blocks of m * d rows, d
// groups each, and the last, partial block's groups (min(rest, d)); a
// group of the partial block may have rows past n.
__host__ __device__ inline int row_groups(int n, int d, int m) {
  const int rest = n % (m * d);
  return n / (m * d) * d + (rest < d ? rest : d);
}

// The first row of group g.
__host__ __device__ inline int group_row(int g, int d, int m) { return g / d * (m * d) + g % d; }

// How a box is copied: one contiguous span in 16-byte chunks (odd Cin,
// overlapping windows), three spans of 4-byte copies (odd Cin, disjoint
// windows), or position by position at stride Cin + 1 (even Cin).
enum Mode { kSpan16 = 0, kSpans4 = 1, kScatter = 2 };

// One staged box: t_x output voxels along x, the three x taps' windows
// sx apart (d, or t_x when d >= t_x), width t_x + 2 sx positions.
struct Box {
  int tx, sx, width, mode;
};

__host__ __device__ inline Box make_box(int tx, int d, int cin) {
  const int sx = d < tx ? d : tx;
  const int mode = (cin & 1) == 0 ? kScatter : (sx == d ? kSpan16 : kSpans4);
  return Box{tx, sx, tx + 2 * sx, mode};
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most the N newest commit groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }


// Where a box's position 0 lies in its slot: the shift, 0 to 3 floats, at
// which a kSpan16 copy keeps source and destination 16-byte aligned alike.
__device__ __forceinline__ int box_shift(const float* row, int cin, int x0, int d, const Box& box) {
  if (box.mode != kSpan16) return 0;
  return (int)((reinterpret_cast<uintptr_t>(row + (int64_t)(x0 - d) * cin) >> 2) & 3);
}

// Copy the box of one input row for the chunk whose output voxels start at
// x0 into the slot dst (16-byte aligned): position i of the box, channel
// ci, at dst[box_shift + i * cs + ci]. row points at the row's x = 0;
// positions outside [0, extent) are zero-filled without being read. One
// warp, lanes on neighbouring addresses.
__device__ __forceinline__ void stage_box(float* dst, const float* row, int cin, int cs, int x0, int d,
                                          const Box& box, int extent, int lane) {
#ifdef CONV_TILE_NO_COPY
  return;
#endif
  const int hi = extent * cin;  // the row's floats
  if (box.mode == kSpan16) {
    const int f0 = (x0 - d) * cin, f1 = f0 + box.width * cin;
    const int sh = box_shift(row, cin, x0, d, box);
    float* base = dst + sh - f0;  // float f of the row goes to base + f
    int a = f0 + ((4 - sh) & 3);  // the first 16-byte aligned float
    if (a > f1) a = f1;
    const int nch = (f1 - a) >> 2, b = a + 4 * nch, nhead = a - f0;
    for (int i = lane; i < nhead + (f1 - b); i += 32) {
      const int f = i < nhead ? f0 + i : b + i - nhead;
      const bool ok = f >= 0 && f < hi;
      cp_async4(base + f, row + (ok ? f : 0), ok);
    }
    for (int c = lane; c < nch; c += 32) {
      const int f = a + 4 * c;
      if ((f >= 0 && f + 4 <= hi) || f + 4 <= 0 || f >= hi) {
        const bool ok = f >= 0 && f + 4 <= hi;
        cp_async16(base + f, row + f, ok);  // 16-byte aligned; not read when !ok
      } else {
        for (int e = 0; e < 4; ++e) {
          const bool ok = f + e >= 0 && f + e < hi;
          cp_async4(base + f + e, row + (ok ? f + e : 0), ok);
        }
      }
    }
  } else if (box.mode == kSpans4) {
    for (int win = 0; win < 3; ++win) {
      const int f0 = (x0 + (win - 1) * d) * cin, n = box.tx * cin;
      float* o = dst + win * n;
      for (int i = lane; i < n; i += 32) {
        const int f = f0 + i;
        const bool ok = f >= 0 && f < hi;
        cp_async4(o + i, row + (ok ? f : 0), ok);
      }
    }
  } else {
    for (int i = lane; i < box.width; i += 32) {
      const int win = (i >= box.sx) + (i >= 2 * box.sx);  // which x tap's window
      const int gx = x0 + (win - 1) * d + i - win * box.sx;
      const bool ok = gx >= 0 && gx < extent;
      const float* src = row + (ok ? (int64_t)gx * cin : 0);
      float* o = dst + i * cs;
      for (int ci = 0; ci < cin; ++ci) cp_async4(o + ci, src + (ok ? ci : 0), ok);
    }
  }
}

// Input row J (-1 .. M) of a warp's group feeds output row m = J - ty
// through tap row (tz, ty) for each ty in {-1, 0, 1} with 0 <= m < M:
// acc[m][k][co] += in[xo[k] + t * step + ci] * w_tz[((ty + 1) * 3 + t)
// * cin * CP + ci * CP + co] over the three x taps t and the input
// channels ci, ci innermost (K1's order). Each input is loaded once for
// all the rows it feeds. xo[k] is lane k's position (times the channel
// stride) in the box or row; step is the x taps' distance; w_tz the
// weights of tap plane tz. J is a template parameter, so which rows an
// input feeds and where their weights lie are known to the compiler; so
// is the channel count when CIN > 0 (CIN = 0: cin at run time), which
// makes the weights' offsets constants. The channel loop stays rolled.
template <int R, int C, int CP, int M, int CIN, int J>
__device__ __forceinline__ void accumulate_rows_j(float (&acc)[M][R][C], const float* in, const int (&xo)[R], int step,
                                                  const float* w_tz, int cin_rt) {
#ifdef CONV_TILE_NO_FMA
  return;
#endif
  const int cin = CIN > 0 ? CIN : cin_rt;
  constexpr int M_LO = J - 1 > 0 ? J - 1 : 0, M_HI = J + 1 < M - 1 ? J + 1 : M - 1;
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    const float* pin = in + t * step;
    const float* pk[R];
#pragma unroll
    for (int k = 0; k < R; ++k) pk[k] = pin + xo[k];
#pragma unroll 1  // unrolled, the C = 5 kernel's loops are ~86 KB of code and ran 11-16 % slower
    for (int ci = 0; ci < cin; ++ci) {
      float v[R];
#pragma unroll
      for (int k = 0; k < R; ++k) v[k] = pk[k][ci];
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

// accumulate_rows_j for the input row j known at run time (-1 .. M).
template <int R, int C, int CP, int M, int CIN>
__device__ __forceinline__ void accumulate_rows(float (&acc)[M][R][C], const float* in, const int (&xo)[R], int step,
                                                const float* w_tz, int cin, int j) {
  static_assert(M == 1 || M == 2, "rows a warp: 1 or 2");
  switch (j) {
    case -1:
      accumulate_rows_j<R, C, CP, M, CIN, -1>(acc, in, xo, step, w_tz, cin);
      break;
    case 0:
      accumulate_rows_j<R, C, CP, M, CIN, 0>(acc, in, xo, step, w_tz, cin);
      break;
    case 1:
      accumulate_rows_j<R, C, CP, M, CIN, 1>(acc, in, xo, step, w_tz, cin);
      break;
    default:
      if (M == 2) accumulate_rows_j<R, C, CP, M, CIN, M == 2 ? 2 : 1>(acc, in, xo, step, w_tz, cin);
      break;
  }
}

// Copy taps * cin weight rows of C floats (global, C innermost) into
// shared memory at row stride CP, the padding zero. All threads.
template <int C, int CP>
__device__ __forceinline__ void stage_weights(float* dst, const float* w, int rows, int tid, int nthreads) {
  for (int i = tid; i < rows * CP; i += nthreads) {
    const int r = i / CP, co = i - r * CP;
    dst[i] = co < C ? w[r * C + co] : 0.0f;
  }
}

template <int M, int R, int C>
__device__ __forceinline__ void zero(float (&acc)[M][R][C]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int k = 0; k < R; ++k)
#pragma unroll
      for (int co = 0; co < C; ++co) acc[m][k][co] = 0.0f;
}

}  // namespace conv_tile
