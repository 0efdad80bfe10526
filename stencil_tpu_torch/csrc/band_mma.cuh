// The tensor-core band contraction shared by the Jacobi marches
// (csrc/jacobi_wavefront.cu, its STP_JW_UNIT builds), the mean-of-6 plane
// kernel (csrc/plane_stencil.cu) and the stream kernels' contraction form
// (csrc/stream_{wrap,plane,wavefront}.cu, generated parts that define
// STP_NBR_MASK), for Hopper (sm_90a).
//
// What it computes: the in-plane neighbour sums (y-1 + y+1) + (z-1 + z+1)
// of a plane held in shared memory, the four in-plane taps of a mean-of-6
// level as the JAX package's compute_unit="mxu" / "mxu_band" contracts them
// against the (2r+1)-band (r = 1; stencil_tpu/ops/jacobi_pallas.py:475-526,
// the PlaneView.plane_nbr_sum seam of stencil_tpu/ops/stream.py:189-200).
// A warp contracts a 16 x 16 piece of the plane, rows r0.., columns c0..,
// into mma.sync's accumulator layout: its lane (g, t) = (lane / 4, lane % 4)
// holds nb[r][q], the cell at row r0 + g + 8 (r / 2), column c0 + 8q + 2t +
// r % 2.  Over y the band is A and the plane B, against the row chunks that
// hold rows r0 - 1 .. r0 + 16 (f32 operands: chunks of 8 from r0 - 8; bf16:
// every chunk of 16 from row 0); over z the plane is A and the band B,
// against the column chunks that hold c0 - 1 .. c0 + 16.  A chunk that
// starts outside the plane is skipped (the plane's edge is apron, whose
// sums are garbage anyway); one that starts inside but ends past a plane of
// ROWS no multiple of 16 reads up to 10 rows beyond it, which the caller's
// allocation holds and the band's zeros leave out of every sum.  r0 may be
// any row with r0 + 16 <= ROWS (a plane whose rows are no multiple of 16
// takes a last piece that overlaps the one before, piece_to_plane); c0 is a
// multiple of 8.  For the Jacobi tile (32 x 64, r0 and c0 multiples of 16)
// this is the Jacobi builds' tile contraction, chunk for chunk.
//
// Operands (kUnit): 1, mxu_input="f32": m16n8k8 TF32 on each cell split
// exactly into three TF32 pieces with cvt.rna (hi, mid, and the rest of at
// most 3 bits), lowest first, so that a sum of two cells is the f32 sum up
// to the tensor core's rounding of its accumulation (within tests/ulp.py's 4
// ulps a level); 2, mxu_input="bf16": m16n8k16 with each cell rounded to
// bfloat16 (to nearest even) once a read.  The band's 0/1 entries are exact
// either way; mxu and mxu_band share this contraction.
//
// A zero band entry times a cell is 0 only for a finite cell, and a sum
// overflows a level later if its cells are near FLT_MAX.  With kClean each
// operand whose magnitude is not below kMxuLimit (FLT_MAX / 8; inf and NaN
// too) enters as 0: apron and pad cells may hold anything, and a kernel that
// contracts level planes it computed itself (the stream kernels) cannot
// assume them finite.  The Jacobi marches clean their level-0 cells at the
// load instead (their levels are means of clean cells).
//
// The shared plane's float2 reads need 8-byte aligned rows: SP even and the
// plane's base 8-byte aligned.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace band_mma {

// the largest cell magnitude a contraction takes as it is (FLT_MAX / 8): six
// such values and their means never overflow
constexpr float kMxuLimit = 0x1.fffffep+124f;

__device__ __forceinline__ float clean(float x) { return fabsf(x) < kMxuLimit ? x : 0.0f; }

// --- TF32 operands (kUnit 1) -----------------------------------------------------

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}
// x = p[2] + p[1] + p[0] exactly, each a TF32 value: hi, mid and the rest
// (x has 24 significant bits, hi and mid 11 each, the rest at most 3)
__device__ __forceinline__ void split3(float x, uint32_t (&p)[3]) {
  const uint32_t hi = tf32_rna(x);
  const float r = __fsub_rn(x, __uint_as_float(hi));
  const uint32_t mid = tf32_rna(r);
  p[0] = __float_as_uint(__fsub_rn(r, __uint_as_float(mid)));
  p[1] = mid;
  p[2] = hi;
}
// a band entry as a TF32 operand: 1 at distance 1, else 0
__device__ __forceinline__ uint32_t band32(int d) { return d == 1 || d == -1 ? 0x3f800000u : 0u; }
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// --- bf16 operands (kUnit 2) -----------------------------------------------------

// two cells rounded to bfloat16 (to nearest even), `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// two band entries as a bf16 pair, d0's in the low half
__device__ __forceinline__ uint32_t band16(int d0, int d1) {
  return (d0 == 1 || d0 == -1 ? 0x3f80u : 0u) | (d1 == 1 || d1 == -1 ? 0x3f800000u : 0u);
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// --- the contraction of one piece ---------------------------------------------------

// The in-plane sums of the 16 x 16 piece at rows r0.., columns c0.. of the
// ROWS x COLS plane `p` (row pitch SP cells) into nb[r][q], this lane's
// cells (the header).  A z chunk's columns are taken in the order c, c + 1
// for k = t, t + 4 (TF32) so that a lane reads them as one float2; the band
// operand follows the same order.
template <int kUnit, int ROWS, int COLS, int SP, bool kClean>
__device__ __forceinline__ void piece_sums(const float* p, int r0, int c0, int g, int t, float (&nb)[4][2]) {
  static_assert(kUnit == 1 || kUnit == 2, "kUnit: 1 TF32 pieces, 2 bf16 operands");
  static_assert(SP % 2 == 0 && ROWS >= 16 && COLS % 8 == 0, "the plane's shape");
  auto ld = [&](int i) -> float { return kClean ? clean(p[i]) : p[i]; };
  auto ld2 = [&](int i) -> float2 {
    const float2 v = *reinterpret_cast<const float2*>(&p[i]);
    return kClean ? make_float2(clean(v.x), clean(v.y)) : v;
  };
  float ys[2][4] = {}, zs[2][4] = {};
  if constexpr (kUnit == 1) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // y: rows k0 .. k0 + 7, k0 = r0 - 8 + 8j
      const int dl = 8 * j - 8, k0 = r0 + dl;
      if (k0 < 0 || k0 >= ROWS) continue;
      // A[m][k] = 1 where |(r0 + m) - (k0 + k)| = 1: m = g, g + 8; k = t, t + 4
      const uint32_t a[4] = {band32(g - t - dl), band32(g + 8 - t - dl), band32(g - t - 4 - dl),
                             band32(g + 4 - t - dl)};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int col = c0 + 8 * q + g;
        uint32_t b0[3], b1[3];
        split3(ld((k0 + t) * SP + col), b0);
        split3(ld((k0 + t + 4) * SP + col), b1);
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          const uint32_t b[2] = {b0[e], b1[e]};
          mma_tf32(ys[q], a, b);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // z: columns k0 .. k0 + 7, k0 = c0 - 8 + 8j
      const int k0 = c0 - 8 + 8 * j;
      if (k0 < 0 || k0 >= COLS) continue;
      const float2 u = ld2((r0 + g) * SP + k0 + 2 * t);
      const float2 w = ld2((r0 + g + 8) * SP + k0 + 2 * t);
      uint32_t u0[3], u1[3], w0[3], w1[3];
      split3(u.x, u0);
      split3(u.y, u1);
      split3(w.x, w0);
      split3(w.y, w1);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int dl = 8 * (j - 1 - q);  // k0 - (c0 + 8q)
        if (dl < -8 || dl > 8) continue;
        // B[k][n] = 1 where |(k0 + column of k) - (c0 + 8q + n)| = 1: n = g;
        // k = t at column 2t, k = t + 4 at column 2t + 1
        const uint32_t b[2] = {band32(2 * t - g + dl), band32(2 * t + 1 - g + dl)};
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          const uint32_t a[4] = {u0[e], w0[e], u1[e], w1[e]};
          mma_tf32(zs[q], a, b);
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < (ROWS + 15) / 16; ++j) {  // y: rows k0 .. k0 + 15, k0 = 16j; row k of
      // the chunk at k0 + t, + 4, + 8, + 12 for k = 2t, 2t + 1, 2t + 8, 2t + 9
      const int k0 = 16 * j, dl = k0 - r0;
      const uint32_t a[4] = {band16(g - t - dl, g - t - 4 - dl), band16(g + 8 - t - dl, g + 4 - t - dl),
                             band16(g - t - 8 - dl, g - t - 12 - dl), band16(g - t - dl, g - t - 4 - dl)};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int col = c0 + 8 * q + g;
        const uint32_t b[2] = {pack_bf16(ld((k0 + t) * SP + col), ld((k0 + t + 4) * SP + col)),
                               pack_bf16(ld((k0 + t + 8) * SP + col), ld((k0 + t + 12) * SP + col))};
        mma_bf16(ys[q], a, b);
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {  // z: columns k0 .. k0 + 15, k0 = c0 - 16 + 16j
      const int k0 = c0 - 16 + 16 * j;
      if (k0 < 0 || k0 >= COLS) continue;
      const float2 u = ld2((r0 + g) * SP + k0 + 2 * t);
      const float2 w = ld2((r0 + g + 8) * SP + k0 + 2 * t);
      const float2 u8 = ld2((r0 + g) * SP + k0 + 2 * t + 8);
      const float2 w8 = ld2((r0 + g + 8) * SP + k0 + 2 * t + 8);
      const uint32_t a[4] = {pack_bf16(u.x, u.y), pack_bf16(w.x, w.y), pack_bf16(u8.x, u8.y), pack_bf16(w8.x, w8.y)};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int dl = 16 * (j - 1) - 8 * q;  // k0 - (c0 + 8q)
        if (dl < -16 || dl > 8) continue;
        const uint32_t b[2] = {band16(2 * t - g + dl, 2 * t + 1 - g + dl), band16(2 * t + 8 - g + dl, 2 * t + 9 - g + dl)};
        mma_bf16(zs[q], a, b);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int r = 0; r < 4; ++r) nb[r][q] = ys[q][r] + zs[q][r];
}

// The pieces of a ROWS x COLS plane: rows of pieces (the last starts at
// ROWS - 16 where ROWS is no multiple of 16) times COLS / 16.
template <int ROWS, int COLS>
constexpr int kPieces = (ROWS + 15) / 16 * (COLS / 16);

// Piece pc of the in-plane sums of the ROWS x COLS plane `src` (pitch SP)
// into the plane `dst` (pitch DP), by one warp.  Where ROWS is no multiple
// of 16 the last row of pieces starts at ROWS - 16 and writes all its rows,
// and the row of pieces before it stops there (ROWS >= 32 there, so that
// the last row of pieces has a chunk above it).  The caller orders
// the writes of `src` before this call and this call's writes of `dst`
// before their reads (block barriers).
template <int kUnit, int ROWS, int COLS, int SP, int DP>
__device__ __forceinline__ void piece_to_plane(const float* src, float* dst, int pc, int lane) {
  static_assert(COLS % 16 == 0, "the plane's columns come in pieces of 16");
  static_assert(ROWS % 16 == 0 || ROWS >= 32, "a last row of pieces needs a chunk above it");
  const int g = lane >> 2, t = lane & 3;
  const int own = 16 * (pc / (COLS / 16));
  const bool last = own + 16 >= ROWS;
  const int r0 = last ? ROWS - 16 : own;  // the piece's first row, and the first it writes
  const int r1 = last ? ROWS : min(own + 16, ROWS - 16);  // past the last it writes
  const int c0 = 16 * (pc % (COLS / 16));
  float nb[4][2];
  piece_sums<kUnit, ROWS, COLS, SP, true>(src, r0, c0, g, t, nb);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + g + 8 * (r >> 1);
    if (row >= r1) continue;
#pragma unroll
    for (int q = 0; q < 2; ++q) dst[row * DP + c0 + 8 * q + 2 * t + (r & 1)] = nb[r][q];
  }
}

}  // namespace band_mma
