// m levels of a traced user kernel over s-shell blocks in ONE pass, for
// Hopper (sm_90a), bound to Python through ctypes
// (stencil_tpu_torch/kernels/build.py, stencil_tpu_torch/ops/stream.py).
//
// A kernel template: the line `// @STP_GENERATED@` below is replaced by the
// body that stencil_tpu_torch/ops/stream_trace.py emits for one user kernel
// (STP_NF, the field count; STP_M, the depth this library runs; stp_body,
// the kernel's arithmetic; STP_X_QUEUE when every read at x-1 or x+1 is at
// in-plane offset (0, 0)), and the result is built by nvcc into a library of
// its own, one per depth.
//
// stp_stream_wavefront replaces stencil_tpu/ops/stream.py:481
//   stream_wavefront_pass: m levels (read radius 1) of a user kernel over n
//   (Xr, Yr, Zr) blocks per field that carry an s-wide filled shell (m <= s);
//   validity shrinks by one cell per level.  In the z-slab form the z columns
//   [0, s) and [W - s, W) come from a z-major (Xr, 2s, Yr) slab buffer per
//   field and the next slabs are emitted (kSlabs = true); W = z_valid, and
//   columns [W, Zr) are dead.
//
// The fused form (built with STP_FUSED defined; halo="fused" in
// ops/stream.py, the fused_shell inputs of stencil_tpu/ops/stream.py:634-660)
// is a third form of the plain layout (W = Zr): the blocks carry a STALE
// shell, and the shell the exchange would have written comes from three
// small buffers per field over the n blocks, x planes (n, 2s, Yr, Zr), y rows
// (n, 2s, Xr, Zr) and z columns (n, 2s, Yr, Xr), each [low | high].  Every
// level-0 cell enters through load_cell, which takes a shell-position cell
// from them, z column over y row over x plane (the exchange's sweep order:
// the later sweep's write wins), so the levels see what the array form sees
// after the exchange, bit for bit, and the blocks see no halo write.  Both
// the general and the register-queue form take it; the other forms are the
// same templates with the plain Args, unchanged.
//
// A block owns a tile of the plane interior [s, Yr-s) x [s, W-s) for one
// block b and one chunk of output x planes, loads it with an m-cell apron (a
// tile row with its apron is kTileW = 64 columns, two full warps) and marches
// x: per step it loads level-0 plane i of every field and computes level l of
// plane i-l for l = 1..m over the tile shrunk by l, so level m lands exactly
// on the tile.  The next plane's global loads are issued into registers
// before the current plane's levels run.  Two forms, chosen when the module
// is emitted:
//
// * The register-queue form (STP_X_QUEUE: Astaroth's and the mean6 bodies).
//   Level l at plane p reads level l-1 at planes p-1 and p+1 only at its own
//   cell, so a thread keeps its own cells' level-(l-1) planes p-1 and p in
//   registers (with p+1, just computed, a queue three planes long) and only
//   plane p of each level below m goes to shared memory, for the in-plane
//   neighbours.  Those planes are double-buffered by the parity of the
//   march, so a plane costs ONE block barrier:
//
//     STP_NF x 2m planes of kQueueRows(m) x kTileW 4-byte cells (8 at double)
//
//   (m = 3, one field: 49,152 B and 544 B of padding).  A thread owns
//   kQueueRows / kQueueWarps = 2 consecutive rows of two columns; a y
//   neighbour inside those rows comes from its registers, so the Astaroth
//   body costs 4 shared accesses a cell and level (two z neighbours, one y
//   neighbour, one store) where the general form pays 7.  Every cell of the
//   tile runs every level, its apron's too, so no test guards a cell: the
//   tile rows are whole thread rows, and padding around the planes keeps the
//   edge's reads in bounds.  The tile (32 rows of 16 warps, 64 registers a
//   thread, two blocks an SM) is the fastest of those timed on the H100
//   (PERF.md): 48 rows spill at 64 registers or halve the blocks an SM, and
//   planes loaded two ahead, in registers or by cp.async, lost to one.
// * The general form (a 27-point kernel reads x-1 at in-plane offsets): per
//   field the two most recent planes of each level below m, the incoming
//   level-0 plane and one spare plane that each level's result goes to, all
//   in shared memory:
//
//     STP_NF x (2m + 2) planes of (kTileY + 2m) x kTileW 4-byte cells (8 at double)
//
//   (m = 3, one field: 77,824 B) and m + 1 block barriers a plane.  A level
//   may not overwrite the plane it reads: a neighbouring thread may still
//   read it at x-1.  stream_smem_bytes in ops/stream.py is this formula, the
//   plan's model; the queue form never asks more, and the launch computes the
//   size it asks.
//
// Grid.  The launch asks the occupancy calculator how many blocks of the
// chosen form fit on an SM at the shared memory it asks (registers, threads
// and shared memory together), and cuts x into chunks so that the blocks fill
// whole waves: it picks the chunk count that minimises (waves) x (planes a
// block marches, its 2m-plane ramp included).  Blocks march disjoint chunks
// of output planes [p_lo, p_hi), each starting m planes early; the chunking
// changes no value.  stp_stream_wavefront_plan reports the choice.
//
// Bound on an H100 SXM: bytes.  Per pass of m levels the kernel must read the
// input and the slabs and write the output and the new slabs once, 8/m B per
// cell-level and field; what the tiles cost on top is the apron (the tile
// with its apron over the tile: 32 x 64 over 26 x 58, 1.36x, in the queue
// form at m = 3), the ramp of each chunk, the shared-memory traffic and the
// issue of about ten instructions a cell and level.
//
// Cells outside the valid region (the apron beyond the plane's edge, which
// loads 0 and never leaves the block's memory; planes before the march has
// filled the levels) hold garbage that only ever feeds other such cells, the
// shrinking-validity argument of the TPU kernel: only the block interior
// [s, ext-s) of `out` and the interior x planes / y rows of `zout` are
// written.
//
// Field dtypes (the generated part's STP_S, STP_C, STP_P and access macros,
// ops/stream_trace.py): the planes in shared memory, the register queues and
// the levels are STP_C (float for float and bf16 storage, double for double
// fields and for groups that mix float with double), and the one rounding to
// STP_S is the store of level m and of the emitted z slabs, as the JAX pass
// keeps f32 level rings under f32_accumulate and downcasts once
// (stencil_tpu/ops/stream.py:612-620).  The prefetch registers hold the
// cells as loaded (STP_P, bf16 under bf16 storage) and STP_UP widens them
// where they are used, a plane later: a widening right after the load would
// make the SM wait on it.  Cells are sizeof(STP_C) bytes in the shared-memory
// sizes below, so a double queue of m = 3 and one field asks 98,304 B, and
// the double register-queue form is cut for one block an SM, not two.
//
// The contraction form (compute_unit "mxu" / "mxu_band": the generated
// part defines STP_NBR_MASK, the fields whose centre plane a level
// contracts, and STP_MXU, 1 for f32 operands as three TF32 pieces, 2 for
// bf16 operands; its stp_body reads a field's in-plane neighbour sum
// (y-1 + y+1) + (z-1 + z+1) through nb(q), the PlaneView.plane_nbr_sum
// seam of stencil_tpu/ops/stream.py:189-200), in both forms and all three
// layouts (plain, z-slab and fused: the fused form's level-0 cells enter
// through load_cell as above, so the planes it contracts are the patched
// ones the JAX pass contracts, _fused_plane_patch at
// stencil_tpu/ops/stream.py:239-259).  The level planes of a tile already
// sit in shared memory: the block's warps contract them on the tensor
// cores, one 16 x 16 piece at a time (csrc/band_mma.cuh; a plane of 32 + 2m
// rows takes a last row of pieces that overlaps the one before), into
// shared planes of sums at the tile's layout, which the per-cell body
// reads, its cell mapping unchanged.  The queue form contracts, once a march step, the centre
// planes of every level (plane p of level l-1 for l = 1..m, all written the
// step before) into m planes of sums a field, one barrier more a plane; the
// general form contracts each level's centre plane into one plane of sums a
// field before the level, one barrier more a level.  The JAX pass contracts
// the whole wavefront plane, periodic; a valid cell's neighbours lie in the
// tile, so the sums it reads are the same.  Shared memory a block, cells of
// 4 bytes: the queue form adds STP_NF x m planes, the general form STP_NF
// planes (stream_smem_bytes prices the general form's).
//
// Bitwise contract: stp_body uses __fadd_rn/__fmul_rn/... (no contraction);
// the global coordinates are (origin + index - s) mod global size, as
// _yz_coord_planes computes them in the JAX package.  Both forms evaluate the
// same body on the same values.  Offsets are 64-bit.  The contraction form
// holds within tests/ulp.py's 4 ulps a level of its plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// @STP_GENERATED@

#ifdef STP_NBR_MASK
#include "band_mma.cuh"
constexpr int kNbrPlanes = 1;  // planes of sums a field and level
#define STP_NB_ARG nb,  // stp_body's reads of the sums, nb(q)
#else
constexpr int kNbrPlanes = 0;
#define STP_NB_ARG
#endif

namespace {

constexpr int kTileW = 64;  // == STREAM_TILE_W in ops/stream.py: tile columns with the apron
constexpr int kThreadsZ = 32;

struct Args {
  const STP_S* raw[STP_NF];  // (n, Xr, Yr, Zr) each
  STP_S* out[STP_NF];
  const STP_S* zs[STP_NF];   // (n, Xr, 2s, Yr) each, or null
  STP_S* zout[STP_NF];
  const int* origins;        // (n, 3)
  int Xr, Yr, Zr;
  int W;                     // logical plane width (z_valid)
  int s;                     // shell width
  int gx, gy, gz;
  int xchunk, nchunks;       // output x planes per block, chunks per block b
};

// the fused form's arguments: the shell buffers per field (zs/zout unused)
struct FusedArgs : Args {
  const STP_S* xb[STP_NF];   // (n, 2s, Yr, Zr) each
  const STP_S* yb[STP_NF];   // (n, 2s, Xr, Zr) each
  const STP_S* zb[STP_NF];   // (n, 2s, Yr, Xr) each
};

template <class A>
constexpr bool kFusedArgs = std::is_same<A, FusedArgs>::value;

__device__ __forceinline__ int pmod(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

// Level-0 cell (i, y, col) of field q: the slab buffer for the z shell
// columns in the slab form, else the block; 0 past the plane's edge.  As
// stored (STP_P).
template <bool kSlabs>
__device__ __forceinline__ STP_P load_cell(const Args& a, int q, int64_t xo, int64_t zxo, int y, int col) {
  if (y >= a.Yr || col >= a.W) return STP_P(0.0f);
  const int s = a.s;
  if (kSlabs && col < s) return STP_GET(a.zs[q], q, zxo + (int64_t)col * a.Yr + y);
  if (kSlabs && col >= a.W - s) return STP_GET(a.zs[q], q, zxo + (int64_t)(s + col - (a.W - s)) * a.Yr + y);
  return STP_GET(a.raw[q], q, xo + (int64_t)y * a.Zr + col);
}

// The fused form's level-0 cell (i, y, col) of block b and field q: the
// z-column buffer over the y-row buffer over the x-plane buffer at shell
// positions, the block elsewhere (xo its plane's offset); 0 past the edge.
__device__ __forceinline__ STP_P load_cell(const FusedArgs& a, int q, int64_t b, int i, int64_t xo, int y,
                                           int col) {
  if (y >= a.Yr || col >= a.W) return STP_P(0.0f);
  const int s = a.s, Xr = a.Xr, Yr = a.Yr, Zr = a.Zr;
  if (col < s || col >= Zr - s) {
    const int k = col < s ? col : s + col - (Zr - s);
    return STP_GET(a.zb[q], q, ((b * 2 * s + k) * Yr + y) * Xr + i);
  }
  if (y < s || y >= Yr - s) {
    const int k = y < s ? y : s + y - (Yr - s);
    return STP_GET(a.yb[q], q, ((b * 2 * s + k) * Xr + i) * Zr + col);
  }
  if (i < s || i >= Xr - s) {
    const int k = i < s ? i : s + i - (Xr - s);
    return STP_GET(a.xb[q], q, ((b * 2 * s + k) * Yr + y) * Zr + col);
  }
  return STP_GET(a.raw[q], q, xo + (int64_t)y * Zr + col);
}

// Level-0 cell (i, y, col) of form A (Args: kSlabs picks the z-slab form).
template <bool kSlabs, class A>
__device__ __forceinline__ STP_P level0(const A& a, int q, int64_t b, int i, int64_t xo, int64_t zxo, int y,
                                        int col) {
  if constexpr (kFusedArgs<A>) {
    return load_cell(a, q, b, i, xo, y, col);
  } else {
    return load_cell<kSlabs>(a, q, xo, zxo, y, col);
  }
}

// Level m's value of cell (p, y, col) to the output and, in the slab form,
// to the emitted slabs, rounded to the storage type.
template <bool kSlabs>
__device__ __forceinline__ void store_out(const Args& a, int64_t bo, int64_t zbo, int p, int y, int col,
                                          const STP_C (&v)[STP_NF]) {
  const int s = a.s, Yr = a.Yr, W = a.W;
  const int64_t o = bo + (int64_t)p * Yr * a.Zr + (int64_t)y * a.Zr + col;
#pragma unroll
  for (int q = 0; q < STP_NF; ++q) {
    STP_ST(a.out[q], q, o, v[q]);
    if (kSlabs) {
      // rows [0, s): top interior columns (the -z-bound message);
      // rows [s, 2s): bottom interior columns (+z-bound)
      const int64_t zo = zbo + (int64_t)p * 2 * s * Yr + y;
      if (col >= W - 2 * s) STP_ST(a.zout[q], q, zo + (int64_t)(col - (W - 2 * s)) * Yr, v[q]);
      if (col < 2 * s) STP_ST(a.zout[q], q, zo + (int64_t)col * Yr, v[q]);
    }
  }
}

#ifdef STP_X_QUEUE

constexpr int kQueueWarps = 16;      // thread rows
constexpr int kQueueTileRows = 32;   // tile rows with the apron, a multiple of the thread rows
constexpr int kQueueMinBlocks = sizeof(STP_C) == 4 ? 2 : 1;  // blocks an SM the registers are cut for (m <= 4)

// The queue form's tile rows, its apron included: kQueueTileRows, or more
// thread rows where 2m would leave fewer than 8 output rows.
__host__ __device__ constexpr int kQueueRows(int m) {
  int h = kQueueTileRows;
  while (h - 2 * m < 8) h += kQueueWarps;
  return h;
}

constexpr int kThreads = kThreadsZ * kQueueWarps;
constexpr int kQueueForm = 1;

// cells before the first plane and after the last, so that a read at an
// in-plane offset from any tile cell stays inside the allocation
constexpr int kPad = kTileW + 4;

// per field: two planes of each level 0..m-1 (and, in the contraction form,
// a plane of sums of each)
template <int M>
constexpr size_t smem_bytes() {
  return ((size_t)STP_NF * (2 + kNbrPlanes) * M * kQueueRows(M) * kTileW + 2 * kPad) * sizeof(STP_C);
}

template <int M>
constexpr int tile_rows() {
  return kQueueRows(M) - 2 * M;
}

// At m <= 4 the registers are cut so that two blocks fit an SM (64 a thread;
// at double, one block and 128).
template <int M, bool kSlabs, class A>
__global__ void __launch_bounds__(kThreads, M <= 4 ? kQueueMinBlocks : 1) wavefront(A a) {
  extern __shared__ STP_C smem_all[];
  STP_C* const smem = smem_all + kPad;
  constexpr int m = M;
  constexpr int H = kQueueRows(M);
  constexpr int TW = kTileW;
  constexpr int TZ = kTileW - 2 * m;  // output columns per tile
  constexpr int P = H * TW;
  constexpr int RI = H / kQueueWarps;  // consecutive rows a thread owns
  constexpr int CI = TW / kThreadsZ;   // columns a thread owns, 32 apart
  // plane of level L (< m) of field q at march parity `par`
  auto plane = [&](int q, int L, int par) -> STP_C* { return smem + ((q * m + L) * 2 + par) * P; };
#ifdef STP_NBR_MASK
  // the sums of field q's level-L centre plane, after the level planes and the padding
  float* const sums = smem + STP_NF * 2 * m * P + kPad;
#endif
  const int s = a.s;
  const int b = blockIdx.z / a.nchunks;
  const int chunk = blockIdx.z - b * a.nchunks;
  const int p_lo = s + chunk * a.xchunk;
  const int p_hi = min(p_lo + a.xchunk, a.Xr - s);
  // tile cell (0, 0) at row y0, column c0; >= 0 since s >= m
  const int y0 = s + blockIdx.y * (H - 2 * m) - m;
  const int c0 = s + blockIdx.x * TZ - m;
  const int Yr = a.Yr, W = a.W;
  const int64_t plane_cells = (int64_t)Yr * a.Zr;
  const int64_t zplane = (int64_t)2 * s * Yr;
  const int64_t bo = (int64_t)b * a.Xr * plane_cells;
  const int64_t zbo = (int64_t)b * a.Xr * zplane;
  const int ox = a.origins[3 * b], oy = a.origins[3 * b + 1], oz = a.origins[3 * b + 2];
  const int tz0 = threadIdx.x, ty0 = threadIdx.y * RI;
  // the cells whose level m this thread writes: inside the tile's level-m
  // region and the block's interior (bit r * CI + c)
  unsigned own = 0;
#pragma unroll
  for (int r = 0; r < RI; ++r)
#pragma unroll
    for (int c = 0; c < CI; ++c) {
      const int ty = ty0 + r, tz = tz0 + c * kThreadsZ;
      if (ty >= m && ty < H - m && tz >= m && tz < TW - m && y0 + ty < Yr - s && c0 + tz < W - s)
        own |= 1u << (r * CI + c);
    }

  // output plane p = i - m needs level-0 planes p-m .. p+m
  const int i0 = p_lo - m;
  const int i_end = p_hi + m;
  // level-0 plane i of this thread's cells, fetched one plane ahead, as loaded
  STP_P pre[STP_NF][RI][CI];
  auto fetch = [&](int i) {
    const int64_t xo = bo + (int64_t)i * plane_cells, zxo = zbo + (int64_t)i * zplane;
#pragma unroll
    for (int r = 0; r < RI; ++r)
#pragma unroll
      for (int c = 0; c < CI; ++c)
#pragma unroll
        for (int q = 0; q < STP_NF; ++q)
          pre[q][r][c] = level0<kSlabs>(a, q, b, i, xo, zxo, y0 + ty0 + r, c0 + tz0 + c * kThreadsZ);
  };

  // the queue of level L < m at this thread's cells: old (plane j-1) and mid
  // (plane j, also in shared memory), j = i - L - 1 while plane i marches in;
  // nw holds the newest plane of the level below the one being computed
  STP_C old_[STP_NF][m][RI][CI], mid[STP_NF][m][RI][CI], nw[STP_NF][RI][CI];
#pragma unroll
  for (int q = 0; q < STP_NF; ++q)
#pragma unroll
    for (int L = 0; L < m; ++L)
#pragma unroll
      for (int r = 0; r < RI; ++r)
#pragma unroll
        for (int c = 0; c < CI; ++c) old_[q][L][r][c] = mid[q][L][r][c] = 0.0f;

  fetch(i0);
  for (int i = i0; i < i_end; ++i) {
    const int wp = i & 1, rp = wp ^ 1;  // this plane's buffers; the previous plane's
#pragma unroll
    for (int q = 0; q < STP_NF; ++q)
#pragma unroll
      for (int r = 0; r < RI; ++r)
#pragma unroll
        for (int c = 0; c < CI; ++c) {
          nw[q][r][c] = STP_UP(q, pre[q][r][c]);
          plane(q, 0, wp)[(ty0 + r) * TW + tz0 + c * kThreadsZ] = STP_UP(q, pre[q][r][c]);
        }
    if (i + 1 < i_end) fetch(i + 1);
#ifdef STP_NBR_MASK
    {  // level l's centre, level l-1 at plane i-l, is at the other parity
      constexpr int kPc = band_mma::kPieces<H, TW>;
      for (int job = threadIdx.y; job < STP_NF * m * kPc; job += kQueueWarps) {
        const int q = job / (m * kPc), L = job / kPc % m;
        if (STP_NBR_MASK >> q & 1)
          band_mma::piece_to_plane<STP_MXU, H, TW, TW, TW>(plane(q, L, rp), sums + (q * m + L) * P, job % kPc,
                                                          threadIdx.x);
      }
      __syncthreads();
    }
#endif
#pragma unroll
    for (int l = 1; l <= m; ++l) {
      const int p = i - l;  // raw plane of this level's result
      const int xg = pmod(ox + p - s, a.gx);
      STP_C res[STP_NF][RI][CI];
#pragma unroll
      for (int r = 0; r < RI; ++r) {
#pragma unroll
        for (int c = 0; c < CI; ++c) {
          // every cell, the apron's too: outside the tile shrunk by l the
          // value is garbage that feeds only garbage, and the padding keeps
          // the reads of the tile's edge in bounds
          const int ty = ty0 + r, tz = tz0 + c * kThreadsZ;
          const int k = ty * TW + tz;
          auto ld = [&](int q, int dx, int dy, int dz) -> STP_C {
            if (dx < 0) return old_[q][l - 1][r][c];
            if (dx > 0) return nw[q][r][c];
            if (dz == 0 && r + dy >= 0 && r + dy < RI) return mid[q][l - 1][r + dy][c];
            return plane(q, l - 1, rp)[k + dy * TW + dz];
          };
          STP_C v[STP_NF];
#ifdef STP_NBR_MASK
          auto nb = [&](int q) -> STP_C { return sums[(q * m + l - 1) * P + k]; };
#endif
          stp_body(ld, STP_NB_ARG l, xg, pmod(oy + y0 + ty - s, a.gy), pmod(oz + c0 + tz - s, a.gz), v);
          if (l == m && p >= p_lo && (own >> (r * CI + c) & 1u))
            store_out<kSlabs>(a, bo, zbo, p, y0 + ty, c0 + tz, v);
#pragma unroll
          for (int q = 0; q < STP_NF; ++q) res[q][r][c] = v[q];
        }
      }
      // level l-1 slides by one plane; level l's plane i-l is the newest
#pragma unroll
      for (int q = 0; q < STP_NF; ++q) {
#pragma unroll
        for (int r = 0; r < RI; ++r)
#pragma unroll
          for (int c = 0; c < CI; ++c) {
            old_[q][l - 1][r][c] = mid[q][l - 1][r][c];
            mid[q][l - 1][r][c] = nw[q][r][c];
            nw[q][r][c] = res[q][r][c];
            if (l < m) plane(q, l, wp)[(ty0 + r) * TW + tz0 + c * kThreadsZ] = res[q][r][c];
          }
      }
    }
    // this plane's writes before the next plane's reads of them, and this
    // plane's reads of the other parity before the next plane overwrites it
    __syncthreads();
  }
}

#else  // the general form

constexpr int kTileY = 32;     // == STREAM_TILE_Y in ops/stream.py: output rows of a tile
constexpr int kThreadsY = 16;  // thread rows
constexpr int kThreads = kThreadsZ * kThreadsY;
constexpr int kQueueForm = 0;

template <int M>
constexpr size_t smem_bytes() {
  return (size_t)STP_NF * (2 * M + 2 + kNbrPlanes) * (kTileY + 2 * M) * kTileW * sizeof(STP_C);
}

template <int M>
constexpr int tile_rows() {
  return kTileY;
}

template <int M, bool kSlabs, class A>
__global__ void __launch_bounds__(kThreads) wavefront(A a) {
  extern __shared__ STP_C smem[];
  constexpr int m = M;
  constexpr int H = kTileY + 2 * m;
  constexpr int TW = kTileW;
  constexpr int TZ = kTileW - 2 * m;  // output columns per tile
  constexpr int P = H * TW;
  constexpr int NS = 2 * m + 2;       // planes per field
  constexpr int kRowIters = (H + kThreadsY - 1) / kThreadsY;
  constexpr int kColIters = (TW + kThreadsZ - 1) / kThreadsZ;
  const int s = a.s;
  const int b = blockIdx.z / a.nchunks;
  const int chunk = blockIdx.z - b * a.nchunks;
  const int p_lo = s + chunk * a.xchunk;
  const int p_hi = min(p_lo + a.xchunk, a.Xr - s);
  // tile cell (0, 0) at row y0, column c0; >= 0 since s >= m
  const int y0 = s + blockIdx.y * kTileY - m;
  const int c0 = s + blockIdx.x * TZ - m;
  const int Yr = a.Yr, W = a.W;
  const int64_t plane_cells = (int64_t)Yr * a.Zr;
  const int64_t zplane = (int64_t)2 * s * Yr;
  const int64_t bo = (int64_t)b * a.Xr * plane_cells;
  const int64_t zbo = (int64_t)b * a.Xr * zplane;
  const int ox = a.origins[3 * b], oy = a.origins[3 * b + 1], oz = a.origins[3 * b + 2];
  const int tz0 = threadIdx.x, ty0 = threadIdx.y;
#ifdef STP_NBR_MASK
  float* const sums = smem + STP_NF * NS * P;  // the sums of field q's centre plane
#endif

  // level-0 plane i of this thread's tile cells, into registers as loaded:
  // issued one plane ahead, so the loads fly while the levels of the plane
  // before run
  STP_P pre[STP_NF][kRowIters][kColIters];
  auto fetch = [&](int i) {
    const int64_t xo = bo + (int64_t)i * plane_cells, zxo = zbo + (int64_t)i * zplane;
#pragma unroll
    for (int r = 0; r < kRowIters; ++r) {
#pragma unroll
      for (int c = 0; c < kColIters; ++c) {
        const int ty = ty0 + r * kThreadsY, tz = tz0 + c * kThreadsZ;
#pragma unroll
        for (int q = 0; q < STP_NF; ++q)
          pre[q][r][c] = ty < H && tz < TW ? level0<kSlabs>(a, q, b, i, xo, zxo, y0 + ty, c0 + tz) : STP_P(0.0f);
      }
    }
  };

  // slot bookkeeping (the same in every thread and field): older[l] / newer[l]
  // hold the two most recent level-l planes; `in_slot` takes the next load,
  // `spare` the next level's result
  int older[m], newer[m];
#pragma unroll
  for (int l = 0; l < m; ++l) {
    older[l] = 2 * l;
    newer[l] = 2 * l + 1;
  }
  int in_slot = 2 * m, spare = 2 * m + 1;

  // output plane p = i - m needs level-0 planes p-m .. p+m
  const int i0 = p_lo - m;
  const int i_end = p_hi + m;
  fetch(i0);
  for (int i = i0; i < i_end; ++i) {
#pragma unroll
    for (int q = 0; q < STP_NF; ++q) {
      STP_C* dst = smem + (q * NS + in_slot) * P;
#pragma unroll
      for (int r = 0; r < kRowIters; ++r) {
#pragma unroll
        for (int c = 0; c < kColIters; ++c) {
          const int ty = ty0 + r * kThreadsY, tz = tz0 + c * kThreadsZ;
          if (ty < H && tz < TW) dst[ty * TW + tz] = STP_UP(q, pre[q][r][c]);
        }
      }
    }
    __syncthreads();
    if (i + 1 < i_end) fetch(i + 1);
    int cur = in_slot;  // the level-(l-1) plane i-l+1
#pragma unroll
    for (int l = 1; l <= m; ++l) {
      const int p = i - l;  // raw plane of this level's result
      const int xg = pmod(ox + p - s, a.gx);
      const bool last = l == m;
      const int s_old = older[l - 1], s_new = newer[l - 1];
#ifdef STP_NBR_MASK
      {  // the centre, level l-1 at plane i-l, into the planes of sums
        constexpr int kPc = band_mma::kPieces<H, TW>;
        for (int job = threadIdx.y; job < STP_NF * kPc; job += kThreadsY) {
          const int q = job / kPc;
          if (STP_NBR_MASK >> q & 1)
            band_mma::piece_to_plane<STP_MXU, H, TW, TW, TW>(smem + (q * NS + s_new) * P, sums + q * P, job % kPc,
                                                            threadIdx.x);
        }
        __syncthreads();
      }
#endif
#pragma unroll
      for (int r = 0; r < kRowIters; ++r) {
#pragma unroll
        for (int c = 0; c < kColIters; ++c) {
          const int ty = ty0 + l + r * kThreadsY, tz = tz0 + l + c * kThreadsZ;
          if (ty >= H - l || tz >= TW - l) continue;
          const int k = ty * TW + tz;
          const int y = y0 + ty, col = c0 + tz;
          auto ld = [&](int q, int dx, int dy, int dz) -> STP_C {
            const int slot = dx < 0 ? s_old : (dx == 0 ? s_new : cur);
            return smem[(q * NS + slot) * P + k + dy * TW + dz];
          };
          STP_C v[STP_NF];
#ifdef STP_NBR_MASK
          auto nb = [&](int q) -> STP_C { return sums[q * P + k]; };
#endif
          stp_body(ld, STP_NB_ARG l, xg, pmod(oy + y - s, a.gy), pmod(oz + col - s, a.gz), v);
          if (!last) {
#pragma unroll
            for (int q = 0; q < STP_NF; ++q) smem[(q * NS + spare) * P + k] = v[q];
            continue;
          }
          if (p < p_lo || y >= Yr - s || col >= W - s) continue;
          store_out<kSlabs>(a, bo, zbo, p, y, col, v);
        }
      }
      __syncthreads();
      // level l-1 slides by one plane; level l's plane i-l is in `spare`; the
      // dropped level-(l-1) plane's slot is free
      older[l - 1] = s_new;
      newer[l - 1] = cur;
      cur = spare;
      spare = s_old;
    }
    in_slot = cur;  // level m wrote no plane here: the slot is free
  }
}

#endif  // STP_X_QUEUE

// The launch of one form: shared memory, blocks an SM and the x chunking.
struct Plan {
  int queue, blocks_per_sm, sms, blocks, xchunk, nchunks, smem, threads, tiles_z, tiles_y;
};

template <int M, bool kSlabs, class A>
int plan_launch(int n, int Xr, int Yr, int W, int s, Plan* pl) {
  constexpr int TZ = kTileW - 2 * M;
  const size_t smem = smem_bytes<M>();
  cudaError_t err = cudaFuncSetAttribute(wavefront<M, kSlabs, A>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 132, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wavefront<M, kSlabs, A>, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return -1;
  const int ix = Xr - 2 * s, iy = Yr - 2 * s, iz = W - 2 * s;
  const int ty = tile_rows<M>();
  pl->tiles_z = (iz + TZ - 1) / TZ;
  pl->tiles_y = (iy + ty - 1) / ty;
  const int64_t tiles = (int64_t)pl->tiles_z * pl->tiles_y * n;
  const int64_t resident = (int64_t)per_sm * sms;
  // the chunk count whose blocks fill whole waves best: waves x planes a
  // block marches (its chunk and the 2m-plane ramp); ties to fewer blocks
  int64_t best = -1;
  for (int want = 1; want <= ix; ++want) {
    const int xchunk = (ix + want - 1) / want;
    const int nchunks = (ix + xchunk - 1) / xchunk;
    if (nchunks != want || (int64_t)n * nchunks > 65535) continue;
    const int64_t waves = (tiles * nchunks + resident - 1) / resident;
    const int64_t cost = waves * (xchunk + 2 * M);
    if (best < 0 || cost < best) {
      best = cost;
      pl->xchunk = xchunk;
      pl->nchunks = nchunks;
    }
  }
  if (best < 0) return -1;
  pl->queue = kQueueForm;
  pl->blocks_per_sm = per_sm;
  pl->sms = sms;
  pl->blocks = (int)(tiles * pl->nchunks);
  pl->smem = (int)smem;
  pl->threads = kThreads;
  return 0;
}

template <int M, bool kSlabs, class A>
int launch(A a, int n, cudaStream_t stream) {
  Plan pl;
  const int rc = plan_launch<M, kSlabs, A>(n, a.Xr, a.Yr, a.W, a.s, &pl);
  if (rc != 0) return rc;
  a.xchunk = pl.xchunk;
  a.nchunks = pl.nchunks;
  dim3 grid(pl.tiles_z, pl.tiles_y, n * pl.nchunks);
  dim3 block(kThreadsZ, kThreads / kThreadsZ);
  wavefront<M, kSlabs, A><<<grid, block, pl.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

bool bad_args(int n, int Xr, int Yr, int Zr, int W, int m, int s, int gx, int gy, int gz) {
  return m != STP_M || m > s || n < 1 || 2 * s >= Xr || 2 * s >= Yr || 2 * s >= W || W > Zr || gx < 1 ||
         gy < 1 || gz < 1;
}

void fill_args(Args& a, void* const* raw, void* const* out, const int* origins, int Xr, int Yr, int Zr, int W,
               int s, int gx, int gy, int gz) {
  for (int q = 0; q < STP_NF; ++q) {
    a.raw[q] = static_cast<const STP_S*>(raw[q]);
    a.out[q] = static_cast<STP_S*>(out[q]);
    a.zs[q] = nullptr;
    a.zout[q] = nullptr;
  }
  a.origins = origins;
  a.Xr = Xr;
  a.Yr = Yr;
  a.Zr = Zr;
  a.W = W;
  a.s = s;
  a.gx = gx;
  a.gy = gy;
  a.gz = gz;
  a.xchunk = a.nchunks = 0;
}

int plan_info(const Plan& pl, int* info) {
  const int v[10] = {pl.queue, pl.blocks_per_sm, pl.sms, pl.blocks, pl.xchunk, pl.nchunks, pl.smem,
                     pl.threads, pl.tiles_z, pl.tiles_y};
  for (int j = 0; j < 10; ++j) info[j] = v[j];
  return 0;
}

}  // namespace

extern "C" {

#ifndef STP_FUSED

// raw/out (and zs/zout with slabs = 1): host arrays of STP_NF device
// pointers; origins: (n, 3) int32 on the device.  Returns a CUDA error code,
// or -1 for arguments the kernel does not take.
int stp_stream_wavefront(void* const* raw, void* const* out, void* const* zs, void* const* zout,
                         const int* origins, int n, int Xr, int Yr, int Zr, int W, int m, int s,
                         int gx, int gy, int gz, int slabs, void* stream) {
  if (bad_args(n, Xr, Yr, Zr, W, m, s, gx, gy, gz) || (slabs && (zs == nullptr || zout == nullptr))) return -1;
  Args a;
  fill_args(a, raw, out, origins, Xr, Yr, Zr, W, s, gx, gy, gz);
  for (int q = 0; q < STP_NF && slabs; ++q) {
    a.zs[q] = static_cast<const STP_S*>(zs[q]);
    a.zout[q] = static_cast<STP_S*>(zout[q]);
  }
  cudaStream_t st = (cudaStream_t)stream;
  return slabs ? launch<STP_M, true>(a, n, st) : launch<STP_M, false>(a, n, st);
}

// The launch stp_stream_wavefront makes for these arguments, into info[10]:
// form (1 register queue, 0 general), blocks an SM, SMs, blocks, x chunk,
// chunks, shared memory bytes, threads a block, tiles along z and y.
// Returns what the launch would.
int stp_stream_wavefront_plan(int n, int Xr, int Yr, int Zr, int W, int m, int s, int slabs, int* info) {
  if (bad_args(n, Xr, Yr, Zr, W, m, s, 1, 1, 1)) return -1;
  Plan pl;
  const int rc = slabs ? plan_launch<STP_M, true, Args>(n, Xr, Yr, W, s, &pl)
                       : plan_launch<STP_M, false, Args>(n, Xr, Yr, W, s, &pl);
  return rc != 0 ? rc : plan_info(pl, info);
}

#else

// The fused form: raw/out as stp_stream_wavefront's plain form (W = Zr);
// xb/yb/zb host arrays of STP_NF device pointers to the shell buffers
// (layouts above).
int stp_stream_wavefront_fused(void* const* raw, void* const* xb, void* const* yb, void* const* zb,
                               void* const* out, const int* origins, int n, int Xr, int Yr, int Zr, int m, int s,
                               int gx, int gy, int gz, void* stream) {
  if (bad_args(n, Xr, Yr, Zr, Zr, m, s, gx, gy, gz)) return -1;
  FusedArgs a;
  fill_args(a, raw, out, origins, Xr, Yr, Zr, Zr, s, gx, gy, gz);
  for (int q = 0; q < STP_NF; ++q) {
    a.xb[q] = static_cast<const STP_S*>(xb[q]);
    a.yb[q] = static_cast<const STP_S*>(yb[q]);
    a.zb[q] = static_cast<const STP_S*>(zb[q]);
  }
  return launch<STP_M, false>(a, n, (cudaStream_t)stream);
}

// The launch stp_stream_wavefront_fused makes, as stp_stream_wavefront_plan
// (W = Zr; slabs must be 0).
int stp_stream_wavefront_plan(int n, int Xr, int Yr, int Zr, int W, int m, int s, int slabs, int* info) {
  if (bad_args(n, Xr, Yr, Zr, W, m, s, 1, 1, 1) || W != Zr || slabs) return -1;
  Plan pl;
  const int rc = plan_launch<STP_M, false, FusedArgs>(n, Xr, Yr, W, s, &pl);
  return rc != 0 ? rc : plan_info(pl, info);
}

#endif  // STP_FUSED

const char* stp_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
