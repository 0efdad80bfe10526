// The Jacobi register-queue kernel for Hopper (sm_90a), bound to Python
// through ctypes (stencil_tpu_torch/kernels/build.py,
// stencil_tpu_torch/ops/jacobi_kernels.py, ops/plane_stencil.py).  One kernel
// body serves the six TPU kernels it replaces:
//
//   stencil_tpu/ops/jacobi_pallas.py:983  jacobi_shell_wavefront_step
//     m levels over an s-shelled (Xr, Yr, Zr) block; z columns [0, s) and
//     [z_valid - s, z_valid) optionally from a z-major (Xr, 2s, Yr) slab
//     buffer, and then the next slabs emitted (forms kShellSlabs, kShell);
//   stencil_tpu/ops/jacobi_pallas.py:1204 jacobi_zring_wavefront_step
//     m levels over an (Xr, Yr, Zi) block with no z shell in the array, the
//     z halo from the slab buffer, d2 in the (Yr, Zi + 128) ring layout
//     (form kRingForm);
//   stencil_tpu/ops/jacobi_pallas.py:869  jacobi_wrap_step
//     k levels over the whole periodic (X, Y, Z) domain (form kWrapForm,
//     exported as stp_jacobi_wrap): no shell and no slabs, every level-0
//     index read modulo its axis, d2 = (y - Y/2)^2 + (z - Z/2)^2 computed
//     in the kernel, the last level written to all of (X, Y, Z);
//   stencil_tpu/ops/jacobi_pallas.py:1484 jacobi_plane_step
//     one level over n radius-1 shell-carrying blocks (n, X, Y, Z) (form
//     kPlaneForm, exported as stp_jacobi_plane): a march of depth 1 over
//     the raw plane, as kShell with s = 1, d2 over the (Y - 2, Z - 2)
//     interior; the shell passes through: the thread that owns a ring row
//     or column (the first and last tile's apron) stores its level-0
//     value, and the first and last chunk store all of planes 0 and X - 1,
//     so `out` is written whole;
//   stencil_tpu/ops/jacobi_pallas.py:1347 jacobi_slab_step
//     one level over n bare interiors (n, X, Y, Z) (form kSlabForm,
//     exported as stp_jacobi_slab): a march of depth 1 whose tile origin
//     lies at -1 in y and z, as in the wrap form, and whose level-0 fetch
//     at plane -1 / X reads the x face slabs xlo / xhi (n, Y, Z), at row
//     -1 / Y the y slabs (n, X, Z) and at column -1 / Z the z slabs
//     (n, X, Y) (kept (X, Y), not the TPU's transposed layout); apron
//     corners, which one level never reads, load 0;
//   stencil_tpu/ops/plane_stencil.py:20   mean6_shell_wavefront_step
//     m <= s mean-of-6 levels over an s-shelled (Xr, Yr, Zr) block (form
//     kMean6Form, exported as stp_mean6_march): kShell without the sphere
//     clamp, compiled out, so no d2 and no origins are read; valid on the
//     interior [s, ext - s), the only region written.
//
// Layout.  A block works on a "logical plane" of width W: the raw columns
// (shell forms: W = z_valid) or low halo | interior | high halo (ring form:
// W = Zi + 2s, logical column c = raw column c - s).  The TPU kernels' lane
// ring (hi halo at lanes [0,s), lo halo at [128-s,128)) is a TPU layout
// trick; only the d2 indexing follows it here.
//
// The register-queue design.  A block owns a tile of kQRows x kQCols cells
// (32 x 64, its apron of d cells a side included, d the march's depth) for
// one block b and one chunk of output x planes, and marches x: per step it
// loads level-0 plane i and computes level l of plane i-l for l = 1..d, so
// level d lands on the tile shrunk by d.  The Jacobi body reads x-1 and x+1
// only at the cell itself, so a thread keeps its own cells' level-(l-1)
// planes p-1 and p in registers (with p+1, just computed, a queue three
// planes long), and only plane p of each level below d goes to shared
// memory, for the in-plane neighbours, double-buffered by the parity of the
// march: ONE block barrier a plane.  A block is 8 warps; a thread owns four
// consecutive rows of two columns 32 apart, and a y neighbour inside its
// rows comes from its registers, so a cell and level costs 3.5 shared
// accesses (two z neighbours, half a y neighbour, one store).  Its d2
// values sit in registers, loaded once a block; the clamp (hot, then cold)
// runs only on planes a sphere reaches.
// Every tile cell runs every level, its apron's too: outside the tile
// shrunk by l the value is garbage that feeds only garbage, and padding
// around the planes keeps the edge's reads in bounds.  The next plane's
// global loads are issued into registers before the current plane's levels
// run.  This is stream_wavefront.cu's queue form with the Jacobi body.
//
// Depth.  The queue holds 2d words a cell, so at d = 8 the registers of an
// SM hold ~2,000 cells and a 2d apron eats most of the tile.
// So m levels run as marches of at most kSubDepth = 4 levels: m <= 4 is one
// march; m in 5..8 is two, the first of ceil(m/2) levels writing the
// intermediate level, on the region its successor reads, to an (n, Xr, Yr,
// W) f32 scratch that the wrapper allocates through torch's allocator; the
// second reads it and writes the output and the slabs.  Each cell's levels
// are the same operations on the same values, so the result is the one
// pass's bit for bit: the port keeps what the TPU kernel computes (m levels
// from one read of the input), not its schedule.  A call is one launch of
// the wrapper (its `launches` counter) and one or two kernel launches.
//
// The wrap form.  k levels run as ceil(k/4) marches of at most 4 levels, as
// even as can be and the deeper first (k = 5: 3 + 2; 8: 4 + 4; 12: 4 + 4 +
// 4; wrap_depth), ping-ponging between the output and one (X, Y, Z) f32
// scratch so that the last march writes the output and no march reads the
// buffer it writes.  Each march is a periodic pass of its depth d: its
// tiles cover [0, Y) x [0, Z) with their apron around them, so a tile's
// origin lies below 0 and its apron past the plane's end; every level-0
// read takes its plane, row and column modulo X, Y and Z (an axis shorter
// than the apron wraps more than once), and a chunk of output planes
// [p_lo, p_hi) marches level-0 planes p_lo - d .. p_hi + d modulo X.  A
// cell of [0, X) x [0, Y) x [0, Z) is written by the one thread that owns
// it.  A call is one launch of the wrapper and ceil(k/4) kernel launches.
// Its bound is 8 B a cell a call whatever k (0.3205 ms at 512^3; two
// marches move it twice); at 512^3, k = 8 it took ~2.43 device ms a call on
// the H100, where eight one-level launches of six global loads a cell took
// ~5.1 (PERF.md).
//
// The one-level forms (plane, slab) replace one-thread-a-cell kernels of
// six global loads a cell that ran at 3.1-3.7x their bound (PERF.md): here
// a cell is loaded once, its x neighbours come from the queue and its
// in-plane ones from shared memory, and d2 is read once a block.  Their
// bound is the bytes of one read and one write of the block (plus the
// slabs and d2): 0.3287 ms at (8, 258^3), 0.3249 at (8, 256^3) with six
// slabs.  At 256 a side the 32 x 64 tile's 30 x 62 outputs cover 9 x 5
// tiles (1.28x the cells; its loads 1.41x).
//
// Shared memory.  2d planes of the tile and two rows of padding: 16,384 d +
// 544 bytes, 66,080 at d = 4.  The plan's model,
// wavefront_smem_bytes in ops/jacobi_kernels.py (the old design's
// (2m + 2) x (32 + 2m) x 64 x 4 bytes, 221,184 at m = 8), stays the depth
// plan; a static_assert holds every march below it, and the launch computes
// the size it asks.
//
// Grid.  The launch asks the occupancy calculator how many blocks fit an SM
// (two at d <= 4: 128 registers a thread, 16 warps an SM) and cuts x into
// chunks so that the blocks fill whole waves: the chunk count that minimises
// (waves) x (planes a block marches, its 2d-plane ramp included), among the
// counts that give at least kMinWaves = 4 waves of blocks where any does.
// stp_jacobi_wavefront_plan (and the wrap, plane and slab plans) report the
// choice.
//
// Three designs were timed on the H100 at the z-ring shape, m = 8 (PERF.md):
// one march of 8 levels in 16 warps of two rows (4.18-4.22 device ms a
// call), two marches of 4 in 16 warps of two rows at 64 registers a thread,
// which spill (3.05), and this one (2.41; 113-128 registers, up to 108 bytes
// of spill in the slab forms at d = 4); the earlier design took 4.47-4.51.
//
// Bound on an H100 SXM: bytes.  Per macro step of m levels the kernel must
// read the input and the slabs and write the output and the new slabs once
// (8 B/cell plus the thin slabs); two marches move those bytes twice.  What
// the tiles cost on top is the apron (32 x 64 over 24 x 56 at d = 4, 1.52x),
// each chunk's ramp, the shared-memory traffic and the issue of about a
// dozen instructions a cell and level.
//
// Cells outside the valid region (the apron beyond the plane's edge, which
// loads 0; planes before the march has filled the levels) hold garbage that
// only ever feeds other such cells, the shrinking-validity argument of the
// TPU kernel (jacobi_pallas.py:1034-1038): only the block interior
// [s, ext-s) of `out` and the interior x planes / y rows of `zout` are
// written (a first march: the region [s - d2, ext - s + d2) of the scratch,
// d2 the second march's depth).
//
// Bitwise contract with the JAX package: the six neighbours summed as a
// left fold in the TPU kernels' order x-1, x+1, y-1, y+1, z-1, z+1
// (jacobi_pallas.py:515-524, :1518-1525); the mean a multiply by the f32
// constant 0x1.555556p-3f, as XLA compiles `sum / 6.0` (an IEEE divide
// differs by 1 ulp on some cells); built without fast-math and with
// --fmad=false, so nothing contracts; the integer sphere test, hot then
// cold, d2 < in_r2 - (x_g - c)^2 with in_r2 = (gx/10 + 1)^2, gx the GLOBAL
// x extent and x_g = (origin_x + gx + p - s) mod gx for raw plane p, a
// non-negative modulo (skipped where the right side is <= 0: d2, a squared
// distance, is never negative).  Offsets are 64-bit.
//
// The mean-of-6 form is the Jacobi level without the clamp, summed in the
// same order (plane_stencil.py:188-195): m <= 4 is one march, m in 5..8 two
// through the scratch, as the shell form; so kMaxM = 8 is two marches of
// kSubDepth, not a shared-memory limit.  In the tensor-core builds its
// level is (x-1 + x+1) + (ysum + zsum), the JAX kernel's level_sum under an
// MXU unit (jacobi_pallas.py:498-510), the Jacobi contraction without the
// clamp.
//
// The kernel axes (jacobi_pallas.py:39-250) are builds of this file, each a
// library of its own (kernels/build.py VARIANTS, ops/jacobi_kernels.py
// library_name):
//
//   STP_JW_STORAGE=1 (bf16 storage, `f32_accumulate`): the block, the
//     output, the z slabs and the slab form's faces are bfloat16; a load
//     upcasts, every level and the scratch between marches are f32, and the
//     last march stores with __float2bfloat16_rn, one rounding a call as the
//     JAX kernel's final `astype` (jacobi_pallas.py:960-966).  The wrap
//     form's marches between the first and the last read and write f32
//     scratch buffers (two from three marches on), never the output.
//   STP_JW_UNIT=1 / 2 (compute_unit mxu or mxu_band; mxu_input f32 / bf16):
//     a level's in-plane sums run on the tensor cores.  A warp owns a 16 x
//     16 quarter of the tile in mma.sync's accumulator layout (rows r0 + g,
//     r0 + g + 8, columns c0 + 8q + 2t, + 1; g = lane / 4, t = lane % 4) and
//     contracts the level below, read from shared memory, against the band's
//     nonzeros: over y (A the band, B the plane) against the row chunks that
//     hold rows r0 - 1 .. r0 + 16, over z (A the plane, B the band) against
//     the column chunks that hold c0 - 1 .. c0 + 16, chunks inside the tile
//     only (the tile's edge is apron, whose values are garbage anyway;
//     csrc/band_mma.cuh holds the contraction, shared with the mean-of-6
//     plane kernel and the stream kernels' contraction form).  The
//     level is then (x-1 + x+1) + (ysum + zsum), as _make_level_sum sums it
//     (jacobi_pallas.py:498-526).  f32 operands: m16n8k8 TF32 on the plane
//     split exactly into three TF32 pieces with cvt.rna (hi, mid, and the
//     rest of at most 3 bits), lowest first, so that a sum of two cells is
//     the f32 sum up to the tensor core's rounding of its accumulation
//     (within tests/ulp.py's 4 ulps a level); bf16 operands: m16n8k16, the
//     plane rounded to nearest once a read.  The band's 0/1 entries are
//     exact either way; mxu and mxu_band share this contraction.  The
//     planes' rows are pitched at kMxuPitch = 72 cells so that the fragment
//     loads and stores meet each bank once; a zero band entry times a cell
//     outside a stencil is 0 only for a finite cell, and shells and scratch
//     cells no valid cell reads may hold anything, NaN or a finite value
//     whose sums overflow a level later, so these builds take a level-0
//     cell whose magnitude is not below FLT_MAX / 8 as 0 (kMxuLimit: every
//     sum of a level then stays finite).  No shared memory and no barrier
//     more than the vpu form.
//
//   STP_JW_STORAGE=2 (float64 fields, as the JAX kernels compute at the
//     block's dtype, jacobi_pallas.py:920, :1068, :1267): the block, the
//     output, the slabs, the faces, the scratch between marches, the shared
//     planes and every level of the register queue are double (`Work`), the
//     mean a multiply by the double reciprocal 0x1.5555555555555p-3, as XLA
//     compiles `sum / 6.0` at float64.  A double queue holds twice the
//     registers, so this build's marches are cut for one block an SM
//     (kQMinBlocks, 255 registers a thread) and ask twice the shared memory
//     (the plan's model prices 8-byte cells: wavefront_smem_bytes).  The
//     wrap form ping-pongs through a double scratch as the f32 build does.
//
// The default build (all 0) is the f32 vpu form above, unchanged.  The
// plane and slab forms are in the vpu builds only (f32, bf16 storage,
// float64); the mean-of-6 form is in every build; the tensor-core builds
// take f32 accumulators only.

#ifndef STP_JW_STORAGE
#define STP_JW_STORAGE 0
#endif
#ifndef STP_JW_UNIT
#define STP_JW_UNIT 0
#endif

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#if STP_JW_STORAGE == 1 || STP_JW_UNIT == 2
#include <cuda_bf16.h>
#endif
#if STP_JW_UNIT
#include "band_mma.cuh"
#endif

static_assert(STP_JW_STORAGE != 2 || STP_JW_UNIT == 0, "the tensor-core contraction takes f32 accumulators only");

namespace {

// --- the storage type: the fields' cells in memory, upcast at load; and the
// working type of the levels, the shared planes and the scratch ---------------

#if STP_JW_STORAGE == 1
using Store = __nv_bfloat16;
using Work = float;
__device__ __forceinline__ float up(Store v) { return __bfloat162float(v); }
__device__ __forceinline__ Store down(float v) { return __float2bfloat16_rn(v); }
#elif STP_JW_STORAGE == 2
using Store = double;
using Work = double;
__device__ __forceinline__ double up(double v) { return v; }
__device__ __forceinline__ double down(double v) { return v; }
#endif
__device__ __forceinline__ float up(float v) { return v; }
#if !STP_JW_STORAGE
using Store = float;
using Work = float;
__device__ __forceinline__ float down(float v) { return v; }
#endif
// a field pointer of the arguments (declared float) as the storage type
__device__ __forceinline__ const Store* sp(const float* p) { return reinterpret_cast<const Store*>(p); }
__device__ __forceinline__ Store* sp(float* p) { return reinterpret_cast<Store*>(p); }

#if STP_JW_STORAGE == 2
constexpr double kSixth = 0x1.5555555555555p-3;  // == np.float64(1) / 6
#else
constexpr float kSixth = 0x1.555556p-3f;  // == np.float32(1 / 6)
#endif
constexpr Work kHot = 1.0f;
constexpr Work kCold = 0.0f;
constexpr int kTileY = 32;  // == WAVEFRONT_TILE_Y in ops/jacobi_kernels.py
constexpr int kTileW = 64;  // == WAVEFRONT_TILE_W: tile columns with the apron
constexpr int kThreadsZ = 32;
constexpr int kRingOff = 128;  // == _ZRING_OFF
// the deepest m a wavefront call takes: two marches of kSubDepth levels
constexpr int kMaxM = 8;
constexpr int kFar = 1 << 30;  // d2 of cells off the plane: inside no sphere

__device__ __forceinline__ int pmod(int a, int n) {
  int r = a % n;
  return r < 0 ? r + n : r;
}

// --- the tensor-core contraction -------------------------------------------------

constexpr int kUnit = STP_JW_UNIT;  // 0 vpu, 1 tensor cores on TF32 pieces, 2 on bf16
constexpr bool kMxu = kUnit != 0;
constexpr int kMxuPitch = 72;  // == MXU_PITCH: the shared planes' row pitch in these builds
#if STP_JW_UNIT
// the largest level-0 magnitude these builds take (FLT_MAX / 8): six such
// values and their means never overflow, so no level is inf or NaN
constexpr float kMxuLimit = band_mma::kMxuLimit;
#else
constexpr float kMxuLimit = 0x1.fffffep+124f;
#endif

// --- the Jacobi wavefront: register-queue marches ------------------------------

constexpr int kQWarps = 8;     // thread rows
constexpr int kQRows = 32;     // tile rows with the apron: four a thread
constexpr int kQCols = 64;     // tile columns with the apron: two a lane, 32 apart
constexpr int kSubDepth = 4;   // the deepest march; == WAVEFRONT_SUB_DEPTH
constexpr int kQThreads = kThreadsZ * kQWarps;
// blocks an SM the registers are cut for: 128 a thread; the float64
// build's double queue takes one block an SM and up to 255 a thread
constexpr int kQMinBlocks = STP_JW_STORAGE == 2 ? 1 : 2;
constexpr int kMinWaves = 4;    // waves of blocks the x chunking asks for where it can
// cells before the first plane and after the last, so that a read at an
// in-plane offset from any tile cell stays inside the allocation
constexpr int kQPad = kQCols + 4;

enum Form { kRingForm = 0, kShellSlabs = 1, kShell = 2, kWrapForm = 3, kPlaneForm = 4, kSlabForm = 5, kMean6Form = 6 };

__host__ __device__ constexpr bool has_slabs(int form) { return form == kRingForm || form == kShellSlabs; }

struct QArgs {
  const float* raw;     // (n, Xr, Yr, Zraw)
  float* out;           // (n, Xr, Yr, Zraw)
  const int* origins;   // (n, 3)
  const int* d2;        // (n, Yr, d2_w)
  const float* zs;      // (n, Xr, 2s, Yr) or null
  float* zout;          // (n, Xr, 2s, Yr) or null
  const Work* src;      // a later march's input: the scratch (n, Xr, Yr, W)
  Work* dst;            // an earlier march's output: the scratch
  int Xr, Yr, Zraw;
  int W;                // logical plane width
  int s;                // interior offset (shell width)
  int o;                // this march writes planes, rows and logical columns [o, ext - o)
  int d2_w;
  int gx, hot_x, cold_x, in_r2;
  int xchunk, nchunks;  // output x planes per block, chunks per block b
};

// The slab form's arguments: QArgs and the six face slabs.  Only the slab
// form's kernel takes them: six more pointers in QArgs itself changed every
// other form's machine code and moved their times by 3-7% (PERF.md)
struct SlabArgs : QArgs {
  const float *xlo, *xhi;  // (n, Y, Z)
  const float *ylo, *yhi;  // (n, X, Z)
  const float *zlo, *zhi;  // (n, X, Y)
};

template <int kForm>
struct FormArgs {
  using type = QArgs;
};
template <>
struct FormArgs<kSlabForm> {
  using type = SlabArgs;
};

// the row pitch of the shared planes, in cells
constexpr int kPitch = kMxu ? kMxuPitch : kQCols;

template <int D>
constexpr size_t queue_smem() {
  return ((size_t)2 * D * kQRows * kPitch + 2 * kQPad) * sizeof(Work);
}

// the plan's model of a block's shared memory (wavefront_smem_bytes, cells
// of the working type), and what the tensor-core builds add to it
// (mxu_smem_extra_bytes): a march of depth d's 2d planes pitched at kMxuPitch
constexpr size_t plan_smem(int m) { return (size_t)(2 * m + 2) * (kTileY + 2 * m) * kTileW * sizeof(Work); }
constexpr size_t mxu_extra_smem(int d) { return (size_t)2 * d * kQRows * (kMxuPitch - kQCols) * 4; }

// A march's level-0 cells as loaded: the storage type from the block and
// the slabs, the working type from an earlier march's scratch.  The prefetch keeps them
// so and converts where the next plane uses them: a conversion at the load
// would wait on it and undo the prefetch (a bf16 build so lost 1.7-2.7x,
// PERF.md)
template <bool kFromScratch>
using Cell = std::conditional_t<kFromScratch, Work, Store>;

// Level-0 cell (y, c) of plane i of block b: the scratch of an earlier
// march, else the slab buffer for the z shell columns in the slab forms and
// the block for the rest; 0 past the plane's edge.  (The wrap form reads
// its planes in the kernel's fetch, every index modulo its axis.)
template <int kForm, bool kFromScratch>
__device__ __forceinline__ Cell<kFromScratch> load0(const QArgs& a, int64_t bi, int y, int c) {
  if (y >= a.Yr || c >= a.W) return Cell<kFromScratch>(0.0f);
  if (kFromScratch) return a.src[(bi * a.Yr + y) * a.W + c];
  const int s = a.s;
  if (has_slabs(kForm) && c < s) return sp(a.zs)[(bi * 2 * s + c) * a.Yr + y];
  if (has_slabs(kForm) && c >= a.W - s) return sp(a.zs)[(bi * 2 * s + s + c - (a.W - s)) * a.Yr + y];
  return sp(a.raw)[(bi * a.Yr + y) * a.Zraw + (kForm == kRingForm ? c - s : c)];
}

// The last level's value of cell (y, c) of plane p (bp = b * Xr + p): to the
// scratch, or to the output and, in the slab forms, to the emitted slabs
// (rows [0, s): top interior columns, the -z-bound message; rows [s, 2s):
// bottom interior columns, +z-bound).
template <int kForm, bool kToScratch>
__device__ __forceinline__ void store_last(const QArgs& a, int64_t bp, int y, int c, Work v) {
  if (kToScratch) {
    a.dst[(bp * a.Yr + y) * a.W + c] = v;
    return;
  }
  const int s = a.s;
  sp(a.out)[(bp * a.Yr + y) * a.Zraw + (kForm == kRingForm ? c - s : c)] = down(v);
  if (has_slabs(kForm)) {
    const int64_t zo = bp * 2 * s * a.Yr + y;
    if (c >= a.W - 2 * s) sp(a.zout)[zo + (int64_t)(c - (a.W - 2 * s)) * a.Yr] = down(v);
    if (c < 2 * s) sp(a.zout)[zo + (int64_t)c * a.Yr] = down(v);
  }
}

// d2 of cell (y, c), in the layout the wrapper was given; the wrap form's
// is yz_dist2_plane over the whole periodic plane, computed here
template <int kForm>
__device__ __forceinline__ int load_d2(const QArgs& a, const int* d2, int y, int c) {
  if (kForm == kWrapForm) {
    const int dy = pmod(y, a.Yr) - a.Yr / 2, dz = pmod(c, a.W) - a.W / 2;
    return dy * dy + dz * dz;
  }
  if (kForm == kPlaneForm) {  // (Yr - 2, W - 2) over the interior: the ring is never clamped
    if (y < 1 || c < 1 || y >= a.Yr - 1 || c >= a.W - 1) return kFar;
    return d2[(int64_t)(y - 1) * a.d2_w + c - 1];
  }
  if (kForm == kSlabForm && (y < 0 || c < 0)) return kFar;  // the slab form's apron at -1
  if (y >= a.Yr || c >= a.W) return kFar;
  const int col = kForm == kRingForm ? (c < a.W - a.s ? c - a.s + kRingOff : c - (a.W - a.s)) : c;
  return d2[(int64_t)y * a.d2_w + col];
}

// The slab form's level-0 cell (y, c) of plane i (-1 <= i <= X) of block b,
// as loaded: the block inside, a face slab one cell outside it, 0 elsewhere
// (apron corners and edges, which one level never reads, and cells past the
// face)
__device__ __forceinline__ Store load_slab(const SlabArgs& a, int b, int i, int y, int c) {
  const int X = a.Xr, Y = a.Yr, Z = a.W;
  const bool in_y = y >= 0 && y < Y, in_z = c >= 0 && c < Z;
  if (i < 0 || i >= X) return in_y && in_z ? sp(i < 0 ? a.xlo : a.xhi)[((int64_t)b * Y + y) * Z + c] : Store(0.0f);
  const int64_t bx = (int64_t)b * X + i;
  if (in_y && in_z) return sp(a.raw)[(bx * Y + y) * Z + c];
  if (in_z && (y == -1 || y == Y)) return sp(y < 0 ? a.ylo : a.yhi)[bx * Z + c];
  if (in_y && (c == -1 || c == Z)) return sp(c < 0 ? a.zlo : a.zhi)[bx * Y + y];
  return Store(0.0f);
}

#if STP_JW_UNIT
// The in-plane sums (ysum + zsum) of a warp's 16 x 16 quarter of the tile,
// rows r0.., columns c0.., of the level plane `p` (pitch kMxuPitch), into
// nb[r][q], this thread's cells in the accumulator layout: rows r0 + g +
// 8 (r / 2), columns c0 + 8q + 2t + r % 2 (csrc/band_mma.cuh).  Chunks of
// rows or columns outside the tile are skipped (the tile's edge is apron);
// the level-0 cells were cleaned at the load.
__device__ __forceinline__ void tile_sums(const float* p, int r0, int c0, int g, int t, float (&nb)[4][2]) {
  band_mma::piece_sums<kUnit, kQRows, kQCols, kMxuPitch, false>(p, r0, c0, g, t, nb);
}
#endif

// One march of D levels.  At D <= 4 the registers are cut so that two
// blocks fit an SM (128 a thread).
template <int D, int kForm, bool kFromScratch, bool kToScratch>
__global__ void __launch_bounds__(kQThreads, D <= 4 ? kQMinBlocks : 1)
    jacobi_queue(typename FormArgs<kForm>::type a) {
  extern __shared__ Work smem_all[];
  Work* const smem = smem_all + kQPad;
  constexpr int H = kQRows;
  constexpr int TW = kQCols;
  constexpr int TZ = TW - 2 * D;        // output columns per tile
  constexpr int P = H * kPitch;
  constexpr int RI = H / kQWarps;       // consecutive rows a thread owns
  constexpr int CI = TW / kThreadsZ;    // columns a thread owns, 32 apart
  constexpr bool kClamp = kForm != kMean6Form;  // the mean-of-6 form reads no d2 and no origins
  static_assert(!kMxu || (kForm != kPlaneForm && kForm != kSlabForm),
                "the tensor-core builds have the wavefront, wrap and mean-of-6 forms only");
  // plane of level L (< D) at march parity `par`
  auto plane = [&](int L, int par) -> Work* { return smem + (L * 2 + par) * P; };
  const int s = a.s, o = a.o;
  const int b = blockIdx.z / a.nchunks;
  const int chunk = blockIdx.z - b * a.nchunks;
  const int p_lo = o + chunk * a.xchunk;
  const int p_hi = min(p_lo + a.xchunk, a.Xr - o);
  // tile cell (0, 0) at row y0, logical column c0: >= 0 in the shell, ring
  // and plane forms since o >= D; below 0 in the wrap and slab forms (o =
  // 0), whose reads take every index modulo its axis (wrap) or from the
  // face slabs (slab) and whose owned cells (ty, tz >= D) lie at rows and
  // columns >= 0
  const int y0 = o + blockIdx.y * (H - 2 * D) - D;
  const int c0 = o + blockIdx.x * TZ - D;
  const int Yr = a.Yr, W = a.W;
  const int64_t bx = (int64_t)b * a.Xr;
  const int origin_x = kForm == kWrapForm || !kClamp ? 0 : a.origins[3 * b];
  const int tz0 = threadIdx.x, ty0 = threadIdx.y * RI;
  // the tensor-core builds: this warp's quarter of the tile (rows r0.., and
  // columns c0t..) and the lane's place in mma.sync's accumulator layout; a
  // thread's cell (r, q) is at row r0 + g + 8 (r / 2), column c0t + 8q + 2t
  // + r % 2 (tile_sums), where the vpu form's is at ty0 + r, tz0 + 32q
  const int r0 = 16 * (threadIdx.y >> 2), c0t = 16 * (threadIdx.y & 3), g = threadIdx.x >> 2, t = threadIdx.x & 3;
  auto cell_y = [&](int r) { return kMxu ? r0 + g + 8 * (r >> 1) : ty0 + r; };
  auto cell_z = [&](int r, int q) { return kMxu ? c0t + 8 * q + 2 * t + (r & 1) : tz0 + q * kThreadsZ; };
  // the same cell's row and logical column in the plane (the vpu form's
  // sums in the parent's order)
  auto row_of = [&](int r) { return kMxu ? y0 + (r0 + g + 8 * (r >> 1)) : y0 + ty0 + r; };
  auto col_of = [&](int r, int q) { return kMxu ? c0 + (c0t + 8 * q + 2 * t + (r & 1)) : c0 + tz0 + q * kThreadsZ; };
  // the cells whose last level this thread writes: inside the tile's
  // level-D region and the march's output region (bit r * CI + q); and
  // their d2, in registers for the whole march.  The plane form also
  // writes the shell ring (`ring`), from the tile whose apron holds it:
  // row 0 / column 0 the first tile's, row Yr - 1 / column W - 1 the last's
  unsigned own = 0, ring = 0;
  int d2r[RI][CI];
  const int* d2 = kClamp ? a.d2 + (int64_t)b * (kForm == kPlaneForm ? Yr - 2 : Yr) * a.d2_w : nullptr;
#pragma unroll
  for (int r = 0; r < RI; ++r)
#pragma unroll
    for (int q = 0; q < CI; ++q) {
      const int ty = cell_y(r), tz = cell_z(r, q);
      if constexpr (kForm == kPlaneForm) {
        const int y = y0 + ty, c = c0 + tz;
        const bool in_row = ty >= D && ty < H - D && y < Yr - o, in_col = tz >= D && tz < TW - D && c < W - o;
        const bool ring_row = y < o || (y >= Yr - o && y < Yr), ring_col = c < o || (c >= W - o && c < W);
        if ((in_row || ring_row) && (in_col || ring_col)) own |= 1u << (r * CI + q);
        if (ring_row || ring_col) ring |= 1u << (r * CI + q);
      } else if (ty >= D && ty < H - D && tz >= D && tz < TW - D && y0 + ty < Yr - o && c0 + tz < W - o) {
        own |= 1u << (r * CI + q);
      }
      if constexpr (kClamp) d2r[r][q] = load_d2<kForm>(a, d2, y0 + ty, c0 + tz);
    }

  // the wrap form's in-plane offsets of this thread's cells, row and column
  // modulo Y and Z (Y * Z < 2^31: the entry checks it); a column a cell in
  // the tensor-core builds
  constexpr int WC = kMxu ? RI * CI : CI;
  int wrow[RI], wcol[WC];
  if constexpr (kForm == kWrapForm) {
#pragma unroll
    for (int r = 0; r < RI; ++r) wrow[r] = pmod(row_of(r), Yr) * W;
#pragma unroll
    for (int j = 0; j < WC; ++j) wcol[j] = pmod(col_of(kMxu ? j / CI : 0, kMxu ? j % CI : j), W);
  }

  // output plane p = i - D needs level-0 planes p-D .. p+D (modulo X in the
  // wrap form)
  const int i0 = p_lo - D;
  const int i_end = p_hi + D;
  // level-0 plane i of this thread's cells, fetched one plane ahead as
  // loaded (``Cell``)
  Cell<kFromScratch> pre[RI][CI];
  auto fetch = [&](int i) {
    if constexpr (kForm == kWrapForm) {
      const Cell<kFromScratch>* pl;
      if constexpr (kFromScratch) {
        pl = a.src + (int64_t)pmod(i, a.Xr) * Yr * W;
      } else {
        pl = sp(a.raw) + (int64_t)pmod(i, a.Xr) * Yr * W;
      }
#pragma unroll
      for (int r = 0; r < RI; ++r)
#pragma unroll
        for (int q = 0; q < CI; ++q) pre[r][q] = pl[wrow[r] + wcol[kMxu ? r * CI + q : q]];
    } else if constexpr (kForm == kSlabForm) {
#pragma unroll
      for (int r = 0; r < RI; ++r)
#pragma unroll
        for (int q = 0; q < CI; ++q) pre[r][q] = load_slab(a, b, i, row_of(r), col_of(r, q));
    } else {
#pragma unroll
      for (int r = 0; r < RI; ++r)
#pragma unroll
        for (int q = 0; q < CI; ++q)
          pre[r][q] = load0<kForm, kFromScratch>(a, bx + i, row_of(r), col_of(r, q));
    }
  };
  // a level's plane of this thread's cells into shared memory, two
  // neighbouring columns at a time (the tensor-core builds)
  auto put = [&](Work* pl, const Work (&v)[RI][CI]) {
#pragma unroll
    for (int r = 0; r < RI; r += 2)
#pragma unroll
      for (int q = 0; q < CI; ++q)
        *reinterpret_cast<float2*>(&pl[cell_y(r) * kPitch + cell_z(r, q)]) = make_float2(v[r][q], v[r + 1][q]);
  };

  // the queue of level L < D at this thread's cells: old (plane j-1) and mid
  // (plane j, also in shared memory), j = i - L - 1 while plane i marches in;
  // nw holds the newest plane of the level below the one being computed
  Work old_[D][RI][CI], mid[D][RI][CI], nw[RI][CI];
#pragma unroll
  for (int L = 0; L < D; ++L)
#pragma unroll
    for (int r = 0; r < RI; ++r)
#pragma unroll
      for (int q = 0; q < CI; ++q) old_[L][r][q] = mid[L][r][q] = 0.0f;

  fetch(i0);
  for (int i = i0; i < i_end; ++i) {
    const int wp = i & 1, rp = wp ^ 1;  // this plane's buffers; the previous plane's
    // level 0 of plane i at the working type; the tensor-core builds take a cell whose
    // magnitude is not below kMxuLimit (inf and NaN too) as 0 (the header)
#pragma unroll
    for (int r = 0; r < RI; ++r)
#pragma unroll
      for (int q = 0; q < CI; ++q) {
        nw[r][q] = up(pre[r][q]);
        if (kMxu && !(fabsf(nw[r][q]) < kMxuLimit)) nw[r][q] = 0.0f;
        if (!kMxu) plane(0, wp)[(ty0 + r) * TW + tz0 + q * kThreadsZ] = up(pre[r][q]);
      }
    if (kMxu) put(plane(0, wp), nw);
    if (kForm == kPlaneForm && (i == 0 || i == a.Xr - 1)) {  // the shell planes pass through
#pragma unroll
      for (int r = 0; r < RI; ++r)
#pragma unroll
        for (int q = 0; q < CI; ++q)
          if (own >> (r * CI + q) & 1u)
            store_last<kForm, false>(a, bx + i, y0 + ty0 + r, c0 + tz0 + q * kThreadsZ, nw[r][q]);
    }
    if (i + 1 < i_end) fetch(i + 1);
#pragma unroll
    for (int l = 1; l <= D; ++l) {
      const int p = i - l;  // raw plane of this level's result
      int hot_lim = 0, cold_lim = 0;
      if constexpr (kClamp) {
        const int x_g = pmod(origin_x + a.gx + p - s, a.gx);
        hot_lim = a.in_r2 - (x_g - a.hot_x) * (x_g - a.hot_x);
        cold_lim = a.in_r2 - (x_g - a.cold_x) * (x_g - a.cold_x);
      }
      const bool spheres = kClamp && (hot_lim > 0 || cold_lim > 0);
      const Work* below = plane(l - 1, rp);  // level l-1, plane i-l
      Work res[RI][CI];
#if STP_JW_UNIT
      float nb[RI][CI];  // (y-1 + y+1) + (z-1 + z+1) of this thread's cells
      tile_sums(below, r0, c0t, g, t, nb);
#endif
#pragma unroll
      for (int r = 0; r < RI; ++r) {
#pragma unroll
        for (int q = 0; q < CI; ++q) {
#if STP_JW_UNIT
          float sum = old_[l - 1][r][q] + nw[r][q];  // x-1, x+1
          sum = sum + nb[r][q];
#else
          const int k = (ty0 + r) * TW + tz0 + q * kThreadsZ;
          Work sum = old_[l - 1][r][q] + nw[r][q];                         // x-1, x+1
          sum = sum + (r > 0 ? mid[l - 1][r - 1][q] : below[k - TW]);       // y-1
          sum = sum + (r + 1 < RI ? mid[l - 1][r + 1][q] : below[k + TW]);  // y+1
          sum = sum + below[k - 1];                                         // z-1
          sum = sum + below[k + 1];                                         // z+1
#endif
          Work v = sum * kSixth;
          if (spheres) {  // d2 >= 0: no clamp can fire on this plane otherwise
            if (d2r[r][q] < hot_lim) v = kHot;
            if (d2r[r][q] < cold_lim) v = kCold;
          }
          if (l == D && p >= p_lo && (own >> (r * CI + q) & 1u)) {
            // the plane form (D = 1) stores a ring cell's level 0 unchanged
            const bool keep = kForm == kPlaneForm && (ring >> (r * CI + q) & 1u);
            store_last<kForm, kToScratch>(a, bx + p, row_of(r), col_of(r, q),
                                          keep ? mid[0][r][q] : v);
          }
          res[r][q] = v;
        }
      }
      // level l-1 slides by one plane; level l's plane i-l is the newest
#pragma unroll
      for (int r = 0; r < RI; ++r)
#pragma unroll
        for (int q = 0; q < CI; ++q) {
          old_[l - 1][r][q] = mid[l - 1][r][q];
          mid[l - 1][r][q] = nw[r][q];
          nw[r][q] = res[r][q];
          if (!kMxu && l < D) plane(l, wp)[(ty0 + r) * TW + tz0 + q * kThreadsZ] = res[r][q];
        }
      if (kMxu && l < D) put(plane(l, wp), res);
    }
    // this plane's writes before the next plane's reads of them, and this
    // plane's reads of the other parity before the next plane overwrites it
    __syncthreads();
  }
}

// The launch of one march: shared memory, blocks an SM and the x chunking.
struct Plan {
  int blocks_per_sm, sms, blocks, xchunk, nchunks, smem, threads, tiles_z, tiles_y;
};

template <int D, int kForm, bool kFrom, bool kTo>
int march(typename FormArgs<kForm>::type a, int n, cudaStream_t stream, Plan* plan_only) {
  constexpr int TZ = kQCols - 2 * D, TY = kQRows - 2 * D;
  constexpr size_t smem = queue_smem<D>();
  static_assert(smem <= plan_smem(D) + (kMxu ? mxu_extra_smem(D) : 0),
                "a march asks more shared memory than the plan's model");
  static_assert((kForm != kPlaneForm && kForm != kSlabForm) || D == 1, "the one-level forms march depth 1");
  cudaError_t err = cudaFuncSetAttribute(jacobi_queue<D, kForm, kFrom, kTo>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 132, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, jacobi_queue<D, kForm, kFrom, kTo>, kQThreads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return -1;
  const int o = a.o;
  const int ix = a.Xr - 2 * o, iy = a.Yr - 2 * o, iz = a.W - 2 * o;
  Plan pl;
  pl.tiles_z = (iz + TZ - 1) / TZ;
  pl.tiles_y = (iy + TY - 1) / TY;
  if (pl.tiles_y > 65535) return -1;
  const int64_t tiles = (int64_t)pl.tiles_z * pl.tiles_y * n;
  const int64_t resident = (int64_t)per_sm * sms;
  // the chunk count whose blocks fill whole waves best: waves x planes a
  // block marches (its chunk and the 2D-plane ramp); ties to fewer blocks.
  // A count with fewer than kMinWaves waves of blocks is taken only where
  // none has more: a grid of one wave or less leaves too few loads in
  // flight (PERF.md: the slab form at one chunk, 0.91 waves, took 17% longer
  // than at eight)
  int64_t best = -1;
  bool best_full = false;
  for (int want = 1; want <= ix; ++want) {
    const int xchunk = (ix + want - 1) / want;
    const int nchunks = (ix + xchunk - 1) / xchunk;
    if (nchunks != want || (int64_t)n * nchunks > 65535) continue;
    const int64_t waves = (tiles * nchunks + resident - 1) / resident;
    const int64_t cost = waves * (xchunk + 2 * D);
    const bool full = tiles * nchunks >= kMinWaves * resident;
    if (best < 0 || (full && !best_full) || (full == best_full && cost < best)) {
      best = cost;
      best_full = full;
      pl.xchunk = xchunk;
      pl.nchunks = nchunks;
    }
  }
  if (best < 0) return -1;
  pl.blocks_per_sm = per_sm;
  pl.sms = sms;
  pl.blocks = (int)(tiles * pl.nchunks);
  pl.smem = (int)smem;
  pl.threads = kQThreads;
  if (plan_only != nullptr) {
    *plan_only = pl;
    return 0;
  }
  a.xchunk = pl.xchunk;
  a.nchunks = pl.nchunks;
  dim3 grid(pl.tiles_z, pl.tiles_y, n * pl.nchunks);
  jacobi_queue<D, kForm, kFrom, kTo><<<grid, dim3(kThreadsZ, kQWarps), smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// A march of depth D (<= kSubDepth) in one form: from the block or the
// scratch, to the scratch or the output.
template <int D, int kForm>
int march_io(const QArgs& a, int n, bool from, bool to, cudaStream_t st, Plan* pl) {
  if (from) return march<D, kForm, true, false>(a, n, st, pl);
  if (to) return march<D, kForm, false, true>(a, n, st, pl);
  return march<D, kForm, false, false>(a, n, st, pl);
}

template <int D>
int march_form(const QArgs& a, int n, int form, bool from, bool to, cudaStream_t st, Plan* pl) {
#if STP_JW_STORAGE == 1
  // bf16 storage: the wrap form's marches read and write f32 scratch between
  // the first and the last
  if (form == kWrapForm && from && to) return march<D, kWrapForm, true, true>(a, n, st, pl);
  if (form == kWrapForm) return march_io<D, kWrapForm>(a, n, from, to, st, pl);
#else
  if (form == kWrapForm) return march<D, kWrapForm, false, false>(a, n, st, pl);  // buffer to buffer
#endif
  if (form == kRingForm) return march_io<D, kRingForm>(a, n, from, to, st, pl);
  if (form == kShellSlabs) return march_io<D, kShellSlabs>(a, n, from, to, st, pl);
  if (form == kMean6Form) return march_io<D, kMean6Form>(a, n, from, to, st, pl);
  return march_io<D, kShell>(a, n, from, to, st, pl);
}

static_assert(kSubDepth == 4 && 2 * kSubDepth >= kMaxM, "run_march dispatches depths 1..4; two marches reach kMaxM");

int run_march(const QArgs& a, int n, int depth, int form, bool from, bool to, cudaStream_t st, Plan* pl) {
  switch (depth) {
    case 1: return march_form<1>(a, n, form, from, to, st, pl);
    case 2: return march_form<2>(a, n, form, from, to, st, pl);
    case 3: return march_form<3>(a, n, form, from, to, st, pl);
    case 4: return march_form<4>(a, n, form, from, to, st, pl);
    default: return -1;
  }
}

// the first march's depth: all m levels, or the deeper half of two marches
int first_depth(int m) { return m <= kSubDepth ? m : (m + 1) / 2; }

// The wrap form: k levels as ceil(k/4) marches, the depth of march j (as
// even as can be, the deeper first; == wrap_march_depths in
// ops/jacobi_kernels.py)
int wrap_marches(int k) { return (k + kSubDepth - 1) / kSubDepth; }
int wrap_depth(int k, int j) {
  const int q = wrap_marches(k);
  return k / q + (j < k % q ? 1 : 0);
}

// 1 <= k <= max(1, X // 2), the JAX kernel's contract; in-plane offsets fit int
bool bad_wrap_args(int X, int Y, int Z, int k) {
  return X < 1 || Y < 1 || Z < 1 || k < 1 || k > (X / 2 > 1 ? X / 2 : 1) || (int64_t)Y * Z > INT32_MAX;
}

// The wrap form's arguments for one march from `src` to `dst`: origin 0,
// no shell (s = o = 0), gx = X, the plane's width Z
QArgs wrap_args(const float* src, float* dst, int X, int Y, int Z, int hot_x, int cold_x, int in_r2) {
  QArgs a{};
  a.raw = src;
  a.out = dst;
  a.Xr = X;
  a.Yr = Y;
  a.Zraw = a.W = a.d2_w = Z;
  a.gx = X;
  a.hot_x = hot_x;
  a.cold_x = cold_x;
  a.in_r2 = in_r2;
  return a;
}

#if !STP_JW_UNIT
// The one-level forms' arguments: the plane form (s = o = 1, d2 over the
// (Y - 2, Z - 2) interior) takes X, Y, Z >= 3, the slab form (s = o = 0,
// d2 over (Y, Z)) X >= 2, the JAX kernels' contracts
bool bad_onelevel_args(int form, int n, int X, int Y, int Z, int gx) {
  const int least = form == kPlaneForm ? 3 : 1;
  return n < 1 || n > 65535 || X < (form == kPlaneForm ? 3 : 2) || Y < least || Z < least || gx < 1;
}

QArgs onelevel_args(int form, int X, int Y, int Z, int gx, int hot_x, int cold_x, int in_r2) {
  QArgs a{};
  a.Xr = X;
  a.Yr = Y;
  a.Zraw = a.W = Z;
  a.s = a.o = form == kPlaneForm ? 1 : 0;
  a.d2_w = form == kPlaneForm ? Z - 2 : Z;
  a.gx = gx;
  a.hot_x = hot_x;
  a.cold_x = cold_x;
  a.in_r2 = in_r2;
  return a;
}

// the plan of a one-level form into info[9]: blocks an SM, SMs, blocks, x
// chunk, chunks, shared memory bytes, threads a block, tiles along z and y
int onelevel_plan(int form, int n, int X, int Y, int Z, int* info) {
  if (bad_onelevel_args(form, n, X, Y, Z, 1)) return -1;
  const QArgs a = onelevel_args(form, X, Y, Z, 1, 0, 0, 0);
  Plan pl;
  const int rc = form == kPlaneForm ? march<1, kPlaneForm, false, false>(a, n, nullptr, &pl)
                                    : march<1, kSlabForm, false, false>(SlabArgs{a}, n, nullptr, &pl);
  if (rc != 0) return rc;
  const int w[9] = {pl.blocks_per_sm, pl.sms, pl.blocks, pl.xchunk, pl.nchunks, pl.smem, pl.threads,
                    pl.tiles_z, pl.tiles_y};
  for (int j = 0; j < 9; ++j) info[j] = w[j];
  return 0;
}
#endif

bool bad_jacobi_args(int n, int Xr, int Yr, int Zraw, int W, int m, int s, int gx, bool ring, bool slabs) {
  return m < 1 || m > kMaxM || m > s || n < 1 || n > 65535 || 2 * s >= Xr || 2 * s >= Yr || 2 * s >= W ||
         gx < 1 || (ring && !slabs) || (ring ? W != Zraw + 2 * s || 2 * s > kRingOff : W > Zraw);
}

// m levels in one form (a.o == a.s): one march, or two through the scratch
// (n, Xr, Yr, W), the first writing the region the second reads: [s - d2,
// ext - s + d2), d2 the second march's depth
int run_levels(QArgs a, int n, int m, int form, Work* scratch, cudaStream_t st) {
  const int d1 = first_depth(m), d2_depth = m - d1;
  if (d2_depth == 0) return run_march(a, n, m, form, false, false, st, nullptr);
  if (scratch == nullptr) return -1;
  a.o = a.s - d2_depth;
  a.dst = scratch;
  const int rc = run_march(a, n, d1, form, false, true, st, nullptr);
  if (rc != 0) return rc;
  a.o = a.s;
  a.dst = nullptr;
  a.src = scratch;
  return run_march(a, n, d2_depth, form, true, false, st, nullptr);
}

// The launches run_levels makes, into info[11]: kernel launches (marches),
// the first march's depth, and that march's blocks an SM, SMs, blocks, x
// chunk, chunks, shared memory bytes, threads a block and tiles along z and y
int levels_plan(QArgs a, int n, int m, int form, int* info) {
  const int d1 = first_depth(m);
  a.o = a.s - (m - d1);
  Plan pl;
  const int rc = run_march(a, n, d1, form, false, d1 < m, nullptr, &pl);
  if (rc != 0) return rc;
  const int w[11] = {d1 < m ? 2 : 1, d1, pl.blocks_per_sm, pl.sms, pl.blocks, pl.xchunk, pl.nchunks,
                     pl.smem, pl.threads, pl.tiles_z, pl.tiles_y};
  for (int j = 0; j < 11; ++j) info[j] = w[j];
  return 0;
}

// The mean-of-6 form's arguments: the shell form's layout (W = Zr, o = s),
// no d2, origins or slabs
QArgs mean6_args(const float* raw, float* out, int Xr, int Yr, int Zr, int s) {
  QArgs a{};
  a.raw = raw;
  a.out = out;
  a.Xr = Xr;
  a.Yr = Yr;
  a.Zraw = a.W = Zr;
  a.s = a.o = s;
  return a;
}

}  // namespace

extern "C" {

// ring: 1 = jacobi_zring_wavefront_step (slabs required), 0 = the shell form
// (slabs optional: zs and zout both null or both set).  scratch: an
// (n, Xr, Yr, W) buffer of the working type (float; double in the float64
// build), required where m needs two marches
// (stp_jacobi_wavefront_plan's launches), else ignored.  Returns a CUDA
// error code, or -1 for arguments the kernel does not take.
int stp_jacobi_wavefront(const float* raw, float* out, const int* origins, const int* d2,
                         const float* zs, float* zout, Work* scratch, int n, int Xr, int Yr, int Zraw,
                         int W, int m, int s, int d2_w, int gx, int hot_x, int cold_x, int in_r2,
                         int ring, void* stream) {
  if ((zs == nullptr) != (zout == nullptr) ||
      bad_jacobi_args(n, Xr, Yr, Zraw, W, m, s, gx, ring, zs != nullptr))
    return -1;
  const int form = ring ? kRingForm : (zs != nullptr ? kShellSlabs : kShell);
  QArgs a{raw, out, origins, d2, zs, zout, nullptr, nullptr, Xr, Yr, Zraw, W, s, s, d2_w,
          gx, hot_x, cold_x, in_r2, 0, 0};
  return run_levels(a, n, m, form, scratch, (cudaStream_t)stream);
}

// The launches stp_jacobi_wavefront makes for these arguments, into
// info[12]: the form (0 ring, 1 shell with slabs, 2 shell), kernel launches
// a call (marches), the first march's depth, and that march's blocks an SM,
// SMs, blocks, x chunk, chunks, shared memory bytes, threads a block and
// tiles along z and y.  Returns what the launch would.
int stp_jacobi_wavefront_plan(int n, int Xr, int Yr, int Zraw, int W, int m, int s, int ring, int slabs,
                              int* info) {
  if (bad_jacobi_args(n, Xr, Yr, Zraw, W, m, s, 1, ring, slabs)) return -1;
  QArgs a{};
  a.Xr = Xr;
  a.Yr = Yr;
  a.Zraw = Zraw;
  a.W = W;
  a.s = s;
  info[0] = ring ? kRingForm : (slabs ? kShellSlabs : kShell);
  return levels_plan(a, n, m, info[0], info + 1);
}

// m <= s mean-of-6 levels over n s-shelled blocks (n, Xr, Yr, Zr), `raw` to
// `out` (apart): only the interior [s, ext - s) of `out` is written; under
// bf16 storage the levels run at f32 and the last rounds once.  scratch: an
// (n, Xr, Yr, Zr) buffer of the working type, required where m needs two marches
// (stp_mean6_march_plan's launches), else ignored.  Returns a CUDA error
// code, or -1 for arguments the kernel does not take.
int stp_mean6_march(const float* raw, float* out, Work* scratch, int n, int Xr, int Yr, int Zr, int m, int s,
                    void* stream) {
  if (bad_jacobi_args(n, Xr, Yr, Zr, Zr, m, s, 1, false, false) || raw == out) return -1;
  if (scratch != nullptr && ((const void*)scratch == raw || (void*)scratch == out)) return -1;
  return run_levels(mean6_args(raw, out, Xr, Yr, Zr, s), n, m, kMean6Form, scratch, (cudaStream_t)stream);
}

// The launches stp_mean6_march makes for these arguments, into info[11]:
// kernel launches a call (marches), the first march's depth, and that
// march's blocks an SM, SMs, blocks, x chunk, chunks, shared memory bytes,
// threads a block and tiles along z and y.  Returns what the launch would.
int stp_mean6_march_plan(int n, int Xr, int Yr, int Zr, int m, int s, int* info) {
  if (bad_jacobi_args(n, Xr, Yr, Zr, Zr, m, s, 1, false, false)) return -1;
  return levels_plan(mean6_args(nullptr, nullptr, Xr, Yr, Zr, s), n, m, kMean6Form, info);
}

// k periodic Jacobi levels over the whole (X, Y, Z) domain, `in` to `out`
// (in untouched): ceil(k/4) marches, ping-ponging through `scratch`, an (X,
// Y, Z) buffer of the block's type required where k needs more than one march
// (stp_jacobi_wrap_plan's launches), else ignored.  Under bf16 storage the
// levels between marches stay f32: march j > 0 reads scratch buffer (j - 1)
// % 2 and march j < q - 1 writes buffer j % 2, so `scratch` holds two (X, Y,
// Z) f32 buffers from three marches on.  Returns a CUDA error code, or -1
// for arguments the kernel does not take.
int stp_jacobi_wrap(const float* in, float* out, float* scratch, int X, int Y, int Z, int k, int hot_x,
                    int cold_x, int in_r2, void* stream) {
  if (bad_wrap_args(X, Y, Z, k)) return -1;
  const int q = wrap_marches(k);
  if (q > 1 && (scratch == nullptr || scratch == in || scratch == out)) return -1;
  if (in == out) return -1;
#if STP_JW_STORAGE == 1
  const int64_t cells = (int64_t)X * Y * Z;
  for (int j = 0; j < q; ++j) {
    QArgs a = wrap_args(in, out, X, Y, Z, hot_x, cold_x, in_r2);
    a.src = j > 0 ? scratch + (j - 1) % 2 * cells : nullptr;
    a.dst = j < q - 1 ? scratch + j % 2 * cells : nullptr;
    const int rc = run_march(a, 1, wrap_depth(k, j), kWrapForm, j > 0, j < q - 1, (cudaStream_t)stream, nullptr);
    if (rc != 0) return rc;
  }
  return 0;
#else
  const float* src = in;
  for (int j = 0; j < q; ++j) {
    // the last march writes `out`, the one before it the scratch, and so on
    float* dst = (q - 1 - j) % 2 == 0 ? out : scratch;
    const int rc = run_march(wrap_args(src, dst, X, Y, Z, hot_x, cold_x, in_r2), 1, wrap_depth(k, j), kWrapForm,
                             false, false, (cudaStream_t)stream, nullptr);
    if (rc != 0) return rc;
    src = dst;
  }
  return 0;
#endif
}

// The launches stp_jacobi_wrap makes for these arguments, into info[11]:
// kernel launches a call (marches), the first march's depth, and that
// march's blocks an SM, SMs, blocks, x chunk, chunks, shared memory bytes,
// threads a block and tiles along z and y.  Returns what the launch would.
int stp_jacobi_wrap_plan(int X, int Y, int Z, int k, int* info) {
  if (bad_wrap_args(X, Y, Z, k)) return -1;
  Plan pl;
  const int d1 = wrap_depth(k, 0);
  // the first march (under bf16 storage: to the scratch where more follow)
  const bool to = STP_JW_STORAGE == 1 && wrap_marches(k) > 1;
  const int rc = run_march(wrap_args(nullptr, nullptr, X, Y, Z, 0, 0, 0), 1, d1, kWrapForm, false, to, nullptr, &pl);
  if (rc != 0) return rc;
  const int w[11] = {wrap_marches(k), d1, pl.blocks_per_sm, pl.sms, pl.blocks, pl.xchunk, pl.nchunks,
                     pl.smem, pl.threads, pl.tiles_z, pl.tiles_y};
  for (int j = 0; j < 11; ++j) info[j] = w[j];
  return 0;
}

#if !STP_JW_UNIT
// One Jacobi level over n radius-1 shell-carrying blocks (n, X, Y, Z), `in`
// to `out` (apart), every cell of `out` written: the interior computed, the
// shell copied.  origins (n, 3), d2 (n, Y - 2, Z - 2).  Returns a CUDA error
// code, or -1 for arguments the kernel does not take.
int stp_jacobi_plane(const float* in, float* out, const int* origins, const int* d2, int n, int X, int Y, int Z,
                     int gx, int hot_x, int cold_x, int in_r2, void* stream) {
  if (bad_onelevel_args(kPlaneForm, n, X, Y, Z, gx) || in == out) return -1;
  QArgs a = onelevel_args(kPlaneForm, X, Y, Z, gx, hot_x, cold_x, in_r2);
  a.raw = in;
  a.out = out;
  a.origins = origins;
  a.d2 = d2;
  return march<1, kPlaneForm, false, false>(a, n, (cudaStream_t)stream, nullptr);
}

// One Jacobi level over n bare interiors (n, X, Y, Z), `in` to `out`
// (apart), the neighbours beyond each face from its slab: xlo, xhi (n, Y,
// Z), ylo, yhi (n, X, Z), zlo, zhi (n, X, Y).  origins (n, 3), d2 (n, Y, Z).
// Returns a CUDA error code, or -1 for arguments the kernel does not take.
int stp_jacobi_slab(const float* in, float* out, const float* xlo, const float* xhi, const float* ylo,
                    const float* yhi, const float* zlo, const float* zhi, const int* origins, const int* d2, int n,
                    int X, int Y, int Z, int gx, int hot_x, int cold_x, int in_r2, void* stream) {
  if (bad_onelevel_args(kSlabForm, n, X, Y, Z, gx) || in == out) return -1;
  SlabArgs a{onelevel_args(kSlabForm, X, Y, Z, gx, hot_x, cold_x, in_r2)};
  a.raw = in;
  a.out = out;
  a.origins = origins;
  a.d2 = d2;
  a.xlo = xlo;
  a.xhi = xhi;
  a.ylo = ylo;
  a.yhi = yhi;
  a.zlo = zlo;
  a.zhi = zhi;
  return march<1, kSlabForm, false, false>(a, n, (cudaStream_t)stream, nullptr);
}

// The launch stp_jacobi_plane / stp_jacobi_slab makes for these arguments
// (one kernel, a march of depth 1), into info[9]: blocks an SM, SMs,
// blocks, x chunk, chunks, shared memory bytes, threads a block and tiles
// along z and y.  Returns what the launch would.
int stp_jacobi_plane_plan(int n, int X, int Y, int Z, int* info) { return onelevel_plan(kPlaneForm, n, X, Y, Z, info); }
int stp_jacobi_slab_plan(int n, int X, int Y, int Z, int* info) { return onelevel_plan(kSlabForm, n, X, Y, Z, info); }
#endif

const char* stp_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
