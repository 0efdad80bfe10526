// One level of a traced user kernel over shell-carrying blocks, for Hopper
// (sm_90a), bound to Python through ctypes (stencil_tpu_torch/kernels/
// build.py, stencil_tpu_torch/ops/stream.py).
//
// A kernel template: the line `// @STP_GENERATED@` below is replaced by the
// body that stencil_tpu_torch/ops/stream_trace.py emits for one user kernel
// (STP_NF, the field count, and stp_body, the kernel's arithmetic), and the
// result is built by nvcc into a library of its own.
//
// stp_stream_plane_level replaces stencil_tpu/ops/stream.py:279
//   stream_plane_pass: one level of a user kernel over n shell-carrying
//   (X, Y, Z) blocks per field in ONE launch (the leading block dimension
//   stands in for shard_map).  Shell widths lo/hi per axis, any read radius
//   r >= 1 up to them; the shell passes through unchanged.  The TPU kernel
//   streams x-planes through a 2r-deep VMEM ring; here each thread owns one
//   (y, z) column and walks the planes of all blocks.
//
// The fused form (built with STP_FUSED defined; halo="fused" in
//   ops/stream.py, the fused_shell inputs of stencil_tpu/ops/stream.py:425-458):
//   the blocks carry a STALE shell, and the shell that the exchange would
//   have written lives in three small buffers per field, over the n blocks:
//   x planes (n, lox + hix, Y, Z), y rows (n, loy + hiy, X, Z) and z columns
//   (n, loz + hiz, Y, X), each [low | high].  Every read of a shell-position
//   cell, the pass-through included, goes to them, z column over y row over
//   x plane (the exchange's sweep order x -> y -> z: the later sweep's write
//   wins), so the pass computes what the array form computes after the
//   exchange, bit for bit, shell included, and the blocks see no halo write.
//   Two launches (one under a contracting unit, below): the cells farther
//   than the read radius r from the shell read the block alone, and take
//   the array form's body (plane_level over FarFields, 32 registers like
//   the array form); the band of the shell and
//   the cells within r of it (9% of a 262^3 block at shell 3, r = 1) takes
//   plane_band, which walks it as a flat index in three regions, each z
//   minor: the x planes, the y rows of the other planes, the z columns of
//   the other rows.  One kernel for both, with the band's reads branching
//   per cell, held 92 registers and ran 2.2x the array form's time on the
//   H100 (PERF.md); the array form's kernel is the same template at
//   Fields, unchanged.
//
// Bound on an H100 SXM: bytes, 8 B per cell and field and level.  Interior
// cells read their neighbours straight from global memory (re-reads left to
// L1/L2): the shell is at least r wide, so no read leaves the block.  A
// shared-memory plane ring is later work.
//
// Field dtypes (the generated part's STP_S, STP_C and access macros,
// ops/stream_trace.py): a launch reads each field at its compute type STP_C
// and stores STP_S, one rounding a pass as each JAX pallas_call makes under
// f32_accumulate (bf16 storage, float levels); the shell passes through as
// its stored bits.
//
// The contraction form (compute_unit "mxu" / "mxu_band": the generated
// part defines STP_NBR_MASK, the fields whose centre plane the level
// contracts, and STP_MXU, 1 for f32 operands as three TF32 pieces, 2 for
// bf16 operands; its stp_body reads a field's in-plane neighbour sum
// (y-1 + y+1) + (z-1 + z+1) through nb(q), the PlaneView.plane_nbr_sum
// seam of stencil_tpu/ops/stream.py:189-200): plane_level_mxu.  A
// block of 8 warps owns a 30 x 62 tile of (y, z) and walks the planes of
// all blocks; per interior plane it stages each such field's 32 x 64 tile
// with a one-cell apron (0 past the plane's edge: the JAX pass contracts
// the whole raw plane, and an interior cell's neighbours lie inside it) in
// shared memory at the compute type, contracts it on the tensor cores, one
// 16 x 16 piece a warp (csrc/band_mma.cuh), into a shared plane of sums per
// field, and then runs the per-cell body, its plane reads from global
// memory as above.  Shell planes and cells pass through.  Built with
// STP_FUSED, the same kernel is the fused form's one launch (MxuFields is
// FusedFields): the staging of the tile, the body's reads and the
// pass-through go through fused_cell, so the tile holds the plane the
// exchange would have left (the patched level-0 plane that the JAX pass
// contracts, _fused_plane_patch at stencil_tpu/ops/stream.py:239-259).  A
// band cell's in-plane neighbours are shell cells in the buffers, so the
// vpu form's split into a far launch and a per-cell band launch has no
// tile to contract; the one launch tests every read against the shells.
// Over 8 fields it holds 128 registers (the array form 61), two blocks an
// SM where the array form fits three, and runs 1.6x its time on the H100;
// reading interior cells at the array form's offsets, or picking each
// read's buffer before one load, moved it less than 4%, and bounding it
// to three blocks an SM spilled and ran slower (PERF.md).
//
// Bitwise contract: stp_body uses __fadd_rn/__fmul_rn/... (no contraction);
// the global coordinates are (origin + index - lo) mod global size, as
// _yz_coord_planes computes them in the JAX package.  The contraction form
// holds within tests/ulp.py's 4 ulps of its plain version (the tensor core's
// accumulation of the in-plane sums).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// @STP_GENERATED@

#ifdef STP_NBR_MASK
#include "band_mma.cuh"
#endif

namespace {

constexpr int kTileZ = 32;
constexpr int kTileY = 8;
constexpr int kMaxGridZ = 65535;

struct Fields {
  const STP_S* in[STP_NF];
  STP_S* out[STP_NF];
};

// the fused form's far-interior launch: the array body over the cells more
// than r from the shell, which it leaves to the band launch
struct FarFields : Fields {
  int r;
};

// the fused form's band launch: the shell buffers per field, and the read radius
struct FusedFields : Fields {
  const STP_S* xb[STP_NF];  // (n, lox + hix, Y, Z)
  const STP_S* yb[STP_NF];  // (n, loy + hiy, X, Z)
  const STP_S* zb[STP_NF];  // (n, loz + hiz, Y, X)
  int r;
};

struct Geometry {
  int n, X, Y, Z;
  int lox, loy, loz, hix, hiy, hiz;
  int gx, gy, gz;
};

__device__ __forceinline__ int pmod(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

#ifdef STP_FUSED

// Cell (x, y, z) of block b and field q after the exchange, in the fused
// form: the z-column buffer over the y-row buffer over the x-plane buffer at
// shell positions, the block elsewhere, as stored (STP_P).
// kAxes: the shells (bit 0 x, 1 y, 2 z) the cell may lie in.
template <int kAxes = 7>
__device__ __forceinline__ STP_P fused_cell(const FusedFields& f, const Geometry& g, int q, int64_t b, int x,
                                            int y, int z) {
  if ((kAxes & 4) && (z < g.loz || z >= g.Z - g.hiz)) {
    const int k = z < g.loz ? z : g.loz + z - (g.Z - g.hiz);
    return STP_GET(f.zb[q], q, ((b * (g.loz + g.hiz) + k) * g.Y + y) * g.X + x);
  }
  if ((kAxes & 2) && (y < g.loy || y >= g.Y - g.hiy)) {
    const int k = y < g.loy ? y : g.loy + y - (g.Y - g.hiy);
    return STP_GET(f.yb[q], q, ((b * (g.loy + g.hiy) + k) * g.X + x) * g.Z + z);
  }
  if ((kAxes & 1) && (x < g.lox || x >= g.X - g.hix)) {
    const int k = x < g.lox ? x : g.lox + x - (g.X - g.hix);
    return STP_GET(f.xb[q], q, ((b * (g.lox + g.hix) + k) * g.Y + y) * g.Z + z);
  }
  return STP_GET(f.in[q], q, ((b * g.X + x) * g.Y + y) * g.Z + z);
}

#endif  // STP_FUSED

// grid: (ceil(Z/32), ceil(Y/8), min(n*X, 65535)); p = block*X + x strides by
// gridDim.z.  origins: (n, 3) int32, each block's interior start.  F is
// Fields (the array form) or FarFields (the fused form's far interior).
template <class F>
__global__ void plane_level(F f, const int* __restrict__ origins, Geometry g) {
  constexpr bool kFar = std::is_same<F, FarFields>::value;
  const int z = blockIdx.x * kTileZ + threadIdx.x;
  const int y = blockIdx.y * kTileY + threadIdx.y;
  if (z >= g.Z || y >= g.Y) return;
  if constexpr (kFar) {  // a (y, z) column within r of the shell is the band's
    if (y < g.loy + f.r || y >= g.Y - g.hiy - f.r || z < g.loz + f.r || z >= g.Z - g.hiz - f.r) return;
  }
  const int64_t plane = (int64_t)g.Y * g.Z;
  const bool ring = y < g.loy || y >= g.Y - g.hiy || z < g.loz || z >= g.Z - g.hiz;
  const int64_t total = (int64_t)g.n * g.X;
  for (int64_t p = blockIdx.z; p < total; p += gridDim.z) {
    const int64_t b = p / g.X;
    const int x = (int)(p - b * g.X);
    if constexpr (kFar) {
      if (x < g.lox + f.r || x >= g.X - g.hix - f.r) continue;
    }
    const int64_t idx = p * plane + (int64_t)y * g.Z + z;
    if (ring || x < g.lox || x >= g.X - g.hix) {
#pragma unroll
      for (int q = 0; q < STP_NF; ++q) STP_PUT(f.out[q], q, idx, STP_GET(f.in[q], q, idx));  // shell passes through
      continue;
    }
    const int xg = pmod(origins[3 * b] + x - g.lox, g.gx);
    const int yg = pmod(origins[3 * b + 1] + y - g.loy, g.gy);
    const int zg = pmod(origins[3 * b + 2] + z - g.loz, g.gz);
    auto ld = [&](int q, int dx, int dy, int dz) -> STP_C {
      return STP_LD(f.in[q], q, idx + dx * plane + (int64_t)dy * g.Z + dz);
    };
    STP_C out[STP_NF];
    stp_body(ld, 1, xg, yg, zg, out);
#pragma unroll
    for (int q = 0; q < STP_NF; ++q) STP_ST(f.out[q], q, idx, out[q]);
  }
}

#ifdef STP_NBR_MASK

constexpr int kSR = 32, kSC = 64;            // the staged tile, its one-cell apron included
constexpr int kOR = kSR - 2, kOC = kSC - 2;  // the cells a block computes
constexpr int kTile = kSR * kSC;
// a staging plane and one plane of sums a field
constexpr size_t kMxuSmem = (size_t)(1 + STP_NF) * kTile * sizeof(float);

#ifdef STP_FUSED
using MxuFields = FusedFields;  // the fused form: every shell-position read goes to the buffers
#else
using MxuFields = Fields;
#endif

// grid: (ceil(Z/62), ceil(Y/30), min(n*X, 65535)), blocks of 32 x 8
// threads; p = block*X + x strides by gridDim.z
__global__ void __launch_bounds__(256) plane_level_mxu(MxuFields f, const int* __restrict__ origins, Geometry g) {
  extern __shared__ __align__(16) float smem_mxu[];
  float* const stage = smem_mxu;
  float* const sums = smem_mxu + kTile;  // field q's plane at q * kTile
  const int y0 = blockIdx.y * kOR - 1, z0 = blockIdx.x * kOC - 1;  // tile cell (0, 0)
  const int64_t plane = (int64_t)g.Y * g.Z;
  const int64_t total = (int64_t)g.n * g.X;
  for (int64_t p = blockIdx.z; p < total; p += gridDim.z) {
    const int64_t b = p / g.X;
    const int x = (int)(p - b * g.X);
    const bool in_x = x >= g.lox && x < g.X - g.hix;
    const int64_t po = p * plane;
    if (in_x) {
#pragma unroll
      for (int q = 0; q < STP_NF; ++q) {
        if (!(STP_NBR_MASK >> q & 1)) continue;
        for (int r = threadIdx.y; r < kSR; r += kTileY)
          for (int c = threadIdx.x; c < kSC; c += kTileZ) {
            const int y = y0 + r, z = z0 + c;
#ifdef STP_FUSED  // an interior x plane: its y rows and z columns may be shell cells
            stage[r * kSC + c] =
                y >= 0 && y < g.Y && z >= 0 && z < g.Z ? STP_UP(q, fused_cell<6>(f, g, q, b, x, y, z)) : 0.0f;
#else
            stage[r * kSC + c] =
                y >= 0 && y < g.Y && z >= 0 && z < g.Z ? STP_LD(f.in[q], q, po + (int64_t)y * g.Z + z) : 0.0f;
#endif
          }
        __syncthreads();
        band_mma::piece_to_plane<STP_MXU, kSR, kSC, kSC, kSC>(stage, sums + q * kTile, threadIdx.y, threadIdx.x);
        __syncthreads();
      }
    }
    for (int r = 1 + threadIdx.y; r <= kOR && y0 + r < g.Y; r += kTileY) {
      const int y = y0 + r;
      for (int c = 1 + threadIdx.x; c <= kOC && z0 + c < g.Z; c += kTileZ) {
        const int z = z0 + c;
        const int64_t idx = po + (int64_t)y * g.Z + z;
        if (!in_x || y < g.loy || y >= g.Y - g.hiy || z < g.loz || z >= g.Z - g.hiz) {
#pragma unroll
          for (int q = 0; q < STP_NF; ++q)  // shell passes through
#ifdef STP_FUSED
            STP_PUT(f.out[q], q, idx, fused_cell(f, g, q, b, x, y, z));
#else
            STP_PUT(f.out[q], q, idx, STP_GET(f.in[q], q, idx));
#endif
          continue;
        }
        const int xg = pmod(origins[3 * b] + x - g.lox, g.gx);
        const int yg = pmod(origins[3 * b + 1] + y - g.loy, g.gy);
        const int zg = pmod(origins[3 * b + 2] + z - g.loz, g.gz);
#ifdef STP_FUSED  // a read within the read radius of the shell lands in it
        auto ld = [&](int q, int dx, int dy, int dz) -> STP_C {
          return STP_UP(q, fused_cell(f, g, q, b, x + dx, y + dy, z + dz));
        };
#else
        auto ld = [&](int q, int dx, int dy, int dz) -> STP_C {
          return STP_LD(f.in[q], q, idx + dx * plane + (int64_t)dy * g.Z + dz);
        };
#endif
        auto nb = [&](int q) -> STP_C { return sums[q * kTile + r * kSC + c]; };
        STP_C out[STP_NF];
        stp_body(ld, nb, 1, xg, yg, zg, out);
#pragma unroll
        for (int q = 0; q < STP_NF; ++q) STP_ST(f.out[q], q, idx, out[q]);
      }
    }
    __syncthreads();  // this plane's reads of the sums before the next plane's contraction
  }
}

#endif  // STP_NBR_MASK

template <class F>
int launch(const F& f, const int* origins, const Geometry& g, void* stream) {
  const int64_t planes = (int64_t)g.n * g.X;
#ifdef STP_NBR_MASK
  static_assert(std::is_same<F, MxuFields>::value, "the contraction form's one kernel takes MxuFields");
  const cudaError_t err =
      cudaFuncSetAttribute(plane_level_mxu, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMxuSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((g.Z + kOC - 1) / kOC, (g.Y + kOR - 1) / kOR, (unsigned)(planes < kMaxGridZ ? planes : kMaxGridZ));
  plane_level_mxu<<<grid, dim3(kTileZ, kTileY), kMxuSmem, (cudaStream_t)stream>>>(f, origins, g);
#else
  dim3 grid((g.Z + kTileZ - 1) / kTileZ, (g.Y + kTileY - 1) / kTileY,
            (unsigned)(planes < kMaxGridZ ? planes : kMaxGridZ));
  plane_level<F><<<grid, dim3(kTileZ, kTileY), 0, (cudaStream_t)stream>>>(f, origins, g);
#endif
  return (int)cudaGetLastError();
}

#if defined(STP_FUSED) && !defined(STP_NBR_MASK)

// The band on one axis of extent ext: lo + r cells at the low side and hi +
// r at the high side, cut so that the two sides never overlap (a short axis
// is band throughout, and the far launch then has nothing on it).
struct BandAxis {
  int lo_r, hi_r, ext;
  __device__ BandAxis(int lo, int hi, int r, int e) : lo_r(min(lo + r, e)), hi_r(min(hi + r, e - lo_r)), ext(e) {}
  __device__ int width() const { return lo_r + hi_r; }
  // index j < width() of the band to the axis's index
  __device__ int at(int j) const { return j < lo_r ? j : ext - lo_r - hi_r + j; }
};

// The fused form's band: every cell of every block that is in the shell or
// within r of it, as a flat index over n blocks of three regions each: A,
// the band's x planes, (plane, y, z); B, the band's y rows of the other
// planes, (x, row, z); C, the band's z columns of the other planes and
// rows, (x, y, column): a warp writes the band cells of four rows, each
// row's low and high cells one run each (lanes along x or y wrote one cell
// a row each, and each 32-byte sector four times: 3.1-3.5 of the kernel's
// 3.6 ms on the H100, PERF.md).  Shell cells pass the buffers'
// value through; the others compute with every read through fused_cell,
// which tests only the shells a read from the region can reach.
__global__ void plane_band(FusedFields f, const int* __restrict__ origins, Geometry g) {
  const int r = f.r;
  const BandAxis ax(g.lox, g.hix, r, g.X), ay(g.loy, g.hiy, r, g.Y), az(g.loz, g.hiz, r, g.Z);
  const int bx = ax.width(), by = ay.width(), bz = az.width();
  const int64_t A = (int64_t)bx * g.Y * g.Z;
  const int64_t B = (int64_t)(g.X - bx) * by * g.Z;
  const int64_t C = (int64_t)(g.X - bx) * (g.Y - by) * bz;
  const int64_t per_block = A + B + C;
  const int64_t total = per_block * g.n;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total; t += (int64_t)gridDim.x * blockDim.x) {
    const int64_t b = t / per_block;
    int64_t u = t - b * per_block;
    int x, y, z;
    const int region = u < A ? 0 : u < A + B ? 1 : 2;
    if (u < A) {
      const int64_t yz = (int64_t)g.Y * g.Z;
      x = ax.at((int)(u / yz));
      u -= (u / yz) * yz;
      y = (int)(u / g.Z);
      z = (int)(u - (int64_t)y * g.Z);
    } else if (u < A + B) {
      u -= A;
      const int64_t rz = (int64_t)by * g.Z;
      x = ax.lo_r + (int)(u / rz);
      u -= (u / rz) * rz;
      y = ay.at((int)(u / g.Z));
      z = (int)(u % g.Z);
    } else {
      u -= A + B;
      const int ys = g.Y - by;
      z = az.at((int)(u % bz));
      u /= bz;
      y = ay.lo_r + (int)(u % ys);
      x = ax.lo_r + (int)(u / ys);
    }
    const int64_t idx = ((b * g.X + x) * g.Y + y) * g.Z + z;
    if (x < g.lox || x >= g.X - g.hix || y < g.loy || y >= g.Y - g.hiy || z < g.loz || z >= g.Z - g.hiz) {
#pragma unroll
      for (int q = 0; q < STP_NF; ++q) STP_PUT(f.out[q], q, idx, fused_cell(f, g, q, b, x, y, z));  // shell passes through
      continue;
    }
    const int xg = pmod(origins[3 * b] + x - g.lox, g.gx);
    const int yg = pmod(origins[3 * b + 1] + y - g.loy, g.gy);
    const int zg = pmod(origins[3 * b + 2] + z - g.loz, g.gz);
    // a read from region B's cells may reach the y and z shells only, from
    // region C's the z shell only (the regions leave out the x and y bands)
    STP_C out[STP_NF];
    if (region == 2) {
      auto ld = [&](int q, int dx, int dy, int dz) -> STP_C {
        return STP_UP(q, fused_cell<4>(f, g, q, b, x + dx, y + dy, z + dz));
      };
      stp_body(ld, 1, xg, yg, zg, out);
    } else if (region == 1) {
      auto ld = [&](int q, int dx, int dy, int dz) -> STP_C {
        return STP_UP(q, fused_cell<6>(f, g, q, b, x + dx, y + dy, z + dz));
      };
      stp_body(ld, 1, xg, yg, zg, out);
    } else {
      auto ld = [&](int q, int dx, int dy, int dz) -> STP_C {
        return STP_UP(q, fused_cell(f, g, q, b, x + dx, y + dy, z + dz));
      };
      stp_body(ld, 1, xg, yg, zg, out);
    }
#pragma unroll
    for (int q = 0; q < STP_NF; ++q) STP_ST(f.out[q], q, idx, out[q]);
  }
}

constexpr int kBandThreads = 256;
constexpr int kBandBlocks = 132 * 8;  // a few waves of the H100's SMs; the band strides over them

int launch_band(const FusedFields& f, const int* origins, const Geometry& g, void* stream) {
  plane_band<<<kBandBlocks, kBandThreads, 0, (cudaStream_t)stream>>>(f, origins, g);
  return (int)cudaGetLastError();
}

#endif  // STP_FUSED && !STP_NBR_MASK

bool bad_args(int n, int X, int Y, int Z, int lox, int loy, int loz, int hix, int hiy, int hiz, int gx, int gy,
              int gz) {
  return n < 1 || lox + hix >= X || loy + hiy >= Y || loz + hiz >= Z || gx < 1 || gy < 1 || gz < 1;
}

}  // namespace

extern "C" {

#ifndef STP_FUSED

// in/out: host arrays of STP_NF device pointers, each n (X, Y, Z) blocks
// of the field's storage type; origins: (n, 3) int32 on the device.  Returns a CUDA error code, or
// -1 for arguments the kernel does not take.
int stp_stream_plane_level(void* const* in, void* const* out, const int* origins, int n, int X,
                           int Y, int Z, int lox, int loy, int loz, int hix, int hiy, int hiz,
                           int gx, int gy, int gz, void* stream) {
  if (bad_args(n, X, Y, Z, lox, loy, loz, hix, hiy, hiz, gx, gy, gz)) return -1;
  Fields f;
  for (int q = 0; q < STP_NF; ++q) {
    f.in[q] = static_cast<const STP_S*>(in[q]);
    f.out[q] = static_cast<STP_S*>(out[q]);
  }
  return launch(f, origins, Geometry{n, X, Y, Z, lox, loy, loz, hix, hiy, hiz, gx, gy, gz}, stream);
}

#else

// The fused form: as stp_stream_plane_level, plus xb/yb/zb, host arrays of
// STP_NF device pointers to the shell buffers (layouts above), and the read
// radius r (1 <= r <= every shell width; every shell width > 0).
int stp_stream_plane_fused(void* const* in, void* const* xb, void* const* yb, void* const* zb, void* const* out,
                           const int* origins, int n, int X, int Y, int Z, int lox, int loy, int loz, int hix,
                           int hiy, int hiz, int r, int gx, int gy, int gz, void* stream) {
  if (bad_args(n, X, Y, Z, lox, loy, loz, hix, hiy, hiz, gx, gy, gz) || r < 1 || lox < r || loy < r ||
      loz < r || hix < r || hiy < r || hiz < r)
    return -1;
  FusedFields f;
  for (int q = 0; q < STP_NF; ++q) {
    f.in[q] = static_cast<const STP_S*>(in[q]);
    f.out[q] = static_cast<STP_S*>(out[q]);
    f.xb[q] = static_cast<const STP_S*>(xb[q]);
    f.yb[q] = static_cast<const STP_S*>(yb[q]);
    f.zb[q] = static_cast<const STP_S*>(zb[q]);
  }
  f.r = r;
  const Geometry geo{n, X, Y, Z, lox, loy, loz, hix, hiy, hiz, gx, gy, gz};
#ifdef STP_NBR_MASK
  return launch(f, origins, geo, stream);  // the contraction's one launch, reads through fused_cell
#else
  FarFields far;
  for (int q = 0; q < STP_NF; ++q) {
    far.in[q] = f.in[q];
    far.out[q] = f.out[q];
  }
  far.r = r;
  const int rc = launch(far, origins, geo, stream);
  return rc != 0 ? rc : launch_band(f, origins, geo, stream);
#endif
}

#endif  // STP_FUSED

const char* stp_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
