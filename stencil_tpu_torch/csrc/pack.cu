// Pack kernels for Hopper (sm_90a), bound to Python through ctypes
// (stencil_tpu_torch/kernels/build.py, stencil_tpu_torch/ops/pack.py).
//
// The slab packs of bench-pack and make_pack_fn_pallas take one block
// (X, Y, Z) and a box at (px, py, pz) of extent (ex, ey, ez):
//
//   stp_pack_slab_desc    replaces stencil_tpu/ops/pack.py:197 pallas_pack_slab:
//                         slab[i, j, k] = block[px + i, py + j, pz + k]
//   stp_unpack_slab_desc  replaces stencil_tpu/ops/pack.py:225 pallas_unpack_slab:
//                         block[px + i, py + j, pz + k] = slab[i, j, k], in place
//
// The TPU kernels DMA whole x-planes into VMEM and cut the window there (an
// HBM DMA must not cut the (8,128) tiling); the port keeps the box copy, the
// reference's grid_pack / grid_unpack (pack_kernel.cuh:16-40, copy.cuh:26-64).
// Both go through the descriptor entries (below), as does the y-shell pair.
//
// The halo write of the exchange, n blocks (n, X, Y, Z) and a slab of width r
// at a static offset `pos` on one axis, is the slab unpack of a box too:
//
//   stp_blend_slab_desc   replaces stencil_tpu/ops/halo_blend.py:84 blend_slab:
//                         block[b, pos + i, j, k] = slab[b, i, j, k] (axis 0; y and z alike)
//
// The TPU kernel keeps that write tile-local under the (8,128) layout; here
// the n blocks are one block whose box the slab fills: (n, X*Y, Z) with the
// box (0, pos*Y, 0) of extent (n, r*Y, Z) on x, (n*X, Y, Z) with (0, pos, 0)
// and (n*X, r, Z) on y, (0, 0, pos) and (n*X, Y, r) on z.  So the x and y
// slabs go through the row kernel (rows of Z cells) and the z slab through
// the cell kernel, as the slab unpack's faces do.
//
//   stp_blend_slab_dynamic_desc  replaces stencil_tpu/ops/halo_blend.py:179
//                         blend_slab_dynamic: block[b, p_b + i, j, k] = slab[b, i, j, k]
//                         (axis 0; y and z alike), p_b = clamp(pos[b], 0, ext - r)
//
// is the same write with one offset a block, known only on the device
// (pos, n int32 values), which is where the +axis halo of a padded (uneven)
// axis lands: right after the block's own valid cells.  Its box is the static
// write's at position 0 (DynGeom): a box row's first coordinate i is the
// block itself on x, b * X + x on y and z, so a row (the cell kernel: a cell)
// reads pos[i / X] once and moves by p_b times the axis stride, Y * Z, Z or
// 1.  On the z face, whose rows are a few cells, that read is not what the
// time goes to: reading it once a stage instead moved nothing (PERF.md).  An
// offset outside [0, ext - r] is clamped into it, as lax.dynamic_update_slice
// clamps, and the wrapper reads no offset back, so a call never
// synchronizes.  It takes axis 0 as well: the JAX package
// writes the x halo with a dynamic_update_slice, but a sub-view of the
// port's (n, X, Y, Z) stack is not contiguous.
//
// The shell packs of the packed exchange routes each take n blocks
// (n, X, Y, Z) and a window of `depth` cells starting at `start` on one axis:
//
//   stp_pack_zshell_desc    replaces stencil_tpu/ops/pack.py:331 pack_zshell_pallas:
//                           buf[b, k, y, x] = block[b, x, y, start + k]
//   stp_unpack_zshell_desc  replaces stencil_tpu/ops/pack.py:358 unpack_zshell_pallas:
//                           block[b, x, y, start + k] = buf[b, k, y, x], in place
//   stp_pack_yshell_desc    replaces stencil_tpu/ops/pack.py:422 pack_yshell_pallas:
//                           buf[b, k, x, z] = block[b, x, start + k, z]
//   stp_unpack_yshell_desc  replaces stencil_tpu/ops/pack.py:449 unpack_yshell_pallas:
//                           block[b, x, start + k, z] = buf[b, k, x, z], in place
//
// The TPU kernels stream whole x-planes through VMEM only so that no DMA cuts
// the (8,128) tiling; they compute the window copy above, and that is all the
// port keeps.  The unpacks write the window and nothing else (the TPU kernels
// rewrite whole planes through input_output_aliases, with the same result).
// Elements move as unsigned integers of their width (1, 2, 4 or 8 bytes), so
// every dtype of those widths moves bit for bit.  The z buffer is (depth, Y, X)
// without the TPU's lane padding of X.
//
// Bound on an H100 SXM: bytes, the window read once and written once, 2 * n *
// depth * (the other two extents) * itemsize.  The z pair's design is at its
// kernel, below the y pair's.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kUnroll = 4;  // loads in flight per lane in the cell kernel
constexpr int64_t kMaxBlocks = 132 * 32;

// --- The descriptor entries: both slab packs, both shell pairs, both blends ---
//
// pallas_pack_slab, pallas_unpack_slab, the z- and y-shell packs and unpacks,
// blend_slab and blend_slab_dynamic.  Each entry takes the address of a host
// array of int64 fields that the wrapper builds once per geometry and caches
// (ops/pack.py, ops/halo_blend.py), the two data pointers (and the dynamic
// write's offsets) and the stream: four arguments, or five, so that the call
// costs no more host time than a PyTorch copy.  The fields are read here, on the host, and reach the kernel by value;
// the pointers' alignment is read per call, never cached.  A pack and an unpack of one geometry share a
// descriptor, and each pair shares its kernels, templated on the direction.
//
// The slab packs and the y pair copy rows that are contiguous on both sides
// (the z pair transposes; its design is at its kernel).  A row goes to one
// warp: a head of elements up to the destination's next 16-byte boundary, then
// 16-byte stores, each vector loaded in the widest words that the source's
// alignment relative to the destination allows (16 bytes where the two rows
// share their alignment, else 8, 4, 2 or 1), kRowUnroll vectors in flight a
// lane, then a tail of elements.  No TMA and no cp.async.bulk: both need
// 16-byte strides, and a 518-wide f32 row is 2,072 B and a 262-wide one
// 1,048 B, both 8 mod 16.
//
// The y shell: a row is (b, k, x), Z cells, the buffer's row order; the
// destination is the buffer (pack) or the block's row in the window (unpack),
// and nothing outside the window is written.  At the route's (8, 262, 262,
// 262) f32 depth 3 that is 6,288 rows of 1,048 B, 786 blocks of 8 warps, one
// wave on 132 SMs.
//
// The slab: a slab row of ez cells of at least kRowBytes bytes (the x and y
// faces) goes to a warp as above, the slab row the destination of a pack and
// the block's row that of an unpack.  Shorter rows (the z face's 12-byte
// ez = 3 runs) go to the cell kernel, which moves kStageBytes of the slab a
// block at once through shared memory, a cell a lane in the slab's C order on
// the block's side, so that a warp-wide access covers each 32-byte sector of
// the block once, and whole 16-byte words on the slab's side when its pointer
// is 16-byte aligned (else elements).  A pack gathers the block's cells,
// kUnroll loads in flight a lane, then writes the slab; an unpack loads the
// slab, then scatters its cells.  A cell's (i, j, k) comes from two
// multiply-high divisions, not a runtime divide.  Bound: bytes, the box read
// once and written once; but on the z face each 12-byte run fills part of a
// sector, and that sector traffic, which no order of the accesses avoids, sets
// the time (PERF.md).

constexpr int kRowWarps = 8;       // rows per block in the row kernels
constexpr int kRowUnroll = 4;      // 16-byte vectors in flight a lane
constexpr int kRowBytes = 512;     // a slab row this long or longer goes to a warp
constexpr int kCellThreads = 256;  // the cell kernel's block
constexpr int kStageBytes = 8192;  // slab bytes a cell block stages at once

// Division by a fixed divisor as a multiply-high, exact for n < 2^31
// (CUTLASS's FastDivmod, cutlass/fast_math.h).  Built on the host.
struct FastDiv {
  uint32_t d, mul, shr;
  void init(uint32_t div) {
    d = div;
    mul = shr = 0;
    if (div > 1) {
      int log2 = 0;
      while ((1ull << log2) < div) ++log2;  // ceil(log2(div))
      const int p = 31 + log2;
      mul = (uint32_t)(((1ull << p) + div - 1) / div);
      shr = (uint32_t)(p - 32);
    }
  }
  __device__ __forceinline__ uint32_t div(uint32_t n) const {
    return d == 1 ? n : __umulhi(n, mul) >> shr;
  }
};

// 16 bytes from p, in words of W (W's alignment is all p has).
template <typename W>
__device__ __forceinline__ uint4 load16(const char* p) {
  if constexpr (sizeof(W) == 16) {
    return *reinterpret_cast<const uint4*>(p);
  } else {
    W w[16 / sizeof(W)];
#pragma unroll
    for (int i = 0; i < (int)(16 / sizeof(W)); ++i) w[i] = reinterpret_cast<const W*>(p)[i];
    uint4 v;
    memcpy(&v, w, 16);
    return v;
  }
}

// nvec 16-byte vectors from s to d (d 16-byte aligned) by the lanes of a warp.
template <typename W>
__device__ __forceinline__ void copy_vectors(char* __restrict__ d, const char* __restrict__ s, int nvec,
                                             int lane) {
  for (int v0 = lane; v0 < nvec; v0 += 32 * kRowUnroll) {
    uint4 r[kRowUnroll];
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      if (v0 + 32 * u < nvec) r[u] = load16<W>(s + 16 * (v0 + 32 * u));
    }
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      if (v0 + 32 * u < nvec) *reinterpret_cast<uint4*>(d + 16 * (v0 + 32 * u)) = r[u];
    }
  }
}

// One row of `bytes` bytes (a whole number of T) from src to dst, by a warp.
template <typename T>
__device__ __forceinline__ void warp_copy_row(char* __restrict__ dst, const char* __restrict__ src, int bytes,
                                              int lane) {
  constexpr int kT = (int)sizeof(T);
  const int to16 = (int)((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15);
  const int head = to16 < bytes ? to16 : bytes;
  const int nvec = (bytes - head) >> 4;
  const int tail = head + (nvec << 4);
  for (int b = lane * kT; b < head; b += 32 * kT) {
    *reinterpret_cast<T*>(dst + b) = *reinterpret_cast<const T*>(src + b);
  }
  for (int b = tail + lane * kT; b < bytes; b += 32 * kT) {
    *reinterpret_cast<T*>(dst + b) = *reinterpret_cast<const T*>(src + b);
  }
  char* d = dst + head;
  const char* s = src + head;
  const int rel = (int)(reinterpret_cast<uintptr_t>(s) & 15);  // d is 16-byte aligned
  const int w = rel == 0 ? 16 : rel & -rel;                    // at least kT: s is T-aligned
  if (w == 16) {
    copy_vectors<uint4>(d, s, nvec, lane);
  } else if (w == 8) {
    copy_vectors<uint64_t>(d, s, nvec, lane);
  } else if constexpr (kT <= 4) {
    if (w == 4) {
      copy_vectors<uint32_t>(d, s, nvec, lane);
    } else if constexpr (kT <= 2) {
      if (w == 2) {
        copy_vectors<uint16_t>(d, s, nvec, lane);
      } else if constexpr (kT == 1) {
        copy_vectors<uint8_t>(d, s, nvec, lane);
      }
    }
  }
}

// The box of the block a slab fills: block strides, the offset of block[px,
// py, pz], the slab's extents and cells, and divisions by ey and ez.
struct SlabGeom {
  int64_t Y, Z, base;
  uint32_t ey, ez, rows, total;
  FastDiv by_ey, by_ez;
  // the block offset of slab cell `cell` (C order on (i, j, k))
  __device__ __forceinline__ int64_t at(uint32_t cell) const {
    const uint32_t row = by_ez.div(cell);
    const uint32_t k = cell - row * ez;
    const uint32_t i = by_ey.div(row);
    const uint32_t j = row - i * ey;
    return base + ((int64_t)i * Y + j) * Z + k;
  }
};

// The dynamic write's box: SlabGeom at position 0, and each box row i moved
// along the axis by its block's clamped offset (blend_slab_dynamic).
struct DynGeom : SlabGeom {
  const int* pos;  // n offsets, on the device
  int64_t stride;  // block cells an offset step moves: Y * Z, Z or 1
  int64_t top;     // ext - r, the largest offset
  FastDiv by_x;    // box row -> block: by 1 on x, by X on y and z
  __device__ __forceinline__ int64_t shift(uint32_t i) const {
    const int64_t p = pos[by_x.div(i)];
    return (p < 0 ? 0 : (p > top ? top : p)) * stride;
  }
  __device__ __forceinline__ int64_t at(uint32_t cell) const {
    const uint32_t row = by_ez.div(cell);
    const uint32_t i = by_ey.div(row);
    return SlabGeom::at(cell) + shift(i);
  }
};

// The geometry of the slab kernels: SlabGeom, or DynGeom for the dynamic write
template <bool kDynamic>
using Geom = typename std::conditional<kDynamic, DynGeom, SlabGeom>::type;

// kPack: block -> slab; otherwise slab -> block.  kTag only names a launch
// apart in a profile: -1 for the slab packs, the axis for blend_slab and
// blend_slab_dynamic.  kDynamic: each row moved by its block's offset.
template <typename T, bool kPack, int kTag, bool kDynamic = false>
__global__ void slab_rows_kernel(T* __restrict__ block, T* __restrict__ slab, Geom<kDynamic> g) {
  const int lane = threadIdx.x & 31;
  const int bytes = (int)(g.ez * sizeof(T));
  for (uint32_t row = blockIdx.x * kRowWarps + (threadIdx.x >> 5); row < g.rows; row += gridDim.x * kRowWarps) {
    const uint32_t i = g.by_ey.div(row);
    const uint32_t j = row - i * g.ey;
    int64_t at = g.base + ((int64_t)i * g.Y + j) * g.Z;
    if constexpr (kDynamic) at += g.shift(i);
    char* in_block = reinterpret_cast<char*>(block + at);
    char* in_slab = reinterpret_cast<char*>(slab + (int64_t)row * g.ez);
    if (kPack) {
      warp_copy_row<T>(in_slab, in_block, bytes, lane);
    } else {
      warp_copy_row<T>(in_block, in_slab, bytes, lane);
    }
  }
}

template <typename T, bool kPack, int kTag, bool kDynamic = false>
__global__ void __launch_bounds__(kCellThreads)
    slab_cells_kernel(T* __restrict__ block, T* __restrict__ slab, Geom<kDynamic> g, int vec) {
  constexpr int kCells = kStageBytes / (int)sizeof(T);  // cells a block stages
  constexpr int kVecs = kStageBytes / 16 / kCellThreads;
  constexpr int kPer = kCells / kCellThreads;
  static_assert(kPer % kUnroll == 0, "a lane's cells come in kUnroll loads at a time");
  __shared__ uint4 stage[kStageBytes / 16];
  T* cells = reinterpret_cast<T*>(stage);
  const int t = threadIdx.x;
  for (uint32_t c0 = blockIdx.x * kCells; c0 < g.total; c0 += gridDim.x * kCells) {
    const uint32_t n = g.total - c0 < (uint32_t)kCells ? g.total - c0 : (uint32_t)kCells;
    const bool whole = vec && n == (uint32_t)kCells;
    if (kPack) {
      // gather the block's cells in the slab's order, then write the slab
      for (int u0 = 0; u0 < kPer; u0 += kUnroll) {
        T r[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const uint32_t e = t + (u0 + u) * kCellThreads;
          if (e < n) r[u] = block[g.at(c0 + e)];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const uint32_t e = t + (u0 + u) * kCellThreads;
          if (e < n) cells[e] = r[u];
        }
      }
      __syncthreads();
      if (whole) {
        uint4* dst = reinterpret_cast<uint4*>(slab + c0);
#pragma unroll
        for (int u = 0; u < kVecs; ++u) dst[t + u * kCellThreads] = stage[t + u * kCellThreads];
      } else {
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const uint32_t e = t + u * kCellThreads;
          if (e < n) slab[c0 + e] = cells[e];
        }
      }
    } else {
      // stage the slab, all loads before any store, then scatter its cells
      if (whole) {
        const uint4* src = reinterpret_cast<const uint4*>(slab + c0);
        uint4 r[kVecs];
#pragma unroll
        for (int u = 0; u < kVecs; ++u) r[u] = src[t + u * kCellThreads];
#pragma unroll
        for (int u = 0; u < kVecs; ++u) stage[t + u * kCellThreads] = r[u];
      } else {
        T r[kPer];
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const uint32_t e = t + u * kCellThreads;
          if (e < n) r[u] = slab[c0 + e];
        }
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const uint32_t e = t + u * kCellThreads;
          if (e < n) cells[e] = r[u];
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int u = 0; u < kPer; ++u) {
        const uint32_t e = t + u * kCellThreads;
        if (e < n) block[g.at(c0 + e)] = cells[e];
      }
    }
    __syncthreads();
  }
}

template <typename T, bool kPack, int kTag = -1, bool kDynamic = false>
int launch_slab(const Geom<kDynamic>& g, void* block, void* slab, cudaStream_t stream) {
  T* bl = (T*)block;
  T* sl = (T*)slab;
  if ((int64_t)g.ez * (int64_t)sizeof(T) >= kRowBytes) {
    int64_t blocks = ((int64_t)g.rows + kRowWarps - 1) / kRowWarps;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    slab_rows_kernel<T, kPack, kTag, kDynamic><<<(unsigned)blocks, kRowWarps * 32, 0, stream>>>(bl, sl, g);
  } else {
    constexpr int64_t kCells = kStageBytes / sizeof(T);
    int64_t blocks = ((int64_t)g.total + kCells - 1) / kCells;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    const int vec = (reinterpret_cast<uintptr_t>(slab) & 15) == 0;
    slab_cells_kernel<T, kPack, kTag, kDynamic><<<(unsigned)blocks, kCellThreads, 0, stream>>>(bl, sl, g, vec);
  }
  return (int)cudaGetLastError();
}

// The box (px, py, pz) of extent (ex, ey, ez) in a (X, Y, Z) block as a
// SlabGeom; -1 for a box that leaves the block or holds 2^31 cells or more,
// 1 for an empty one, else 0.
int slab_geom(int64_t X, int64_t Y, int64_t Z, int64_t px, int64_t py, int64_t pz, int64_t ex, int64_t ey,
              int64_t ez, SlabGeom* g) {
  if (px < 0 || py < 0 || pz < 0 || ex < 0 || ey < 0 || ez < 0 || px + ex > X || py + ey > Y || pz + ez > Z)
    return -1;
  const int64_t total = ex * ey * ez;
  if (total >= INT32_MAX) return -1;
  if (total == 0) return 1;
  g->Y = Y;
  g->Z = Z;
  g->base = (px * Y + py) * Z + pz;
  g->ey = (uint32_t)ey;
  g->ez = (uint32_t)ez;
  g->rows = (uint32_t)(ex * ey);
  g->total = (uint32_t)total;
  g->by_ey.init(g->ey);
  g->by_ez.init(g->ez);
  return 0;
}

template <bool kPack, int kTag, bool kDynamic = false>
int launch_slab_sized(int64_t itemsize, const Geom<kDynamic>& g, void* block, void* slab, cudaStream_t s) {
  switch (itemsize) {
    case 1: return launch_slab<uint8_t, kPack, kTag, kDynamic>(g, block, slab, s);
    case 2: return launch_slab<uint16_t, kPack, kTag, kDynamic>(g, block, slab, s);
    case 4: return launch_slab<uint32_t, kPack, kTag, kDynamic>(g, block, slab, s);
    case 8: return launch_slab<uint64_t, kPack, kTag, kDynamic>(g, block, slab, s);
    default: return -1;
  }
}

// desc: itemsize, X, Y, Z, px, py, pz, ex, ey, ez (ops/pack.py SLAB_DESC_FIELDS)
template <bool kPack>
int slab_desc(const int64_t* desc, void* block, void* slab, void* stream) {
  SlabGeom g;
  const int rc = slab_geom(desc[1], desc[2], desc[3], desc[4], desc[5], desc[6], desc[7], desc[8], desc[9], &g);
  if (rc != 0) return rc < 0 ? -1 : 0;
  return launch_slab_sized<kPack, -1>(desc[0], g, block, slab, (cudaStream_t)stream);
}

// The box of a blend: the n blocks (n, X, Y, Z) as one block and the slab of
// width r at `pos` on `axis` as a box in it (see the top); -1, 1 or 0 as
// slab_geom.
int blend_geom(int64_t n, int64_t X, int64_t Y, int64_t Z, int64_t axis, int64_t r, int64_t pos, SlabGeom* g) {
  const int64_t ext = axis == 0 ? X : (axis == 1 ? Y : Z);
  if (n < 0 || X < 0 || Y < 0 || Z < 0 || axis < 0 || axis > 2 || r < 0 || pos < 0 || pos + r > ext) return -1;
  if (axis == 0) return slab_geom(n, X * Y, Z, 0, pos * Y, 0, n, r * Y, Z, g);
  if (axis == 1) return slab_geom(n * X, Y, Z, 0, pos, 0, n * X, r, Z, g);
  return slab_geom(n * X, Y, Z, 0, 0, pos, n * X, Y, r, g);
}

template <bool kDynamic>
int launch_blend(int64_t itemsize, int64_t axis, const Geom<kDynamic>& g, void* block, void* slab, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (axis) {
    case 0: return launch_slab_sized<false, 0, kDynamic>(itemsize, g, block, slab, s);
    case 1: return launch_slab_sized<false, 1, kDynamic>(itemsize, g, block, slab, s);
    default: return launch_slab_sized<false, 2, kDynamic>(itemsize, g, block, slab, s);
  }
}

// desc: itemsize, n, X, Y, Z, axis, r, pos (ops/halo_blend.py BLEND_DESC_FIELDS)
int blend_desc(const int64_t* desc, void* block, void* slab, void* stream) {
  SlabGeom g;
  const int rc = blend_geom(desc[1], desc[2], desc[3], desc[4], desc[5], desc[6], desc[7], &g);
  if (rc != 0) return rc < 0 ? -1 : 0;
  return launch_blend<false>(desc[0], desc[5], g, block, slab, stream);
}

// desc: itemsize, n, X, Y, Z, axis, r (ops/halo_blend.py BLEND_DYN_DESC_FIELDS);
// pos: n int32 offsets on the device
int blend_dynamic_desc(const int64_t* desc, void* block, void* slab, const int* pos, void* stream) {
  const int64_t n = desc[1], X = desc[2], Y = desc[3], Z = desc[4], axis = desc[5], r = desc[6];
  DynGeom g;
  const int rc = blend_geom(n, X, Y, Z, axis, r, 0, &g);
  if (rc != 0) return rc < 0 ? -1 : 0;
  if (pos == nullptr) return -1;
  g.pos = pos;
  g.stride = axis == 0 ? Y * Z : (axis == 1 ? Z : 1);
  g.top = (axis == 0 ? X : (axis == 1 ? Y : Z)) - r;
  g.by_x.init(axis == 0 ? 1u : (uint32_t)X);
  return launch_blend<true>(desc[0], axis, g, block, slab, stream);
}

// The y-shell window: strides, the window, rows (b, k, x) and divisions by X
// and depth.
struct YGeom {
  int64_t X, Y, Z, y0;
  uint32_t rows, depth;
  FastDiv by_x, by_depth;
};

// kPack: block -> buf; otherwise buf -> block.
template <typename T, bool kPack>
__global__ void yshell_rows_kernel(T* __restrict__ block, T* __restrict__ buf, YGeom g) {
  const int lane = threadIdx.x & 31;
  const int bytes = (int)(g.Z * (int64_t)sizeof(T));
  for (uint32_t row = blockIdx.x * kRowWarps + (threadIdx.x >> 5); row < g.rows; row += gridDim.x * kRowWarps) {
    const uint32_t bk = g.by_x.div(row);  // row = (b * depth + k) * X + x
    const uint32_t x = row - bk * (uint32_t)g.X;
    const uint32_t b = g.by_depth.div(bk);
    const uint32_t k = bk - b * g.depth;
    char* in_block = reinterpret_cast<char*>(block + (((int64_t)b * g.X + x) * g.Y + g.y0 + k) * g.Z);
    char* in_buf = reinterpret_cast<char*>(buf + (int64_t)row * g.Z);
    if (kPack) {
      warp_copy_row<T>(in_buf, in_block, bytes, lane);
    } else {
      warp_copy_row<T>(in_block, in_buf, bytes, lane);
    }
  }
}

template <typename T, bool kPack>
int launch_yshell(const YGeom& g, void* block, void* buf, cudaStream_t stream) {
  int64_t blocks = ((int64_t)g.rows + kRowWarps - 1) / kRowWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  yshell_rows_kernel<T, kPack><<<(unsigned)blocks, kRowWarps * 32, 0, stream>>>((T*)block, (T*)buf, g);
  return (int)cudaGetLastError();
}

// desc: itemsize, n, X, Y, Z, y0, depth (ops/pack.py YSHELL_DESC_FIELDS)
template <bool kPack>
int yshell_desc(const int64_t* desc, void* block, void* buf, void* stream) {
  const int64_t itemsize = desc[0], n = desc[1], X = desc[2], Y = desc[3], Z = desc[4];
  const int64_t y0 = desc[5], depth = desc[6];
  if (n < 0 || X < 0 || Z < 0 || depth < 1 || y0 < 0 || y0 + depth > Y) return -1;
  const int64_t rows = n * depth * X;
  if (rows >= INT32_MAX || Z * itemsize >= INT32_MAX) return -1;  // rows and a row's bytes are 32-bit
  if (rows == 0 || Z == 0) return 0;
  YGeom g;
  g.X = X;
  g.Y = Y;
  g.Z = Z;
  g.y0 = y0;
  g.rows = (uint32_t)rows;
  g.depth = (uint32_t)depth;
  g.by_x.init((uint32_t)X);
  g.by_depth.init((uint32_t)depth);
  cudaStream_t s = (cudaStream_t)stream;
  switch (itemsize) {
    case 1: return launch_yshell<uint8_t, kPack>(g, block, buf, s);
    case 2: return launch_yshell<uint16_t, kPack>(g, block, buf, s);
    case 4: return launch_yshell<uint32_t, kPack>(g, block, buf, s);
    case 8: return launch_yshell<uint64_t, kPack>(g, block, buf, s);
    default: return -1;
  }
}

// The z shell.  A window is a run of depth cells per (b, x, y) of the block:
// 12 bytes at the route's depth 3 in f32, one every Z cells along y and every
// Y * Z along x, while the buffer holds it transposed, rows of X cells along x.
// A CTA takes a tile of kZT x-columns by kZT y-rows of one block and walks its
// window in chunks of up to 16 bytes of each run (kZK<T> levels), staged in
// shared memory as [y][k][x] with one pad element a row:
//  * the block side: a warp walks kZT / kZWarps y-rows of the tile, and a
//    lane takes the cells lane + 32 j of a row's (x, k) run, k fastest, from
//    offsets it computes once a chunk; so a warp's access covers whole runs of
//    about 32 / depth x-planes at one y and requests each run's sectors at
//    once (at most a 3-way bank conflict at depth 3);
//  * the buffer side: rows (k, y) of kZT consecutive x, a warp a row: 128-byte
//    lines in f32, no bank conflict;
//  * a chunk's loads all issue before its first store: a pack gathers the
//    block's cells (64 / itemsize loads in flight a lane), then writes the
//    buffer rows; an unpack loads the buffer rows, then scatters the cells
//    into the window and stores nothing else.
// At (8, 262^3) that is 9 x 9 x 8 = 648 CTAs of 256 threads.  No TMA and no
// cp.async.bulk, for the reason above (rows of 1,048 bytes).
//
// Bound: bytes, but a run fills part of every 32-byte sector it touches (1.25
// sectors a run at the route's windows, a 1,048-byte row being 24 mod 32): the
// block side moves 21.97 MB of sectors at (8, 262^3) depth 3 against a 6.59 MB
// window, a floor of 8.5 µs for a pack and 15 µs for an unpack, whose partial
// sectors are filled and written back.  The device times sit at about 3x
// those floors whatever the order of the accesses, level with a warp-a-row
// kernel (a warp per (b, y), lanes across x) and with Tensor.copy_ of the same
// window: what sets them is the ~549,000 runs a launch, each a memory access
// of its own, not their order.  Touching each run's sectors in L2 before the
// unpack's stores (a prefetch.global.L2 or a load) made the unpack slower, and
// lanes across the y-rows of one x-plane made both kernels slower (PERF.md).
constexpr int kZT = 32;         // a tile's x-columns and y-rows
constexpr int kZRow = kZT + 1;  // a staged x-run and its pad
constexpr int kZThreads = 256;
constexpr int kZWarps = kZThreads / 32;
template <typename T>
constexpr int kZK = 16 / (int)sizeof(T);  // levels a chunk stages

// The z-shell window: strides, the window and the tile grid.
struct ZGeom {
  int64_t X, Y, Z, YZ, YX, z0;
  uint32_t depth, tiles_y, tiles_xy, tiles;
};

// kPack: block -> buf; otherwise buf -> block.
template <typename T, bool kPack>
__global__ void __launch_bounds__(kZThreads) zshell_tile_kernel(T* __restrict__ block, T* __restrict__ buf, ZGeom g) {
  constexpr int kK = kZK<T>;
  constexpr int kRows = kZT / kZWarps;          // block-side y-rows a warp walks, kK cells of each a lane
  constexpr int kBufRows = kZT * kK / kZWarps;  // buffer rows a warp walks, a cell of each a lane
  __shared__ T stage[kZT * kK * kZRow];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (uint32_t tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
    const uint32_t b = tile / g.tiles_xy;
    const uint32_t rem = tile - b * g.tiles_xy;
    const uint32_t tx = rem / g.tiles_y;  // y tiles fastest: neighbouring CTAs share x-planes
    const int x0 = (int)(tx * kZT), y0 = (int)((rem - tx * g.tiles_y) * kZT);
    const int nx = min(kZT, (int)g.X - x0), ny = min(kZT, (int)g.Y - y0);
    for (uint32_t k0 = 0; k0 < g.depth; k0 += kK) {
      const int kc = min(kK, (int)(g.depth - k0));
      // block[b, x0, y0, z0 + k0] and buf[b, k0, y0, x0]
      T* bl = block + (((int64_t)b * g.X + x0) * g.Y + y0) * g.Z + g.z0 + k0;
      T* bu = buf + ((int64_t)b * g.depth + k0) * g.YX + (int64_t)y0 * g.X + x0;
      // this lane's cells of a y-row: cell lane + 32 j is (x, k) = divmod(., kc)
      int64_t off[kK];  // from the row's start in the block
      int at[kK];       // staged index, less the row's y * kc * kZRow
      bool ok[kK];
#pragma unroll
      for (int j = 0; j < kK; ++j) {
        const int e = lane + 32 * j, x = e / kc, k = e - x * kc;
        ok[j] = j < kc && x < nx;
        off[j] = x * g.YZ + k;
        at[j] = k * kZRow + x;
      }
      if (kPack) {
        T v[kRows][kK];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const int y = warp * kRows + u;
#pragma unroll
          for (int j = 0; j < kK; ++j) {
            if (y < ny && ok[j]) v[u][j] = bl[y * g.Z + off[j]];
          }
        }
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const int y = warp * kRows + u;
#pragma unroll
          for (int j = 0; j < kK; ++j) {
            if (y < ny && ok[j]) stage[y * kc * kZRow + at[j]] = v[u][j];
          }
        }
        __syncthreads();
#pragma unroll
        for (int u = 0; u < kBufRows; ++u) {
          const int row = warp + u * kZWarps, k = row / kZT, y = row % kZT;  // row (k, y)
          if (k < kc && y < ny && lane < nx) {
            bu[k * g.YX + (int64_t)y * g.X + lane] = stage[(y * kc + k) * kZRow + lane];
          }
        }
      } else {
        T r[kBufRows];
#pragma unroll
        for (int u = 0; u < kBufRows; ++u) {
          const int row = warp + u * kZWarps, k = row / kZT, y = row % kZT;
          if (k < kc && y < ny && lane < nx) r[u] = bu[k * g.YX + (int64_t)y * g.X + lane];
        }
#pragma unroll
        for (int u = 0; u < kBufRows; ++u) {
          const int row = warp + u * kZWarps, k = row / kZT, y = row % kZT;
          if (k < kc && y < ny && lane < nx) stage[(y * kc + k) * kZRow + lane] = r[u];
        }
        __syncthreads();
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const int y = warp * kRows + u;
#pragma unroll
          for (int j = 0; j < kK; ++j) {
            if (y < ny && ok[j]) bl[y * g.Z + off[j]] = stage[y * kc * kZRow + at[j]];
          }
        }
      }
      __syncthreads();
    }
  }
}

template <typename T, bool kPack>
int launch_zshell(const ZGeom& g, void* block, void* buf, cudaStream_t stream) {
  const int64_t blocks = g.tiles < kMaxBlocks ? g.tiles : kMaxBlocks;
  zshell_tile_kernel<T, kPack><<<(unsigned)blocks, kZThreads, 0, stream>>>((T*)block, (T*)buf, g);
  return (int)cudaGetLastError();
}

// desc: itemsize, n, X, Y, Z, z0, depth (ops/pack.py ZSHELL_DESC_FIELDS)
template <bool kPack>
int zshell_desc(const int64_t* desc, void* block, void* buf, void* stream) {
  const int64_t itemsize = desc[0], n = desc[1], X = desc[2], Y = desc[3], Z = desc[4];
  const int64_t z0 = desc[5], depth = desc[6];
  if (n < 0 || X < 0 || Y < 0 || depth < 1 || z0 < 0 || z0 + depth > Z) return -1;
  const int64_t tiles_y = (Y + kZT - 1) / kZT, tiles_xy = (X + kZT - 1) / kZT * tiles_y;
  if (X >= INT32_MAX || Y >= INT32_MAX || depth >= INT32_MAX || n * tiles_xy >= INT32_MAX) return -1;
  if (n * tiles_xy == 0) return 0;
  ZGeom g;
  g.X = X;
  g.Y = Y;
  g.Z = Z;
  g.YZ = Y * Z;
  g.YX = Y * X;
  g.z0 = z0;
  g.depth = (uint32_t)depth;
  g.tiles_y = (uint32_t)tiles_y;
  g.tiles_xy = (uint32_t)tiles_xy;
  g.tiles = (uint32_t)(n * tiles_xy);
  cudaStream_t s = (cudaStream_t)stream;
  switch (itemsize) {
    case 1: return launch_zshell<uint8_t, kPack>(g, block, buf, s);
    case 2: return launch_zshell<uint16_t, kPack>(g, block, buf, s);
    case 4: return launch_zshell<uint32_t, kPack>(g, block, buf, s);
    case 8: return launch_zshell<uint64_t, kPack>(g, block, buf, s);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// Each returns a cudaError_t, or -1 for an itemsize the kernels do not take
// (or a row longer than an int counts, or a box or window that leaves the
// block).
int stp_pack_slab_desc(const int64_t* desc, const void* block, void* slab, void* stream) {
  return slab_desc<true>(desc, const_cast<void*>(block), slab, stream);
}

int stp_unpack_slab_desc(const int64_t* desc, void* block, const void* slab, void* stream) {
  return slab_desc<false>(desc, block, const_cast<void*>(slab), stream);
}

int stp_blend_slab_desc(const int64_t* desc, void* block, const void* slab, void* stream) {
  return blend_desc(desc, block, const_cast<void*>(slab), stream);
}

int stp_blend_slab_dynamic_desc(const int64_t* desc, void* block, const void* slab, const int* pos, void* stream) {
  return blend_dynamic_desc(desc, block, const_cast<void*>(slab), pos, stream);
}

int stp_pack_zshell_desc(const int64_t* desc, const void* block, void* buf, void* stream) {
  return zshell_desc<true>(desc, const_cast<void*>(block), buf, stream);
}

int stp_unpack_zshell_desc(const int64_t* desc, void* block, const void* buf, void* stream) {
  return zshell_desc<false>(desc, block, const_cast<void*>(buf), stream);
}

int stp_pack_yshell_desc(const int64_t* desc, const void* block, void* buf, void* stream) {
  return yshell_desc<true>(desc, const_cast<void*>(block), buf, stream);
}

int stp_unpack_yshell_desc(const int64_t* desc, void* block, const void* buf, void* stream) {
  return yshell_desc<false>(desc, block, const_cast<void*>(buf), stream);
}

const char* stp_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
