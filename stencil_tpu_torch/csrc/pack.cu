// Pack kernels for Hopper (sm_90a), bound to Python through ctypes
// (stencil_tpu_torch/kernels/build.py, stencil_tpu_torch/ops/pack.py).
//
// The slab packs of bench-pack and make_pack_fn_pallas take one block
// (X, Y, Z) and a box at (px, py, pz) of extent (ex, ey, ez):
//
//   stp_pack_slab      replaces stencil_tpu/ops/pack.py:197 pallas_pack_slab:
//                      slab[i, j, k] = block[px + i, py + j, pz + k]
//   stp_unpack_slab    replaces stencil_tpu/ops/pack.py:225 pallas_unpack_slab:
//                      block[px + i, py + j, pz + k] = slab[i, j, k], in place
//
// The TPU kernels DMA whole x-planes into VMEM and cut the window there (an
// HBM DMA must not cut the (8,128) tiling); the port keeps the box copy, the
// reference's grid_pack / grid_unpack (pack_kernel.cuh:16-40, copy.cuh:26-64).
// Bound on an H100 SXM: bytes, the box read once and written once.  Design:
// one thread per slab element, the slab walked in its C order, so a warp
// covers consecutive z (then y) cells: the slab side always coalesces, and
// the block side does for the x and y faces; on a z face (ez = 3 at radius 3)
// each (x, y) of the block is an ez-wide run, a 32-byte sector for ez *
// itemsize wanted bytes, the cost the z shell packs pay too (PERF.md).  The
// slab index is 32-bit (the wrapper refuses 2^31 cells), block offsets
// 64-bit.
//
// The shell packs of the packed exchange routes each take n blocks
// (n, X, Y, Z) and a window of `depth` cells starting at `start` on one axis:
//
//   stp_pack_zshell    replaces stencil_tpu/ops/pack.py:331 pack_zshell_pallas:
//                      buf[b, k, y, x] = block[b, x, y, start + k]
//   stp_unpack_zshell  replaces stencil_tpu/ops/pack.py:358 unpack_zshell_pallas:
//                      block[b, x, y, start + k] = buf[b, k, y, x], in place
//   stp_pack_yshell    replaces stencil_tpu/ops/pack.py:422 pack_yshell_pallas:
//                      buf[b, k, x, z] = block[b, x, start + k, z]
//   stp_unpack_yshell  replaces stencil_tpu/ops/pack.py:449 unpack_yshell_pallas:
//                      block[b, x, start + k, z] = buf[b, k, x, z], in place
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
// depth * (the other two extents) * itemsize.  Design: one warp per row, a row
// being a run of the window that the warp walks 32 elements at a time, with
// kUnroll loads in flight before their stores.  y shell: a row is (b, k, x),
// Z cells contiguous on both sides, so loads and stores coalesce.  z shell: a
// row is (b, y), its X * depth cells in the block's order (x, then k), so
// consecutive lanes touch the depth consecutive cells of one z run of the
// block and the next x's; the buffer side reads (or writes) depth x-runs of
// about 32 / depth cells each.  A z window costs a 32-byte sector per (x, y)
// of the block whatever the kernel does (depth * itemsize bytes of it are
// wanted, and an unpack writes the sector in part), so a shared-memory
// transpose would gain nothing here; what counts is that a warp's store covers
// each sector's depth cells at once (a lane per x looping over k stores each
// sector depth times, and measured about twice as slow on the unpack:
// PERF.md).  Row bases are 64-bit; a row's run fits an int.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows per block
constexpr int kUnroll = 4;  // loads in flight per lane
constexpr int64_t kMaxBlocks = 132 * 32;

// Element i of a z-shell row (b, y): x = i / depth, k = i % depth.
struct ZRow {
  int64_t block, buf, yz, yx;  // row bases; the block's x stride, the buffer's k stride
  int depth;
  __device__ int64_t block_at(int i) const {
    const int x = i / depth;
    return block + x * yz + (i - x * depth);
  }
  __device__ int64_t buf_at(int i) const {
    const int x = i / depth;
    return buf + (i - x * depth) * yx + x;
  }
};

// Element i of a y-shell row (b, k, x): z = i on both sides.
struct YRow {
  int64_t block, buf;
  __device__ int64_t block_at(int i) const { return block + i; }
  __device__ int64_t buf_at(int i) const { return buf + i; }
};

// One row's run of `run` elements, walked by the 32 lanes of a warp.
// kPack: block -> buf; otherwise buf -> block.
template <typename T, bool kPack, typename Row>
__device__ __forceinline__ void copy_row(T* __restrict__ block, T* __restrict__ buf, const Row& r,
                                         int run, int lane) {
  for (int i0 = lane; i0 < run; i0 += 32 * kUnroll) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * 32;
      if (i < run) v[u] = kPack ? block[r.block_at(i)] : buf[r.buf_at(i)];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * 32;
      if (i < run) {
        if (kPack) {
          buf[r.buf_at(i)] = v[u];
        } else {
          block[r.block_at(i)] = v[u];
        }
      }
    }
  }
}

template <typename T, bool kPack>
__global__ void zshell_kernel(T* __restrict__ block, T* __restrict__ buf, int64_t rows, int64_t X,
                              int64_t Y, int64_t Z, int64_t start, int depth) {
  const int lane = threadIdx.x & 31;
  for (int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5); row < rows;
       row += (int64_t)gridDim.x * kWarps) {
    const int64_t b = row / Y;
    const int64_t y = row - b * Y;
    // block[b, 0, y, start] and buf[b, 0, y, 0]
    const ZRow r{(b * X * Y + y) * Z + start, (b * depth * Y + y) * X, Y * Z, Y * X, depth};
    copy_row<T, kPack>(block, buf, r, (int)(X * depth), lane);
  }
}

template <typename T, bool kPack>
__global__ void yshell_kernel(T* __restrict__ block, T* __restrict__ buf, int64_t rows, int64_t X,
                              int64_t Y, int64_t Z, int64_t start, int depth) {
  const int lane = threadIdx.x & 31;
  for (int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5); row < rows;
       row += (int64_t)gridDim.x * kWarps) {
    // row = (b * depth + k) * X + x, the buffer's row order
    const int64_t x = row % X;
    const int64_t bk = row / X;
    const int64_t k = bk % depth;
    const int64_t b = bk / depth;
    const YRow r{((b * X + x) * Y + start + k) * Z, row * Z};
    copy_row<T, kPack>(block, buf, r, (int)Z, lane);
  }
}

template <typename T>
int launch(bool z, bool pack, void* block, void* buf, int64_t n, int64_t X, int64_t Y, int64_t Z,
           int64_t start, int64_t depth, cudaStream_t stream) {
  const int64_t rows = z ? n * Y : n * depth * X;
  if ((z ? X * depth : Z) > INT32_MAX) return -1;  // a row's run is an int
  if (rows == 0 || X == 0 || Z == 0 || depth == 0) return 0;
  int64_t blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const unsigned g = (unsigned)blocks;
  T* bl = (T*)block;
  T* bu = (T*)buf;
  const int d = (int)depth;
  if (z && pack) zshell_kernel<T, true><<<g, kWarps * 32, 0, stream>>>(bl, bu, rows, X, Y, Z, start, d);
  if (z && !pack) zshell_kernel<T, false><<<g, kWarps * 32, 0, stream>>>(bl, bu, rows, X, Y, Z, start, d);
  if (!z && pack) yshell_kernel<T, true><<<g, kWarps * 32, 0, stream>>>(bl, bu, rows, X, Y, Z, start, d);
  if (!z && !pack) yshell_kernel<T, false><<<g, kWarps * 32, 0, stream>>>(bl, bu, rows, X, Y, Z, start, d);
  return (int)cudaGetLastError();
}

constexpr int kSlabThreads = 256;

// kPack: block -> slab; otherwise slab -> block.  i runs over the slab in
// C order; total < 2^31, so i + the grid stride stays below 2^32.
template <typename T, bool kPack>
__global__ void slab_kernel(T* __restrict__ block, T* __restrict__ slab, unsigned total, unsigned ey,
                            unsigned ez, int64_t Y, int64_t Z, int64_t px, int64_t py, int64_t pz) {
  for (unsigned i = blockIdx.x * kSlabThreads + threadIdx.x; i < total; i += gridDim.x * kSlabThreads) {
    const unsigned row = i / ez;  // (x, y) of the slab
    const unsigned k = i - row * ez;
    const unsigned x = row / ey;
    const unsigned j = row - x * ey;
    const int64_t at = ((px + x) * Y + py + j) * Z + pz + k;
    if (kPack) {
      slab[i] = block[at];
    } else {
      block[at] = slab[i];
    }
  }
}

template <typename T>
int launch_slab(bool pack, void* block, void* slab, int64_t Y, int64_t Z, int64_t px, int64_t py,
                int64_t pz, int64_t ex, int64_t ey, int64_t ez, cudaStream_t stream) {
  const int64_t total = ex * ey * ez;
  if (total >= INT32_MAX) return -1;
  if (total == 0) return 0;
  int64_t blocks = (total + kSlabThreads - 1) / kSlabThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  T* bl = (T*)block;
  T* sl = (T*)slab;
  const unsigned t = (unsigned)total;
  if (pack) {
    slab_kernel<T, true><<<(unsigned)blocks, kSlabThreads, 0, stream>>>(bl, sl, t, (unsigned)ey,
                                                                        (unsigned)ez, Y, Z, px, py, pz);
  } else {
    slab_kernel<T, false><<<(unsigned)blocks, kSlabThreads, 0, stream>>>(bl, sl, t, (unsigned)ey,
                                                                         (unsigned)ez, Y, Z, px, py, pz);
  }
  return (int)cudaGetLastError();
}

int dispatch_slab(bool pack, void* block, void* slab, int itemsize, int64_t X, int64_t Y, int64_t Z,
                  int64_t px, int64_t py, int64_t pz, int64_t ex, int64_t ey, int64_t ez,
                  void* stream) {
  if (px < 0 || py < 0 || pz < 0 || px + ex > X || py + ey > Y || pz + ez > Z) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  switch (itemsize) {
    case 1: return launch_slab<uint8_t>(pack, block, slab, Y, Z, px, py, pz, ex, ey, ez, s);
    case 2: return launch_slab<uint16_t>(pack, block, slab, Y, Z, px, py, pz, ex, ey, ez, s);
    case 4: return launch_slab<uint32_t>(pack, block, slab, Y, Z, px, py, pz, ex, ey, ez, s);
    case 8: return launch_slab<uint64_t>(pack, block, slab, Y, Z, px, py, pz, ex, ey, ez, s);
    default: return -1;
  }
}

int dispatch(bool z, bool pack, void* block, void* buf, int itemsize, int64_t n, int64_t X,
             int64_t Y, int64_t Z, int64_t start, int64_t depth, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (itemsize) {
    case 1: return launch<uint8_t>(z, pack, block, buf, n, X, Y, Z, start, depth, s);
    case 2: return launch<uint16_t>(z, pack, block, buf, n, X, Y, Z, start, depth, s);
    case 4: return launch<uint32_t>(z, pack, block, buf, n, X, Y, Z, start, depth, s);
    case 8: return launch<uint64_t>(z, pack, block, buf, n, X, Y, Z, start, depth, s);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// Each returns a cudaError_t, or -1 for an itemsize the kernels do not take
// (or a row longer than an int counts, or a box that leaves the block).
int stp_pack_slab(void* block, void* slab, int itemsize, int64_t X, int64_t Y, int64_t Z, int64_t px,
                  int64_t py, int64_t pz, int64_t ex, int64_t ey, int64_t ez, void* stream) {
  return dispatch_slab(true, block, slab, itemsize, X, Y, Z, px, py, pz, ex, ey, ez, stream);
}

int stp_unpack_slab(void* block, void* slab, int itemsize, int64_t X, int64_t Y, int64_t Z,
                    int64_t px, int64_t py, int64_t pz, int64_t ex, int64_t ey, int64_t ez,
                    void* stream) {
  return dispatch_slab(false, block, slab, itemsize, X, Y, Z, px, py, pz, ex, ey, ez, stream);
}

int stp_pack_zshell(void* block, void* buf, int itemsize, int64_t n, int64_t X, int64_t Y,
                    int64_t Z, int64_t z0, int64_t depth, void* stream) {
  return dispatch(true, true, block, buf, itemsize, n, X, Y, Z, z0, depth, stream);
}

int stp_unpack_zshell(void* block, void* buf, int itemsize, int64_t n, int64_t X, int64_t Y,
                      int64_t Z, int64_t z0, int64_t depth, void* stream) {
  return dispatch(true, false, block, buf, itemsize, n, X, Y, Z, z0, depth, stream);
}

int stp_pack_yshell(void* block, void* buf, int itemsize, int64_t n, int64_t X, int64_t Y,
                    int64_t Z, int64_t y0, int64_t depth, void* stream) {
  return dispatch(false, true, block, buf, itemsize, n, X, Y, Z, y0, depth, stream);
}

int stp_unpack_yshell(void* block, void* buf, int itemsize, int64_t n, int64_t X, int64_t Y,
                      int64_t Z, int64_t y0, int64_t depth, void* stream) {
  return dispatch(false, false, block, buf, itemsize, n, X, Y, Z, y0, depth, stream);
}

const char* stp_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
