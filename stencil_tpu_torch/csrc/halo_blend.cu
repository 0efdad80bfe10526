// Halo slab write for Hopper (sm_90a), bound to Python through ctypes
// (stencil_tpu_torch/kernels/build.py, stencil_tpu_torch/ops/halo_blend.py).
//
// blend_slab (stencil_tpu/ops/halo_blend.py:84), the same write at a static
// offset, is the slab unpack of csrc/pack.cu on its descriptor path
// (stp_blend_slab_desc): a one-thread-a-cell scatter with three 64-bit
// divisions a cell, as the kernel below still is, lost 4-6x to the write's
// bound at the exchange's shapes (PERF.md).
//
// stp_blend_slab_dynamic replaces stencil_tpu/ops/halo_blend.py:179
// blend_slab_dynamic: the same write at an offset known only at run time, one
// per block (pos[b], an int32 device array), which is where the +axis halo of
// a padded (uneven) axis lands: right after the block's own valid cells, so
// only the last subdomain on that axis differs.  The TPU kernel visits the
// (8,128) tiles the slab can touch and masks rows with iotas; none of that is
// needed here: the kernel is a strided scatter, one thread a slab element,
// grid-stride, the element copied as an unsigned integer of its width (1, 2,
// 4 or 8 bytes), with the block's base index read from pos.  An offset
// outside [0, extent - r] is clamped into it, as lax.dynamic_update_slice does
// (the wrapper checks nothing on the device, so a call never synchronizes).  It takes axis 0 as well: the JAX package
// writes the x halo with a dynamic_update_slice, but a sub-view of the port's
// (n, X, Y, Z) stack is not contiguous, so the port sends all three axes here.
// Bound on an H100 SXM: bytes, the slab read once and the same bytes written
// into the block, plus n int32 offsets.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;

template <typename T>
__global__ void blend_slab_dynamic_kernel(T* __restrict__ block, const T* __restrict__ slab,
                                          const int* __restrict__ pos, int64_t count,
                                          int64_t sx, int64_t sy, int64_t sz, int64_t X,
                                          int64_t Y, int64_t Z, int axis, int64_t r) {
  const int64_t ext = axis == 0 ? X : (axis == 1 ? Y : Z);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += (int64_t)gridDim.x * blockDim.x) {
    int64_t t = i;
    int64_t z = t % sz;
    t /= sz;
    int64_t y = t % sy;
    t /= sy;
    int64_t x = t % sx;
    const int64_t b = t / sx;
    int64_t p = pos[b];
    p = p < 0 ? 0 : (p > ext - r ? ext - r : p);
    if (axis == 0) x += p;
    if (axis == 1) y += p;
    if (axis == 2) z += p;
    block[((b * X + x) * Y + y) * Z + z] = slab[i];
  }
}

template <typename T>
int launch_dynamic(void* block, const void* slab, const int* pos, int64_t n, int64_t X,
                   int64_t Y, int64_t Z, int axis, int64_t r, cudaStream_t stream) {
  const int64_t sx = axis == 0 ? r : X;
  const int64_t sy = axis == 1 ? r : Y;
  const int64_t sz = axis == 2 ? r : Z;
  const int64_t count = n * sx * sy * sz;
  if (count == 0) return 0;
  int64_t blocks = (count + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  blend_slab_dynamic_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (T*)block, (const T*)slab, pos, count, sx, sy, sz, X, Y, Z, axis, r);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// pos: n int32 offsets on the device, one per block.  Returns a cudaError_t,
// or -1 for an itemsize the kernel does not take.
int stp_blend_slab_dynamic(void* block, const void* slab, const int* pos, int itemsize,
                           int64_t n, int64_t X, int64_t Y, int64_t Z, int axis, int64_t r,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (itemsize) {
    case 1: return launch_dynamic<uint8_t>(block, slab, pos, n, X, Y, Z, axis, r, s);
    case 2: return launch_dynamic<uint16_t>(block, slab, pos, n, X, Y, Z, axis, r, s);
    case 4: return launch_dynamic<uint32_t>(block, slab, pos, n, X, Y, Z, axis, r, s);
    case 8: return launch_dynamic<uint64_t>(block, slab, pos, n, X, Y, Z, axis, r, s);
    default: return -1;
  }
}

const char* stp_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
