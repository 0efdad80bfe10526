// The mean-of-6 plane kernel for Hopper (sm_90a), bound to Python through
// ctypes (stencil_tpu_torch/kernels/build.py,
// stencil_tpu_torch/ops/plane_stencil.py).
//
// stp_mean6_plane_level replaces stencil_tpu/ops/plane_stencil.py:114
//   mean6_plane_step: one mean-of-6 level over an (X, Y, Z) block whose
//   window [lo, N - hi) per axis is computed and whose shell (any per-axis
//   widths lo, hi >= 1) passes through unchanged.  It is csrc/jacobi.cu's
//   plane_level with the radius-1 ring test widened to the window and no
//   sphere clamp.  The TPU kernel streams x-planes through a two-plane VMEM
//   ring; here one thread computes one cell and the neighbour re-reads are
//   left to L1/L2.
//
// Bound on an H100 SXM: bytes, each cell read once and written once (8 B a
// cell against 6 f32 operations): at 518^3 that is 1.11 GB, 0.33 ms at 3.35
// TB/s.  Threads run z on threadIdx.x, so a warp reads 128 contiguous bytes
// per neighbour.
//
// Bitwise contract with the JAX package, as csrc/jacobi.cu: the six
// neighbours summed as a left fold x-1, x+1, y-1, y+1, z-1, z+1
// (plane_stencil.py:188-195); the mean a multiply by 0x1.555556p-3f, the
// constant XLA puts in place of `/ 6.0` (at float64 by the double
// reciprocal 0x1.5555555555555p-3); built without fast-math and with
// --fmad=false.  Offsets are 64-bit.
//
// Field dtypes (plane_stencil.py:114-117, :148): one kernel body templated
// on the storage type S and the working type C, one C entry each: float /
// float (stp_mean6_plane_level), bf16 storage with f32 accumulation
// (`f32_accumulate`: each neighbour upcast, the mean at f32, one rounding to
// nearest even at the store; the shell passes through as its stored bytes;
// stp_mean6_plane_level_bf16) and double / double
// (stp_mean6_plane_level_f64).  Bound at bf16: 4 B a cell; at f64: 16 B.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename C>
__device__ __forceinline__ C sixth();
template <>
__device__ __forceinline__ float sixth<float>() { return 0x1.555556p-3f; }  // == np.float32(1 / 6)
template <>
__device__ __forceinline__ double sixth<double>() { return 0x1.5555555555555p-3; }  // == np.float64(1) / 6

// a stored cell at the working type, and a working value as stored
__device__ __forceinline__ float up(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float up(float v) { return v; }
__device__ __forceinline__ double up(double v) { return v; }
template <typename S, typename C>
__device__ __forceinline__ S down(C v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 down<__nv_bfloat16, float>(float v) { return __float2bfloat16_rn(v); }

constexpr int kTileZ = 32;
constexpr int kTileY = 8;
constexpr int kMaxGridZ = 65535;

// grid: (ceil(Z/32), ceil(Y/8), min(X, 65535)); x strides by gridDim.z
template <typename S, typename C>
__global__ void mean6_plane_level(const S* __restrict__ src, S* __restrict__ dst, int X,
                                  int Y, int Z, int lox, int loy, int loz, int hix, int hiy,
                                  int hiz) {
  const int z = blockIdx.x * kTileZ + threadIdx.x;
  const int y = blockIdx.y * kTileY + threadIdx.y;
  if (z >= Z || y >= Y) return;
  const int64_t plane = (int64_t)Y * Z;
  const bool shell_yz = y < loy || y >= Y - hiy || z < loz || z >= Z - hiz;
  for (int x = blockIdx.z; x < X; x += gridDim.z) {
    const int64_t idx = x * plane + (int64_t)y * Z + z;
    if (shell_yz || x < lox || x >= X - hix) {
      dst[idx] = src[idx];  // shell cells pass through
      continue;
    }
    C s = up(src[idx - plane]);
    s = s + up(src[idx + plane]);
    s = s + up(src[idx - Z]);
    s = s + up(src[idx + Z]);
    s = s + up(src[idx - 1]);
    s = s + up(src[idx + 1]);
    dst[idx] = down<S, C>(s * sixth<C>());
  }
}

// Returns a cudaError_t, or -1 for a shell narrower than 1 on some side.
template <typename S, typename C>
int level(const void* src, void* dst, int X, int Y, int Z, int lox, int loy, int loz, int hix, int hiy, int hiz,
          void* stream) {
  if (lox < 1 || loy < 1 || loz < 1 || hix < 1 || hiy < 1 || hiz < 1) return -1;
  const dim3 grid((Z + kTileZ - 1) / kTileZ, (Y + kTileY - 1) / kTileY,
                  (unsigned)(X < kMaxGridZ ? X : kMaxGridZ));
  mean6_plane_level<S, C><<<grid, dim3(kTileZ, kTileY), 0, (cudaStream_t)stream>>>(
      static_cast<const S*>(src), static_cast<S*>(dst), X, Y, Z, lox, loy, loz, hix, hiy, hiz);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One mean-of-6 level of an (X, Y, Z) block `src` into `dst` (apart), the
// window [lo, N - hi) computed and the shell copied: float32, bf16 storage
// with f32 accumulation, float64.  Returns a cudaError_t, or -1 for a shell
// narrower than 1 on some side.
int stp_mean6_plane_level(const void* src, void* dst, int X, int Y, int Z, int lox, int loy, int loz, int hix,
                          int hiy, int hiz, void* stream) {
  return level<float, float>(src, dst, X, Y, Z, lox, loy, loz, hix, hiy, hiz, stream);
}
int stp_mean6_plane_level_bf16(const void* src, void* dst, int X, int Y, int Z, int lox, int loy, int loz, int hix,
                               int hiy, int hiz, void* stream) {
  return level<__nv_bfloat16, float>(src, dst, X, Y, Z, lox, loy, loz, hix, hiy, hiz, stream);
}
int stp_mean6_plane_level_f64(const void* src, void* dst, int X, int Y, int Z, int lox, int loy, int loz, int hix,
                              int hiy, int hiz, void* stream) {
  return level<double, double>(src, dst, X, Y, Z, lox, loy, loz, hix, hiy, hiz, stream);
}

const char* stp_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
