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
//
// The contraction form (compute_unit "mxu" / "mxu_band",
// plane_stencil.py:149-215; stp_mean6_plane_level_mxu for float32 blocks,
// _mxu_bf16 for bf16 storage, each taking mxu_input 1 = f32 operands as
// three TF32 pieces, 2 = bf16 operands): a window cell's level is (x-1 +
// x+1) + (ysum + zsum), up(prev) + up(cur) + nbr as the JAX kernel sums
// it, the in-plane sums contracted on the tensor cores (csrc/band_mma.cuh).
// A block of 8 warps stages a 32 x 64 tile of the centre plane at f32 with a
// one-cell apron (0 past the plane's edge), contracts it, one 16 x 16 piece
// a warp, into a second shared plane, and computes the 30 x 62 cells inside
// the apron; then the next x plane.  The JAX kernel takes nbr over the
// whole (Y, Z) plane and slices the window out; a window cell's neighbours
// lie in the plane (every shell width >= 1), so the tile's sums are the
// same.  Shell planes and shell cells pass through.  An f64 block has no
// contraction form (the JAX kernel asserts an f32 accumulator).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "band_mma.cuh"

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

// --- the contraction form ---------------------------------------------------------

constexpr int kSR = 32, kSC = 64;            // the staged tile, its one-cell apron included
constexpr int kOR = kSR - 2, kOC = kSC - 2;  // the cells it computes

// grid: (ceil(Z/62), ceil(Y/30), min(X, 65535)), blocks of 32 x 8 threads;
// x strides by gridDim.z.  kUnit: 1 TF32 pieces, 2 bf16 operands.
template <typename S, int kUnit>
__global__ void __launch_bounds__(256) mean6_plane_mxu(const S* __restrict__ src, S* __restrict__ dst, int X,
                                                       int Y, int Z, int lox, int loy, int loz, int hix,
                                                       int hiy, int hiz) {
  __shared__ __align__(16) float stage[kSR * kSC];
  __shared__ __align__(16) float nb[kSR * kSC];
  const int y0 = blockIdx.y * kOR - 1, z0 = blockIdx.x * kOC - 1;  // tile cell (0, 0)
  const int64_t plane = (int64_t)Y * Z;
  const int warp = threadIdx.y, lane = threadIdx.x;
  for (int x = blockIdx.z; x < X; x += gridDim.z) {
    const bool in_x = x >= lox && x < X - hix;
    const S* cp = src + x * plane;
    if (in_x) {
      for (int r = threadIdx.y; r < kSR; r += 8)
        for (int c = threadIdx.x; c < kSC; c += 32) {
          const int y = y0 + r, z = z0 + c;
          stage[r * kSC + c] = y >= 0 && y < Y && z >= 0 && z < Z ? up(cp[(int64_t)y * Z + z]) : 0.0f;
        }
      __syncthreads();
      band_mma::piece_to_plane<kUnit, kSR, kSC, kSC, kSC>(stage, nb, warp, lane);
      __syncthreads();
    }
    for (int r = 1 + threadIdx.y; r <= kOR; r += 8) {
      const int y = y0 + r;
      if (y >= Y) break;
      for (int c = 1 + threadIdx.x; c <= kOC; c += 32) {
        const int z = z0 + c;
        if (z >= Z) break;
        const int64_t idx = x * plane + (int64_t)y * Z + z;
        if (!in_x || y < loy || y >= Y - hiy || z < loz || z >= Z - hiz) {
          dst[idx] = src[idx];  // shell cells pass through
          continue;
        }
        float s = up(src[idx - plane]);
        s = s + up(src[idx + plane]);
        s = s + nb[r * kSC + c];
        dst[idx] = down<S, float>(s * sixth<float>());
      }
    }
    __syncthreads();  // this plane's reads of the tile before the next plane's staging
  }
}

template <typename S>
int level_mxu(const void* src, void* dst, int X, int Y, int Z, int lox, int loy, int loz, int hix, int hiy, int hiz,
              int mxu_input, void* stream) {
  if (lox < 1 || loy < 1 || loz < 1 || hix < 1 || hiy < 1 || hiz < 1 || (mxu_input != 1 && mxu_input != 2))
    return -1;
  const dim3 grid((Z + kOC - 1) / kOC, (Y + kOR - 1) / kOR, (unsigned)(X < kMaxGridZ ? X : kMaxGridZ));
  const S* s = static_cast<const S*>(src);
  S* d = static_cast<S*>(dst);
  if (mxu_input == 1)
    mean6_plane_mxu<S, 1><<<grid, dim3(32, 8), 0, (cudaStream_t)stream>>>(s, d, X, Y, Z, lox, loy, loz, hix, hiy, hiz);
  else
    mean6_plane_mxu<S, 2><<<grid, dim3(32, 8), 0, (cudaStream_t)stream>>>(s, d, X, Y, Z, lox, loy, loz, hix, hiy, hiz);
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

// The contraction form of one level (mxu_input 1: f32 operands as three
// TF32 pieces, 2: bf16 operands): float32 blocks, and bf16 storage with f32
// accumulation.  Returns a cudaError_t, or -1 for a shell narrower than 1 on
// some side or another mxu_input.
int stp_mean6_plane_level_mxu(const void* src, void* dst, int X, int Y, int Z, int lox, int loy, int loz, int hix,
                              int hiy, int hiz, int mxu_input, void* stream) {
  return level_mxu<float>(src, dst, X, Y, Z, lox, loy, loz, hix, hiy, hiz, mxu_input, stream);
}
int stp_mean6_plane_level_mxu_bf16(const void* src, void* dst, int X, int Y, int Z, int lox, int loy, int loz,
                                   int hix, int hiy, int hiz, int mxu_input, void* stream) {
  return level_mxu<__nv_bfloat16>(src, dst, X, Y, Z, lox, loy, loz, hix, hiy, hiz, mxu_input, stream);
}

const char* stp_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
