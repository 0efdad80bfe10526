// The Jacobi plane kernel for Hopper (sm_90a), bound to Python through
// ctypes (stencil_tpu_torch/kernels/build.py,
// stencil_tpu_torch/ops/jacobi_kernels.py).
//
// stp_jacobi_plane_level replaces stencil_tpu/ops/jacobi_pallas.py:1484
//   jacobi_plane_step: one level (mean of the six face neighbours plus the
//   hot/cold sphere clamps) over n radius-1 shell-carrying blocks in one
//   launch (the leading block dimension stands in for shard_map); shell
//   cells are copied through.  (jacobi_wrap_step, jacobi_pallas.py:869, is
//   the wrap form of csrc/jacobi_wavefront.cu.)
//
// Bound on an H100 SXM: bytes.  A level reads each cell once and writes it
// once, 8 B/cell, against ~7 flops/cell: at 512^3 that is 1.07 GB, 0.32 ms at
// 3.35 TB/s, while the flops need ~0.01 ms at 67 TFLOP/s f32.  The design is
// the simple one: one thread per cell, z on threadIdx.x so a warp reads 128
// contiguous bytes per neighbour, neighbour re-reads left to L1/L2.
//
// Bitwise contract with the JAX package:
//  * the six neighbours are summed as a left fold in the TPU kernels' order
//    x-1, x+1, y-1, y+1, z-1, z+1 (jacobi_pallas.py:515-524, :1518-1525);
//  * XLA compiles `sum / 6.0` as `sum * float32(1/6)`, so the mean is a
//    multiply by the f32 constant 0x1.555556p-3, not an IEEE divide (a
//    divide differs by 1 ulp on some cells);
//  * built without fast-math and with --fmad=false, so nothing contracts;
//  * the sphere test is integer: d2 < in_r2 - (x_g - centre_x)^2 with
//    in_r2 = (gx/10 + 1)^2 and gx the GLOBAL x extent;
//  * x_g uses a non-negative modulo (C's % keeps the dividend's sign).
// Linear offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kSixth = 0x1.555556p-3f;  // == np.float32(1 / 6)
constexpr float kHot = 1.0f;
constexpr float kCold = 0.0f;
constexpr int kTileZ = 32;
constexpr int kTileY = 8;
constexpr int kMaxGridZ = 65535;

__device__ __forceinline__ int pmod(int a, int n) {
  int m = a % n;
  return m < 0 ? m + n : m;
}

__device__ __forceinline__ float clamp_spheres(float v, int d2, int x_g, int hot_x,
                                               int cold_x, int in_r2) {
  int hx = x_g - hot_x;
  if (d2 < in_r2 - hx * hx) v = kHot;
  int cx = x_g - cold_x;
  if (d2 < in_r2 - cx * cx) v = kCold;
  return v;
}

// grid: (ceil(Z/32), ceil(Y/8), min(n*X, 65535)); p = block*X + x strides by
// gridDim.z.  origins: (n, 3) int32; yz_d2: (n, Y-2, Z-2) int32.
__global__ void plane_level(const float* __restrict__ src, float* __restrict__ dst,
                            const int* __restrict__ origins, const int* __restrict__ yz_d2,
                            int n, int X, int Y, int Z, int gx, int hot_x, int cold_x,
                            int in_r2) {
  const int z = blockIdx.x * kTileZ + threadIdx.x;
  const int y = blockIdx.y * kTileY + threadIdx.y;
  if (z >= Z || y >= Y) return;
  const int64_t plane = (int64_t)Y * Z;
  const bool ring = y == 0 || y == Y - 1 || z == 0 || z == Z - 1;
  const int64_t total = (int64_t)n * X;
  for (int64_t p = blockIdx.z; p < total; p += gridDim.z) {
    const int64_t b = p / X;
    const int x = (int)(p - b * X);
    const int64_t idx = p * plane + (int64_t)y * Z + z;
    if (ring || x == 0 || x == X - 1) {
      dst[idx] = src[idx];  // shell cells pass through
      continue;
    }
    float s = src[idx - plane];
    s = s + src[idx + plane];
    s = s + src[idx - Z];
    s = s + src[idx + Z];
    s = s + src[idx - 1];
    s = s + src[idx + 1];
    // raw plane x holds interior x-1
    const int x_g = pmod(origins[3 * b] + x - 1, gx);
    const int d2 = yz_d2[(b * (Y - 2) + (y - 1)) * (int64_t)(Z - 2) + (z - 1)];
    dst[idx] = clamp_spheres(s * kSixth, d2, x_g, hot_x, cold_x, in_r2);
  }
}

dim3 level_grid(int Y, int Z, int64_t planes) {
  return dim3((Z + kTileZ - 1) / kTileZ, (Y + kTileY - 1) / kTileY,
              (unsigned)(planes < kMaxGridZ ? planes : kMaxGridZ));
}

}  // namespace

extern "C" {

int stp_jacobi_plane_level(const float* src, float* dst, const int* origins,
                           const int* yz_d2, int n, int X, int Y, int Z, int gx, int hot_x,
                           int cold_x, int in_r2, void* stream) {
  plane_level<<<level_grid(Y, Z, (int64_t)n * X), dim3(kTileZ, kTileY), 0,
                (cudaStream_t)stream>>>(src, dst, origins, yz_d2, n, X, Y, Z, gx, hot_x,
                                        cold_x, in_r2);
  return (int)cudaGetLastError();
}

const char* stp_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
