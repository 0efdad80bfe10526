// Slab-consuming Jacobi level for Hopper (sm_90a), bound to Python through
// ctypes (stencil_tpu_torch/kernels/build.py, stencil_tpu_torch/ops/jacobi_kernels.py).
//
// stp_jacobi_slab_level replaces stencil_tpu/ops/jacobi_pallas.py:1347
//   jacobi_slab_step: one Jacobi level (mean of the six face neighbours plus
//   the hot/cold sphere clamps) over n BARE interiors (n, X, Y, Z), no shell,
//   whose boundary neighbours come from six received face slabs: x (n, Y, Z),
//   y (n, X, Z) and z (n, X, Y).  The TPU kernel streams x-planes through a
//   two-plane VMEM ring and patches the boundary rows and columns with
//   selects; it takes the z slabs transposed (Y, X) only so that lanes run
//   along x.  A GPU has no lane layout, so the z slabs stay (X, Y) and the
//   kernel is the simple one: one thread per cell, z on threadIdx.x (a warp
//   reads 128 contiguous bytes per neighbour), each neighbour read from the
//   block or, at the six boundary faces, from its slab.
//
// Bound on an H100 SXM: bytes.  A level reads each interior cell once and
// writes it once, plus the six slabs and the d2 plane: at 8 x 256^3 f32 that
// is 1.09 GB, 0.32 ms at 3.35 TB/s; the ~7 flops a cell need ~0.01 ms.
// Neighbour re-reads are left to L1/L2, as in stp_jacobi_plane_level.
//
// Bitwise contract: the left fold x-1, x+1, y-1, y+1, z-1, z+1 of the TPU
// kernel (jacobi_pallas.py:1433), the multiply by float32(1/6) that XLA makes
// of `/ 6.0`, no fast-math and --fmad=false, the integer sphere test
// d2 < in_r2 - (x_g - centre_x)^2 with x_g = (origin_x + x) mod gx.
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

// grid: (ceil(Z/32), ceil(Y/8), min(n*X, 65535)); p = block*X + x strides by
// gridDim.z.  origins: (n, 3) int32; yz_d2: (n, Y, Z) int32.
__global__ void slab_level(const float* __restrict__ src, float* __restrict__ dst,
                           const float* __restrict__ xlo, const float* __restrict__ xhi,
                           const float* __restrict__ ylo, const float* __restrict__ yhi,
                           const float* __restrict__ zlo, const float* __restrict__ zhi,
                           const int* __restrict__ origins, const int* __restrict__ yz_d2,
                           int n, int X, int Y, int Z, int gx, int hot_x, int cold_x,
                           int in_r2) {
  const int z = blockIdx.x * kTileZ + threadIdx.x;
  const int y = blockIdx.y * kTileY + threadIdx.y;
  if (z >= Z || y >= Y) return;
  const int64_t plane = (int64_t)Y * Z;
  const int64_t total = (int64_t)n * X;
  for (int64_t p = blockIdx.z; p < total; p += gridDim.z) {
    const int64_t b = p / X;
    const int x = (int)(p - b * X);
    const int64_t idx = p * plane + (int64_t)y * Z + z;
    const int64_t yz = b * plane + (int64_t)y * Z + z;       // x slabs (n, Y, Z)
    const int64_t xz = (b * X + x) * (int64_t)Z + z;          // y slabs (n, X, Z)
    const int64_t xy = (b * X + x) * (int64_t)Y + y;          // z slabs (n, X, Y)
    float s = x == 0 ? xlo[yz] : src[idx - plane];
    s = s + (x == X - 1 ? xhi[yz] : src[idx + plane]);
    s = s + (y == 0 ? ylo[xz] : src[idx - Z]);
    s = s + (y == Y - 1 ? yhi[xz] : src[idx + Z]);
    s = s + (z == 0 ? zlo[xy] : src[idx - 1]);
    s = s + (z == Z - 1 ? zhi[xy] : src[idx + 1]);
    const int x_g = pmod(origins[3 * b] + x, gx);
    float v = s * kSixth;
    const int d2 = yz_d2[yz];
    const int hx = x_g - hot_x;
    if (d2 < in_r2 - hx * hx) v = kHot;
    const int cx = x_g - cold_x;
    if (d2 < in_r2 - cx * cx) v = kCold;
    dst[idx] = v;
  }
}

}  // namespace

extern "C" {

int stp_jacobi_slab_level(const float* src, float* dst, const float* xlo, const float* xhi,
                          const float* ylo, const float* yhi, const float* zlo,
                          const float* zhi, const int* origins, const int* yz_d2, int n,
                          int X, int Y, int Z, int gx, int hot_x, int cold_x, int in_r2,
                          void* stream) {
  const int64_t planes = (int64_t)n * X;
  dim3 grid((Z + kTileZ - 1) / kTileZ, (Y + kTileY - 1) / kTileY,
            (unsigned)(planes < kMaxGridZ ? planes : kMaxGridZ));
  slab_level<<<grid, dim3(kTileZ, kTileY), 0, (cudaStream_t)stream>>>(
      src, dst, xlo, xhi, ylo, yhi, zlo, zhi, origins, yz_d2, n, X, Y, Z, gx, hot_x, cold_x,
      in_r2);
  return (int)cudaGetLastError();
}

const char* stp_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
